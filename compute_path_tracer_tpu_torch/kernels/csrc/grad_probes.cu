// The gradient probes of the JAX package's benchmarks/ on the card: one
// fused forward-plus-adjoint bounce (fused_bwd) and the segment sum of the
// fused step's material cotangents (segsum).
//
// fused_bwd replaces benchmarks/probe_fused_bwd.py:run (the pallas_call at
// probe_fused_bwd.py:87, kernel body `kernel` at :51), which asked whether
// Mosaic lowers jax.vjp over one bounce inside a kernel.  Per pixel of a
// rectangle of the 1920x1080 camera at frame 1: the jittered primary ray,
// the baked guards, K3's exact march over the baked program, the 6-tap
// normal, the material and shade_bounce (common.cuh), then the loss term
// emit + thr_factor / ray_prob where the ray hits.  Each block sums its
// pixels' terms in double and adds the sum to the loss with one atomic.
// The probe's loss reads the hit mask and the winner's material, and
// nothing else: emit, thr_factor and ray_prob are functions of the material
// table, not of the baked vector bv, and the normal feeds only the next ray,
// which the loss drops.  So the loss's gradient in bv is identically zero
// (the JAX probe prints grad_nonzero=0), and the kernel writes that zero
// and spends no arithmetic on a product it knows is zero; the plain version
// (kernels/grad_probes.py) computes it with autograd.  The next ray is
// computed all the same, as the probe's forward computes it, and an empty
// asm keeps the compiler from dropping it and the normal with it.
// What bounds it on an H100: operations, those of K3's exact march and the
// normal's taps; it writes only the loss and the zero gradient.  So it takes
// K3's per-warp walk (march_rays.cu, csg_program.cuh): the block stages the
// decoded program and its leaf table in shared memory, each warp of 32
// consecutive pixels of a rectangle row compacts once, after its lanes'
// guards, the records they can need into its own list, and the march and
// the normal walk that list (walk_stats, when given, counts it).  A lane
// past the rectangle takes part in the list as not live and marches
// nothing.  t, the winner id, the normal and each pixel's term are the full
// walk's bit for bit.
//
// segsum replaces benchmarks/probe_inkernel_segsum.py:main (the pallas_call
// at probe_inkernel_segsum.py:55, kernel body `kernel` at :33), which asked
// whether Mosaic lowers an in-kernel one-hot matmul accumulated into one
// revisited (S, C) block over a sequential grid:
//   out[s, c] = sum over b, i with idx[b, i] == s of cot[b, c, i],
// with idx == -1 dropping out.  Blocks run in no order here, so each block
// walks its share of the (b, i) elements, adds each element's C channels to
// its own S x C partial in shared memory with shared-memory atomics (a
// warp whose lanes share one segment adds the warp's sum once), and then
// adds the partial to the output with one global atomic per entry.  Floats
// added by atomics in no fixed order: the sum agrees with a float64 sum to
// rounding, not bit for bit.  What bounds it on an H100: bytes, (4 + 4 C) a
// element read once.

#include "csg_program.cuh"

namespace {

// -- fused_bwd ------------------------------------------------------------------

constexpr int kFbBlock = 256;
constexpr int kFbWarps = kFbBlock / 32;

// Dynamic shared memory: walk_smem_bytes(n_ops, f_box, kFbWarps).
__global__ void __launch_bounds__(kFbBlock)
fused_bwd(Scene S, int x0, int y0, int rw, int rh, int width, int height, int frame, float fov,
          float aspect, double* __restrict__ loss, float* __restrict__ grad, int n_grad,
          unsigned long long* __restrict__ walk_stats) {
  extern __shared__ int4 walk_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Walk P = stage_walk(S, S.f_box, kFbWarps, walk_smem, threadIdx.x, kFbBlock);
  const int i = blockIdx.x * kFbBlock + threadIdx.x;
  // The gradient in bv: zero, see the note at the head.
  for (int j = i; j < n_grad; j += gridDim.x * kFbBlock) grad[j] = 0.0f;
  const bool live = i < rw * rh;
  uint32_t rng = 0;
  V3 ro = splat(0.0f), rd = splat(0.0f);
  if (live) primary_ray(x0 + i % rw, y0 + i / rw, frame, width, height, fov, aspect, rng, ro, rd);
  Guards<false> g;
  if (live) compute_guards(S, ro, rd, g);
  const int len = build_warp_list(P, S.n_boxed, g, live, warp, lane);
  if (i - lane < rw * rh) record_list(walk_stats, 0, len, lane);
  double term = 0.0;
  if (live) {
    const int4* __restrict__ list = P.lists + warp * P.n_ops;
    int idx;
    const float t = march_walk<true, false>(S, list, len, P.F, g, ro, rd, idx);
    if (!(t > kFar)) {
      const V3 hit = ro + rd * t;
      const V3 nrm = normal_walk<true, false>(list, len, P.F, g, hit);
      const float* mt = idx >= 0 ? S.F + S.f_mat + kMatSize * idx : nullptr;
      const Shade s = shade_bounce(rng, rd, hit, nrm, mt);
      asm volatile("" ::"f"(s.ro.x), "f"(s.ro.y), "f"(s.ro.z), "f"(s.rd.x), "f"(s.rd.y),
                   "f"(s.rd.z));
      const V3 col = s.emit + s.thr_factor / s.ray_prob;
      term = (double)((col.x + col.y) + col.z);
    }
  }
  __shared__ double part[kFbWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) term += __shfl_down_sync(kFullWarp, term, o);
  if (lane == 0) part[warp] = term;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = 0.0;
    for (int w = 0; w < kFbWarps; ++w) sum += part[w];
    atomicAdd(loss, sum);
  }
}

// -- segsum ---------------------------------------------------------------------

constexpr int kSegBlock = 256;

__global__ void __launch_bounds__(kSegBlock)
segsum(const int* __restrict__ idx, const float* __restrict__ cot, int n_b, int n, int n_seg,
       int n_ch, float* __restrict__ out) {
  extern __shared__ float acc[];
  const int sc = n_seg * n_ch;
  for (int j = threadIdx.x; j < sc; j += kSegBlock) acc[j] = 0.0f;
  __syncthreads();
  const long long total = (long long)n_b * n;
  const long long stride = (long long)gridDim.x * kSegBlock;
  // Every lane of a warp runs the same trips, so the shuffles see all 32.
  const long long trips = (total + stride - 1) / stride;
  long long e = (long long)blockIdx.x * kSegBlock + threadIdx.x;
  for (long long trip = 0; trip < trips; ++trip, e += stride) {
    const bool in = e < total;
    const int b = in ? (int)(e / n) : 0;
    const int i = in ? (int)(e - (long long)b * n) : 0;
    const int s = in ? __ldg(idx + e) : -1;
    const float* __restrict__ c = cot + ((long long)b * n_ch) * n + i;
    const int s0 = __shfl_sync(kFullWarp, s, 0);
    if (__all_sync(kFullWarp, s == s0)) {
      if (s0 < 0) continue;
      for (int ch = 0; ch < n_ch; ++ch) {
        float v = __ldg(c + (long long)ch * n);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullWarp, v, o);
        if ((threadIdx.x & 31) == 0) atomicAdd(acc + s0 * n_ch + ch, v);
      }
    } else if (s >= 0) {
      for (int ch = 0; ch < n_ch; ++ch) {
        atomicAdd(acc + s * n_ch + ch, __ldg(c + (long long)ch * n));
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < sc; j += kSegBlock) {
    if (acc[j] != 0.0f) atomicAdd(out + j, acc[j]);
  }
}

}  // namespace

// fused_bwd over the rw x rh pixels from (x0, y0) of the width x height
// camera on `stream`; returns cudaGetLastError() (0 on success).  `code`
// and `table` are a baked program's (program_table without t-cull), as
// for cpt_march_rays, with its materials at f_mat.  `loss` is one float64,
// zeroed by the caller, to which every block adds; `grad` (n_grad float32)
// is overwritten with zeros.  A non-null walk_stats (2 zeroed uint64) takes
// the summed length of the warps' lists and their number.  smem_bytes, the
// block's dynamic shared memory, must be walk_smem_bytes(n_ops, f_box, 8)
// (render/program.py:walk_smem_bytes).  The caller checks the program
// against kMaxDepth and kMaxBoxed.
extern "C" int cpt_fused_bwd(const int* code, int n_ops, const float* table, int n_boxed,
                             int f_box, int f_mat, int x0, int y0, int rw, int rh, int width,
                             int height, int frame, float fov, float aspect, double* loss,
                             float* grad, int n_grad, unsigned long long* walk_stats,
                             int smem_bytes, void* stream) {
  const Scene S{code, n_ops, table, n_boxed, f_box, f_box + 6 * n_boxed, f_mat, nullptr, 0};
  if (smem_bytes != walk_smem_bytes(n_ops, f_box, kFbWarps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (rw * rh + kFbBlock - 1) / kFbBlock;
  fused_bwd<<<grid, kFbBlock, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      S, x0, y0, rw, rh, width, height, frame, fov, aspect, loss, grad, n_grad, walk_stats);
  return static_cast<int>(cudaGetLastError());
}

// segsum of idx (n_b, n) int32 in [-1, n_seg) and cot (n_b, n_ch, n)
// float32 into out (n_seg, n_ch) float32, zeroed by the caller, on `stream`
// with `blocks` blocks; returns cudaGetLastError() (0 on success).  The
// block's partial takes n_seg * n_ch * 4 bytes of shared memory.
extern "C" int cpt_segsum(const int* idx, const float* cot, int n_b, int n, int n_seg, int n_ch,
                          float* out, int blocks, void* stream) {
  const size_t smem = sizeof(float) * (size_t)n_seg * n_ch;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(segsum, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segsum<<<blocks, kSegBlock, smem, static_cast<cudaStream_t>(stream)>>>(idx, cot, n_b, n, n_seg,
                                                                        n_ch, out);
  return static_cast<int>(cudaGetLastError());
}
