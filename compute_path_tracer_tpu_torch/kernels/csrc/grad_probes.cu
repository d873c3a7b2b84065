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
// with idx == -1 dropping out.  What bounds the function on an H100:
// bytes, (4 + 4 C) an element read once (app/profiling.py:segsum_bytes);
// the one-hot product's flops are this design's, not the function's.  The
// design keeps the sum off atomics and takes the JAX kernel's one-hot
// product on the tensor cores:
// * A grid of at most two blocks an SM (one at C > 16), no more than the
//   tiles, times one pass per 64 segments and 16 or 32 channels (a pass
//   re-reads the ids, and the cotangents once per 64 segments).  A block
//   takes the tiles blockIdx.x, + gridDim.x, ... of 512 lanes of a plane
//   (256 where 512 would leave a block without one), staging each tile's
//   ids and channel rows in a ring of 3 shared-memory stages by cp.async
//   (16 bytes a copy, 4 where n % 4 or the pointers forbid it), neighbouring
//   threads on neighbouring addresses; lanes past the plane's end are
//   zero-filled (id 0, cotangent 0: they add an exact zero).
// * Each warp takes an eighth of a tile, 16 lanes a pair step, as two
//   m16n8k8 products a 16-channel tile and 8 segments (mma.sync, TF32 in,
//   float32 out): A is the cotangents (a channel a row), B the one-hot of 8
//   lanes' ids against 8 segments, built in registers by compares, eight B
//   a 64-segment group.  A lane of a quad reads 4 consecutive lanes of a
//   channel row in one 16-byte load (rows T + 16 floats apart, so a quarter
//   warp meets the 32 banks once): lanes 4 t + 2 q and + 1 of the pair step
//   are columns t and t + 4 of chunk q.
// * A one-hot operand is exact in TF32.  Each cotangent x is split into
//   hi = x rounded to TF32 (cvt.rna.tf32.f32's rounding, by integer ops, so
//   kernels/grad_probes.py:tf32_split is it bit for bit) and lo = x - hi
//   rounded again, and both products go into the same accumulators: hi + lo
//   is within 2^-23 |x|, where one TF32 term errs up to 2^-11.  A tile's
//   products start from zero and are added to float32 sums in registers
//   after each tile, rounded to nearest, because the tensor cores' own
//   accumulation truncates: kept across all of a warp's tiles at K4's
//   shape, it left 12x the error.  So the products are what sets the pace
//   on an H100, not the bytes: 16 HMMA.1688 a warp and 8 lanes at C <= 16,
//   near the time of the stream on their own.  wgmma (HGMMA), at about
//   twice mma.sync's TF32 rate, is not tried here.
// * A dropped lane's finite cotangent meets a zero row of the one-hot.  A
//   cotangent that is not finite, or whose TF32 rounding would overflow
//   (|x| >= (2 - 2^-11) 2^127, where hi + lo can reach 2^128), sends its
//   warp (a vote) down a scalar path: the value is zero in the products and,
//   where its lane is kept, added alone to its own (segment, channel) entry
//   of the block's scalar sums by a shared-memory atomic (a CAS loop on
//   sm_90a), so it touches only its own entries, as index_add_ does, and a
//   NaN of a dropped lane reaches nothing.  The only float atomics are
//   these.
// * The reduce is in a fixed order: the warps' sums are added in shared
//   memory in warp order, then the block's scalar sums; each block writes
//   its partial to scratch, and a second small kernel (segsum_reduce) sums
//   the partials in block order (warp w of a reduce block adds blocks w,
//   w + 8, ..., then the 8 warps in order) and writes every entry of out.
//   So the sum is the same bit for bit from launch to launch on a card.  A
//   call is the two kernels, the second a programmatic dependent launch
//   (it starts as the first ends, and waits for it with griddepcontrol);
//   the wrapper counts the call as one launch.

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
constexpr int kSegWarps = kSegBlock / 32;
// A tile is 1 << TS lanes (TS = 8 or 9), a staged channel row 16 floats
// longer: a quarter warp's 16-byte loads of 8 rows then meet 32 banks.
__host__ __device__ constexpr int seg_pitch(int tile) { return tile + 16; }
constexpr int kSegStages = 3;
constexpr int kSegGroup = 64;              // segments of a pass
// The smallest |x| whose rounding to TF32 overflows: (2 - 2^-11) 2^127.
constexpr uint32_t kTf32Over = 0x7f7ff000u;

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32),
// by half the 13 dropped bits added to the pattern and a mask.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int bytes, int size) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (size == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(__cvta_generic_to_global(src)), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(__cvta_generic_to_global(src)), "r"(bytes)
                 : "memory");
  }
}

// D = A B + C (C = D, or zero with kZero): mma.sync m16n8k8, TF32 in, float32
// accumulators.  A: a0 (row g, column t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4); B: b0 (row t, column g), b1 (t + 4, g); D: d0, d1 (row g,
// columns 2 t, 2 t + 1), d2, d3 (row g + 8), for lane 4 g + t.
template <bool kZero>
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  if (kZero) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.0f));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

// Stages tile `tile` (plane b, lanes i0 ...): its ids, then `rows` channel
// rows from channel c0, each seg_pitch(1 << TS) floats apart; vec floats a copy.
template <int TS>
__device__ __forceinline__ void seg_stage(const int* __restrict__ idx,
                                          const float* __restrict__ cot, int n, int n_ch, int c0,
                                          int rows, int tpp, int tile, int vec, float* stage) {
  const int b = tile / tpp, i0 = (tile - b * tpp) << TS;
  const int valid = min(1 << TS, n - i0);
  const int shift = vec == 4 ? TS - 2 : TS;  // log2 of the copies a row
  for (int u = threadIdx.x; u < (rows + 1) << shift; u += kSegBlock) {
    const int r = u >> shift, col = (u & ((1 << shift) - 1)) * vec;
    const int bytes = 4 * max(0, min(vec, valid - col));
    const int at = bytes ? col : 0;  // a copy of nothing still names an address
    const void* src = r == 0 ? static_cast<const void*>(idx + (long long)b * n + i0 + at)
                             : static_cast<const void*>(
                                   cot + ((long long)b * n_ch + c0 + r - 1) * n + i0 + at);
    float* dst = r == 0 ? stage + col : stage + (1 << TS) + (r - 1) * seg_pitch(1 << TS) + col;
    cp_async_zfill(dst, src, bytes, 4 * vec);
  }
}

// The scalar path of a pair step whose warp holds a cotangent whose TF32
// rounding would overflow (|x| >= kTf32Over), or an infinite or NaN one:
// each such value of a kept lane of this pass's segments is added alone to
// its entry of the block's scalar sums, and every such value is zero in the
// products.
template <int MT>
__device__ __forceinline__ void seg_scalar(float (&x)[MT][2][4], uint32_t (&hi)[MT][2][4],
                                           const int (&ids)[4], int s0, int g, float* sc) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = x[m][h][q];
        if (fabsf(v) < __uint_as_float(kTf32Over)) continue;
        const int s = ids[q] - s0;
        if (s >= 0 && s < kSegGroup) atomicAdd(sc + s * 16 * MT + 16 * m + g + 8 * h, v);
        x[m][h][q] = 0.0f;
        hi[m][h][q] = 0u;
      }
}

// One pair step of a warp: lanes L0 ... L0 + 15 of the staged tile, two
// chunks of 8, into acc (kFirst: the tile's first step, from zero).
template <int MT, int TS, bool kFirst>
__device__ __forceinline__ void seg_pair(const int* __restrict__ s_ids,
                                         const float* __restrict__ s_cot, int L0, int rows,
                                         int s0, int g, int t, float (&acc)[MT][8][4],
                                         float* sc) {
  const int4 id4 = *reinterpret_cast<const int4*>(s_ids + L0 + 4 * t);
  const int ids[4] = {id4.x, id4.y, id4.z, id4.w};
  float x[MT][2][4];
  uint32_t hi[MT][2][4], lo[MT][2][4];
  bool bad = false;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + g + 8 * h;
      const float* row = s_cot + r * seg_pitch(1 << TS) + L0 + 4 * t;
      const float4 v = r < rows ? *reinterpret_cast<const float4*>(row)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      x[m][h][0] = v.x;
      x[m][h][1] = v.y;
      x[m][h][2] = v.z;
      x[m][h][3] = v.w;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hi[m][h][q] = tf32_bits(x[m][h][q]);
        bad |= !(fabsf(x[m][h][q]) < __uint_as_float(kTf32Over));
      }
    }
  // A dropped lane's finite cotangent meets a zero row of the one-hot.
  if (__any_sync(kFullWarp, bad)) seg_scalar<MT>(x, hi, ids, s0, g, sc);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        lo[m][h][q] = tf32_bits(x[m][h][q] - __uint_as_float(hi[m][h][q]));
  const uint32_t one = __float_as_uint(1.0f);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d0 = ids[2 * c] - s0 - g, d1 = ids[2 * c + 1] - s0 - g;
    uint32_t b0[8], b1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      b0[j] = d0 == 8 * j ? one : 0u;
      b1[j] = d1 == 8 * j ? one : 0u;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (kFirst && c == 0) {
          mma_tf32<true>(acc[m][j], hi[m][0][0], hi[m][1][0], hi[m][0][1], hi[m][1][1], b0[j],
                         b1[j]);
        } else {
          mma_tf32<false>(acc[m][j], hi[m][0][2 * c], hi[m][1][2 * c], hi[m][0][2 * c + 1],
                          hi[m][1][2 * c + 1], b0[j], b1[j]);
        }
      }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_tf32<false>(acc[m][j], lo[m][0][2 * c], lo[m][1][2 * c], lo[m][0][2 * c + 1],
                        lo[m][1][2 * c + 1], b0[j], b1[j]);
  }
}

// Dynamic shared memory: 4 (max(3 (T + rows (T + 16)), 8 64 (16 MT + 4)) +
// 64 16 MT) bytes, T = 1 << TS, rows = min(16 MT, n_ch)
// (kernels/grad_probes.py:segsum_smem_bytes).  part: passes x gridDim.x x 64
// x 16 MT floats.
template <int MT, int TS>
__global__ void __launch_bounds__(kSegBlock, (3 - MT) * 256 / kSegBlock)
segsum(const int* __restrict__ idx, const float* __restrict__ cot, int n, int n_ch, int tpp,
       int n_tiles, int ch_groups, int vec, float* __restrict__ part) {
  constexpr int CP = 16 * MT;
  extern __shared__ __align__(16) float seg_smem[];
  const int pass = blockIdx.y;
  const int s0 = (pass / ch_groups) * kSegGroup, c0 = (pass % ch_groups) * CP;
  const int rows = min(CP, n_ch - c0);
  const int stage_floats = (1 << TS) + min(CP, n_ch) * seg_pitch(1 << TS);
  float* sc = seg_smem + max(kSegStages * stage_floats, kSegWarps * kSegGroup * (CP + 4));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int j = threadIdx.x; j < kSegGroup * CP; j += kSegBlock) sc[j] = 0.0f;
  const int bx = blockIdx.x, nbx = gridDim.x;
  const int mine = bx < n_tiles ? (n_tiles - 1 - bx) / nbx + 1 : 0;
#pragma unroll
  for (int k = 0; k < kSegStages - 1; ++k) {
    if (k < mine) {
      seg_stage<TS>(idx, cot, n, n_ch, c0, rows, tpp, bx + k * nbx, vec,
                seg_smem + k * stage_floats);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  float sum[MT][8][4], acc[MT][8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[m][j][i] = 0.0f;
  for (int k = 0; k < mine; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kSegStages - 2) : "memory");
    __syncthreads();
    const int next = k + kSegStages - 1;
    if (next < mine) {
      seg_stage<TS>(idx, cot, n, n_ch, c0, rows, tpp, bx + next * nbx, vec,
                seg_smem + (next % kSegStages) * stage_floats);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* stage = seg_smem + (k % kSegStages) * stage_floats;
    const int* s_ids = reinterpret_cast<const int*>(stage);
    constexpr int kWarpLanes = (1 << TS) / kSegWarps;
    const int L0 = kWarpLanes * warp;  // a warp's share of the tile
    seg_pair<MT, TS, true>(s_ids, stage + (1 << TS), L0, rows, s0, g, t, acc, sc);
#pragma unroll
    for (int p = 1; p < kWarpLanes / 16; ++p)
      seg_pair<MT, TS, false>(s_ids, stage + (1 << TS), L0 + 16 * p, rows, s0, g, t, acc, sc);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[m][j][i] += acc[m][j][i];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // The warps' sums, [warp][segment][channel] with rows CP + 4 apart.
  float* ws = seg_smem;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 8 * j + 2 * t + (i & 1), ch = 16 * m + g + 8 * (i >> 1);
        ws[(warp * kSegGroup + s) * (CP + 4) + ch] = sum[m][j][i];
      }
  __syncthreads();
  float* out = part + ((long long)pass * nbx + bx) * (kSegGroup * CP);
  for (int e = threadIdx.x; e < kSegGroup * CP; e += kSegBlock) {
    const int s = e / CP, ch = e - s * CP;
    float v = ws[s * (CP + 4) + ch];
#pragma unroll
    for (int w = 1; w < kSegWarps; ++w) v += ws[(w * kSegGroup + s) * (CP + 4) + ch];
    out[e] = v + sc[e];
  }
}

// out[s, c] from the blocks' partials (part: passes x blocks x 64 cp): block
// (blockIdx.x, pass blockIdx.y) takes 32 entries of a pass; its warp w adds
// blocks w, w + 8, ... in order, then warp 0 adds the 8 warps' sums in order.
// Launched as segsum's programmatic dependent, it first waits for segsum.
__global__ void __launch_bounds__(kSegBlock)
segsum_reduce(const float* __restrict__ part, int blocks, int cp, int ch_groups, int n_seg,
              int n_ch, float* __restrict__ out) {
  __shared__ float ws[kSegWarps][32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the sum's grid has ended
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, pass = blockIdx.y;
  const int per = kSegGroup * cp, e = 32 * blockIdx.x + lane;
  const float* __restrict__ p = part + (long long)pass * blocks * per + e;
  float v = 0.0f;
#pragma unroll 4
  for (int b = warp; b < blocks; b += kSegWarps) v += p[(long long)b * per];
  ws[warp][lane] = v;
  __syncthreads();
  if (warp == 0) {
    float sum = ws[0][lane];
#pragma unroll
    for (int w = 1; w < kSegWarps; ++w) sum += ws[w][lane];
    const int s = (pass / ch_groups) * kSegGroup + e / cp;
    const int c = (pass % ch_groups) * cp + e % cp;
    if (s < n_seg && c < n_ch) out[(long long)s * n_ch + c] = sum;
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
// float32 into out (n_seg, n_ch) float32, every entry written, on `stream`;
// returns cudaGetLastError() (0 on success).  tile (256 or 512 lanes) and
// blocks (a pass's) as kernels/grad_probes.py:segsum_plan gives them; part:
// scratch of passes x blocks x 64 x 16 MT floats, MT = 1 for n_ch <= 16,
// else 2; vec: 4 when n % 4 == 0 and idx and cot are 16-byte aligned, else
// 1.
extern "C" int cpt_segsum(const int* idx, const float* cot, int n_b, int n, int n_seg, int n_ch,
                          float* part, float* out, int tile, int blocks, int vec, void* stream) {
  if (n_b < 1 || n < 1 || n_seg < 1 || n_ch < 1 || blocks < 1 || (vec != 4 && vec != 1) ||
      (tile != 256 && tile != 512) ||
      (vec == 4 && (n % 4 || reinterpret_cast<uintptr_t>(idx) % 16 ||
                    reinterpret_cast<uintptr_t>(cot) % 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mt = n_ch <= 16 ? 1 : 2, cp = 16 * mt;
  const int ch_groups = (n_ch + cp - 1) / cp, seg_groups = (n_seg + kSegGroup - 1) / kSegGroup;
  const int tpp = (n + tile - 1) / tile, n_tiles = n_b * tpp;
  const int stage_floats = tile + min(cp, n_ch) * seg_pitch(tile);
  const int smem = 4 * (max(kSegStages * stage_floats, kSegWarps * kSegGroup * (cp + 4)) +
                        kSegGroup * cp);
  auto kernel = tile == 256 ? (mt == 1 ? segsum<1, 8> : segsum<2, 8>)
                            : (mt == 1 ? segsum<1, 9> : segsum<2, 9>);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(blocks, seg_groups * ch_groups), kSegBlock, smem, s>>>(
      idx, cot, n, n_ch, tpp, n_tiles, ch_groups, vec, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // The reduce may be launched before the sum ends (programmatic dependent
  // launch); it waits for the sum's grid before it reads the partials.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSegGroup * cp / 32, seg_groups * ch_groups);
  cfg.blockDim = dim3(kSegBlock);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, segsum_reduce, static_cast<const float*>(part),
                                             blocks, cp, ch_groups, n_seg, n_ch, out));
}
