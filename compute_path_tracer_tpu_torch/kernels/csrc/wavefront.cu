// One bounce of the wavefront renderer over its compacted flat ray buffer,
// one lane per ray.
//
// Replaces benchmarks/frozen_wavefront.py:_bounce_call (the pallas_call at
// frozen_wavefront.py:182, kernel body _make_bounce_kernel at :57): per live
// ray the bounce's faithful AABB guards, the exact 80-step march, the 6-tap
// central-difference normal, the material, shade_bounce and Russian
// roulette.  The renderer around it (compute_path_tracer_tpu_torch/
// benchmarks/frozen_wavefront.py) compacts the surviving rays to the front
// of the buffer between bounces in torch, as the JAX renderer does in XLA.
//
// What bounds it on an H100: operations, as for K2 (megakernel_march.cu),
// whose interpreter, march, normal and shading it runs (csg_program.cuh,
// common.cuh): per live ray 96 bytes in and out against up to 86 map taps
// of the faithful program.  A walk that loaded and tested all 66 op records
// of the benchmark scene at every tap, though a warp's rays hit few of its
// 61 boxes, took most of the time, as it did in K2 and K3; so the bounce
// takes K2's per-warp walk.  Each block stages the decoded records and the
// leaf table in shared memory once (csg_program.cuh:stage_walk); each warp
// takes 32 consecutive live rays, builds after their guards the list of the
// records they can need (build_warp_list), and the march and the normal
// walk that list (march_walk, normal_walk), exactly as megakernel_walk's
// faithful exact march does per bounce.  Compacted survivors lie close in
// the image but point anywhere, so a warp's list may be longer than K2's;
// walk_stats counts it.
//
// Blocks are persistent: the grid is the blocks that fit on the SMs (fewer
// for a small buffer), so the program is staged once a block and not once
// per 128 rays.  Each warp takes 32-ray chunks of the live rays [0, k): its
// first by its place in the grid, the rest from a device counter that the
// entry point zeroes on the stream.  A late bounce has fewer chunks than the
// grid has warps; taken from the counter, they went to whichever warps
// reached it first and piled up on some SMs (on an H100, bounce 3 of the
// 1080p frame, 1,540 chunks for 4,752 warps, took 1.27 ms against 0.90 with
// a block per 4 chunks); in grid order they spread over the SMs as the
// blocks do.  The alive count k is a device int32 written by the
// compaction, read here, so no bounce waits on the host; the rays [k, n)
// get a zero `add` and a dead `alive` through a grid-stride loop of the same
// blocks.  The JAX kernel
// skips whole (32, 128) blocks past k with pl.when and copies their state
// through; here the state is updated in place, so a ray that is not shaded
// keeps its state with no copy: a miss keeps all of it, a hit that dies
// keeps its throughput (the JAX kernel's where(surv, ..., thr)).
//
// Semantics are K2's faithful exact march, ray for ray (the winner id is the
// last map tap's, the normal takes 6 taps under the ray's full guards), and
// `add` is 0 + emission x throughput as K2 adds it to its running sum, so the
// renderer's frame equals K2's bit for bit.  A list holds every record a
// live lane's guards pass, so each lane's map over it is map_ops' over the
// whole program (csg_program.cuh, the note above map_walk), whatever rays
// the warp holds.

#include "csg_program.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;

// Dynamic shared memory: walk_smem_bytes(n_ops, f_box, kWarps).  Warp w of
// block b takes chunk 4 b + w first, then grid_warps + the counter's next
// value, while that is a chunk.  Every lane of a warp runs the chunk loop to
// its end (the list is a warp collective): a lane past k takes part as not
// live.  A non-null walk_stats (2 zeroed uint64) takes the summed list
// length and the number of lists.
__global__ void __launch_bounds__(kBlock)
wavefront_bounce(Scene S, const int* __restrict__ k_alive, int n, float* __restrict__ ray,
                 uint32_t* __restrict__ rng_state, float* __restrict__ add,
                 int* __restrict__ alive, int* __restrict__ chunk_next,
                 unsigned long long* __restrict__ walk_stats) {
  extern __shared__ int4 walk_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = min(max(__ldg(k_alive), 0), n);
  for (int i = k + blockIdx.x * kBlock + threadIdx.x; i < n; i += gridDim.x * kBlock) {
    add[3 * i] = 0.0f;
    add[3 * i + 1] = 0.0f;
    add[3 * i + 2] = 0.0f;
    alive[i] = 0;
  }
  const Walk P = stage_walk(S, S.f_box, kWarps, walk_smem, threadIdx.x, kBlock);
  const int4* __restrict__ list = P.lists + warp * P.n_ops;
  const int chunks = (k + 31) >> 5;
  const int grid_warps = gridDim.x * kWarps;
  for (int c = blockIdx.x * kWarps + warp; c < chunks;) {
    const int i = 32 * c + lane;
    const bool live = i < k;
    float* __restrict__ r = ray + i;
    V3 ro = splat(0.0f), rd = splat(0.0f), thr = splat(0.0f);
    uint32_t rng = 0u;
    Guards<false> g;
    if (live) {
      ro = v3(r[0], r[n], r[2 * n]);
      rd = v3(r[3 * n], r[4 * n], r[5 * n]);
      thr = v3(r[6 * n], r[7 * n], r[8 * n]);
      rng = rng_state[i];
      compute_guards(S, ro, rd, g);
    }
    const int len = build_warp_list(P, S.n_boxed, g, live, warp, lane);
    record_list(walk_stats, 0, len, lane);
    if (live) {
      int idx;
      const float t = march_walk<false, false>(S, list, len, P.F, g, ro, rd, idx);
      V3 ret = splat(0.0f);
      bool surv = false;
      if (!(t > kFar)) {
        const V3 hit = ro + rd * t;
        const V3 nrm = normal_walk<false, false>(list, len, P.F, g, hit);
        const float* mt = idx >= 0 ? S.F + S.f_mat + kMatSize * idx : nullptr;
        surv = scatter(rng, ro, rd, ret, thr, hit, nrm, mt);
        r[0] = ro.x;
        r[n] = ro.y;
        r[2 * n] = ro.z;
        r[3 * n] = rd.x;
        r[4 * n] = rd.y;
        r[5 * n] = rd.z;
        r[6 * n] = thr.x;
        r[7 * n] = thr.y;
        r[8 * n] = thr.z;
        rng_state[i] = rng;
      }
      add[3 * i] = ret.x;
      add[3 * i + 1] = ret.y;
      add[3 * i + 2] = ret.z;
      alive[i] = surv ? 1 : 0;
    }
    if (lane == 0) c = grid_warps + atomicAdd(chunk_next, 1);
    c = __shfl_sync(kFullWarp, c, 0);
  }
}

}  // namespace

// One bounce of the n-ray buffer on `stream`; returns the first CUDA error
// (0 on success).  `code` and `table` are a faithful program's, as for
// cpt_megakernel_march (no t-cull, no caps).  `k_alive` is one device int32:
// rays [0, k) are live.  `ray` is (9, n) float32, the planes ro.xyz, rd.xyz,
// thr.rgb, and `rng` (n,) uint32, both updated in place; `add` is (n, 3)
// float32 and `alive` (n,) int32, written for every ray.  `chunk_next` is
// one int32 of device scratch, zeroed here on the stream; a non-null
// walk_stats (2 zeroed uint64) takes the launch's summed list length and
// list count.  smem_bytes, the block's dynamic shared memory, must be
// walk_smem_bytes(n_ops, f_box, 4) (render/program.py:walk_smem_bytes).  The
// grid is the blocks that fit on the device's SMs at that size (asked of the
// runtime at each launch, a few microseconds on the host), at most one a 128
// rays.  The caller checks the program against kMaxDepth and kMaxBoxed.
extern "C" int cpt_wavefront_bounce(const int* code, int n_ops, const float* table, int n_boxed,
                                    int f_box, int f_mat, const int* k_alive, int n, float* ray,
                                    uint32_t* rng, float* add, int* alive, int* chunk_next,
                                    unsigned long long* walk_stats, int smem_bytes,
                                    void* stream) {
  if (smem_bytes != walk_smem_bytes(n_ops, f_box, kWarps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scene S{code, n_ops, table, n_boxed, f_box, f_box + 6 * n_boxed, f_mat, nullptr, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(wavefront_bounce, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wavefront_bounce, kBlock,
                                                        smem_bytes);
  }
  if (err == cudaSuccess) err = cudaMemsetAsync(chunk_next, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int need = (n + kBlock - 1) / kBlock;
  const int blocks = need < per_sm * sms ? need : per_sm * sms;
  wavefront_bounce<<<blocks, kBlock, smem_bytes, st>>>(S, k_alive, n, ray, rng, add, alive,
                                                       chunk_next, walk_stats);
  return static_cast<int>(cudaGetLastError());
}
