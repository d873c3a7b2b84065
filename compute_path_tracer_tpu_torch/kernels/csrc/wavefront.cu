// One bounce of the wavefront renderer over its compacted flat ray buffer,
// one thread per ray.
//
// Replaces benchmarks/frozen_wavefront.py:_bounce_call (the pallas_call at
// frozen_wavefront.py:182, kernel body _make_bounce_kernel at :57): per live
// ray the bounce's faithful AABB guards, the exact 80-step march, the 6-tap
// central-difference normal, the material, shade_bounce and Russian
// roulette.  The renderer around it (compute_path_tracer_tpu_torch/
// benchmarks/frozen_wavefront.py) compacts the surviving rays to the front
// of the buffer between bounces in torch, as the JAX renderer does in XLA.
//
// The alive count k is a device int32 written by that compaction: the grid
// spans the whole buffer and the threads at or past k only write a zero
// `add` and a dead `alive`, so no bounce waits on the host (a grid sized from
// k would cost a synchronisation per bounce).  The JAX kernel skips whole
// (32, 128) blocks past k with pl.when and copies their state through; here
// the state is updated in place, so a ray that is not shaded keeps its state
// with no copy: a miss keeps all of it, a hit that dies keeps its
// throughput (the JAX kernel's where(surv, ..., thr)).
//
// What bounds it on an H100: operations, as for K2 (megakernel_march.cu),
// whose interpreter, march, normal and shading it runs (csg_program.cuh,
// common.cuh): per live ray 96 bytes in and out against up to 86 map taps
// of the faithful program.  What the design changes is only where dead
// rays go: K2 keeps a finished path's thread idle until its block ends,
// the wavefront moves the live rays together at the cost of the
// compaction's traffic between launches.
//
// Semantics are K2's faithful exact march, ray for ray (the winner id is the
// last map tap's, the normal takes 6 taps under the ray's full guards), and
// `add` is 0 + emission x throughput as K2 adds it to its running sum, so the
// renderer's frame equals K2's bit for bit.

#include "csg_program.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
wavefront_bounce(Scene S, const int* __restrict__ k_alive, int n, float* __restrict__ ray,
                 uint32_t* __restrict__ rng_state, float* __restrict__ add,
                 int* __restrict__ alive) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  if (i >= __ldg(k_alive)) {
    add[3 * i] = 0.0f;
    add[3 * i + 1] = 0.0f;
    add[3 * i + 2] = 0.0f;
    alive[i] = 0;
    return;
  }
  float* __restrict__ r = ray + i;
  V3 ro = v3(r[0], r[n], r[2 * n]);
  V3 rd = v3(r[3 * n], r[4 * n], r[5 * n]);
  V3 thr = v3(r[6 * n], r[7 * n], r[8 * n]);
  uint32_t rng = rng_state[i];
  Guards<false> g;
  compute_guards(S, ro, rd, g);
  int idx;
  const float t = march<false, false>(S, g, ro, rd, idx);
  V3 ret = splat(0.0f);
  bool surv = false;
  if (!(t > kFar)) {
    const V3 hit = ro + rd * t;
    const V3 nrm = calc_normal<false, false>(S, g, hit);
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

}  // namespace

// One bounce of the n-ray buffer on `stream`; returns cudaGetLastError() (0
// on success).  `code` and `table` are a faithful program's, as for
// cpt_megakernel_march (no t-cull, no caps).  `k_alive` is one device int32:
// rays [0, k) are live.  `ray` is (9, n) float32, the planes ro.xyz, rd.xyz,
// thr.rgb, and `rng` (n,) uint32, both updated in place; `add` is (n, 3)
// float32 and `alive` (n,) int32, written for every ray.  The caller checks
// the program against kMaxDepth and kMaxBoxed.
extern "C" int cpt_wavefront_bounce(const int* code, int n_ops, const float* table, int n_boxed,
                                    int f_box, int f_mat, const int* k_alive, int n, float* ray,
                                    uint32_t* rng, float* add, int* alive, void* stream) {
  const Scene S{code, n_ops, table, n_boxed, f_box, f_box + 6 * n_boxed, f_mat, nullptr, 0};
  const int grid = (n + kBlock - 1) / kBlock;
  wavefront_bounce<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(S, k_alive, n, ray, rng,
                                                                          add, alive);
  return static_cast<int>(cudaGetLastError());
}
