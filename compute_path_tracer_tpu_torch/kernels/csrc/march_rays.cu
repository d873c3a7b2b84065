// Sphere march of arbitrary rays through any CSG scene, one thread per ray,
// for the differentiable renderer's bounce loop.
//
// Replaces compute_path_tracer_tpu/kernels/march.py:_march_planes (the
// pallas_call at march.py:123, kernel body _make_march_kernel at :48): per
// ray the bounce's AABB guards, the exact 80-step march (cast_ray) or the
// t-interval-culled one, the winner id, and on request the 6-tap
// central-difference normal at the hit.  The JAX kernel takes (H, W) ray
// planes cut into (64, 128) tiles and pads them with far-miss rays; here the
// input is the flat (n,) vector of the rays still alive that the port's
// compacting path_trace hands to its cast each bounce, so there is no tile
// and no padding.  The implicit-gradient backward stays in torch
// (kernels/march.py), as the JAX backward stays in XLA.
//
// What bounds it on an H100: operations.  A ray moves about 44 bytes (24 in,
// 8 out, 12 more with the normal) against hundreds of flops per map tap (a
// guard test per guarded shape and a leaf SDF for each box the ray hits),
// up to 80 taps, plus 6 for the normal; memory bandwidth is idle.  The
// interpreter is K2's (csg_program.cuh), with the same per-thread state and
// uniform table loads.  This first version is simple and right, not fast:
// no shared-memory staging, no warp-level guard skipping.
//
// Semantics are K2's (see the note at the head of megakernel_march.cu):
// * the winner id is carried through the march (the id of the last map tap,
//   -1 when far), where the JAX kernel re-taps the map at the final t
//   (_final_idx);
// * t_cull is per thread, on the min-folded leaves only, with the interval
//   through each leaf's bounding sphere, where the JAX kernel culls per
//   tile on the reference boxes;
// * the normal takes 6 map taps under the ray's full guards; a ray that
//   misses (t > FP) gets the zero vector, which no caller reads.

#include "csg_program.cuh"

namespace {

constexpr int kBlock = 128;

template <bool BAKED, bool TCULL, bool NORMAL>
__global__ void __launch_bounds__(kBlock)
march_rays(Scene S, int n, const float* __restrict__ rox, const float* __restrict__ roy,
           const float* __restrict__ roz, const float* __restrict__ rdx,
           const float* __restrict__ rdy, const float* __restrict__ rdz,
           float* __restrict__ t_out, int* __restrict__ idx_out, float* __restrict__ nx,
           float* __restrict__ ny, float* __restrict__ nz) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const V3 ro = v3(rox[i], roy[i], roz[i]);
  const V3 rd = v3(rdx[i], rdy[i], rdz[i]);
  Guards<TCULL> g;
  compute_guards(S, ro, rd, g);
  int idx;
  const float t = march<BAKED, TCULL>(S, g, ro, rd, idx);
  t_out[i] = t;
  idx_out[i] = idx;
  if constexpr (NORMAL) {
    V3 nrm = splat(0.0f);
    if (!(t > kFar)) nrm = calc_normal<BAKED, TCULL>(S, g, ro + rd * t);
    nx[i] = nrm.x;
    ny[i] = nrm.y;
    nz[i] = nrm.z;
  }
}

template <bool BAKED, bool TCULL, bool NORMAL>
void launch(const Scene& S, int n, const float* const* ray, float* t, int* idx, float* const* nrm,
            cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  march_rays<BAKED, TCULL, NORMAL><<<grid, kBlock, 0, stream>>>(
      S, n, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], t, idx, nrm[0], nrm[1], nrm[2]);
}

template <bool BAKED>
void launch_mode(const Scene& S, int t_cull, int with_normal, int n, const float* const* ray,
                 float* t, int* idx, float* const* nrm, cudaStream_t stream) {
  if (t_cull) {
    if (with_normal) {
      launch<BAKED, true, true>(S, n, ray, t, idx, nrm, stream);
    } else {
      launch<BAKED, true, false>(S, n, ray, t, idx, nrm, stream);
    }
  } else if (with_normal) {
    launch<BAKED, false, true>(S, n, ray, t, idx, nrm, stream);
  } else {
    launch<BAKED, false, false>(S, n, ray, t, idx, nrm, stream);
  }
}

}  // namespace

// Marches n > 0 rays on `stream`; returns cudaGetLastError() (0 on success).
// `code` and `table` are as for cpt_megakernel_march (the materials are not
// read).  The rays are six float32 (n,) arrays ro.x, ro.y, ro.z, rd.x, rd.y,
// rd.z; the outputs t (float32), idx (int32) and, when with_normal, the
// normal's three float32 components, each (n,).  The caller checks the
// program against kMaxDepth and kMaxBoxed.
extern "C" int cpt_march_rays(const int* code, int n_ops, const float* table, int n_boxed,
                              int f_box, int baked, int t_cull, int with_normal, int n,
                              const float* rox, const float* roy, const float* roz,
                              const float* rdx, const float* rdy, const float* rdz, float* t,
                              int* idx, float* nx, float* ny, float* nz, void* stream) {
  Scene S{code, n_ops, table, n_boxed, f_box, f_box + 6 * n_boxed, 0, nullptr, 0};
  const float* ray[6] = {rox, roy, roz, rdx, rdy, rdz};
  float* nrm[3] = {nx, ny, nz};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (baked) {
    launch_mode<true>(S, t_cull, with_normal, n, ray, t, idx, nrm, st);
  } else {
    launch_mode<false>(S, t_cull, with_normal, n, ray, t, idx, nrm, st);
  }
  return static_cast<int>(cudaGetLastError());
}
