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
// What bounds it on an H100: the interpreter and the lanes' fill, as in K2
// (see the note at the head of megakernel_march.cu).  A ray moves about 44
// bytes (24 in, 8 out, 12 more with the normal) against hundreds of flops
// per map tap, so memory bandwidth is idle, and the counted flops are a
// small part of the time; a walk that loaded and tested every op record at
// every tap, though a warp's rays hit few boxes, was most of the rest.  So
// the kernel takes K2's per-warp walk (csg_program.cuh): the block stages
// the decoded records and the leaf table in shared memory, each warp of 32
// consecutive rays compacts once, after the guards, the records its rays
// can need into its own list, and the march and the normal walk that list
// with the same per-ray guard tests and arithmetic.  A lane past the end of
// the rays takes part in the list as not live, then returns.  What is left
// is mostly the lanes' fill: a warp runs until its slowest ray is done.
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
constexpr int kWarps = kBlock / 32;

template <bool BAKED, bool TCULL, bool NORMAL>
__global__ void __launch_bounds__(kBlock)
march_rays(Scene S, int f_leaf, int n, const float* __restrict__ rox,
           const float* __restrict__ roy, const float* __restrict__ roz,
           const float* __restrict__ rdx, const float* __restrict__ rdy,
           const float* __restrict__ rdz, float* __restrict__ t_out, int* __restrict__ idx_out,
           float* __restrict__ nx, float* __restrict__ ny, float* __restrict__ nz) {
  extern __shared__ int4 walk_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Walk P = stage_walk(S, f_leaf, kWarps, walk_smem, threadIdx.x, kBlock);
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  V3 ro = splat(0.0f), rd = splat(0.0f);
  if (live) {
    ro = v3(rox[i], roy[i], roz[i]);
    rd = v3(rdx[i], rdy[i], rdz[i]);
  }
  Guards<TCULL> g;
  if (live) compute_guards(S, ro, rd, g);
  const int len = build_warp_list(P, S.n_boxed, g, live, warp, lane);
  if (!live) return;
  const int4* __restrict__ list = P.lists + warp * P.n_ops;
  int idx;
  const float t = march_walk<BAKED, TCULL>(S, list, len, P.F, g, ro, rd, idx);
  t_out[i] = t;
  idx_out[i] = idx;
  if constexpr (NORMAL) {
    V3 nrm = splat(0.0f);
    if (!(t > kFar)) nrm = normal_walk<BAKED, TCULL>(list, len, P.F, g, ro + rd * t);
    nx[i] = nrm.x;
    ny[i] = nrm.y;
    nz[i] = nrm.z;
  }
}

template <bool BAKED, bool TCULL, bool NORMAL>
int launch(const Scene& S, int f_leaf, int smem_bytes, int n, const float* const* ray, float* t,
           int* idx, float* const* nrm, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        march_rays<BAKED, TCULL, NORMAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n + kBlock - 1) / kBlock;
  march_rays<BAKED, TCULL, NORMAL><<<grid, kBlock, smem_bytes, stream>>>(
      S, f_leaf, n, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], t, idx, nrm[0], nrm[1],
      nrm[2]);
  return static_cast<int>(cudaGetLastError());
}

template <bool BAKED>
int launch_mode(const Scene& S, int f_leaf, int smem_bytes, int t_cull, int with_normal, int n,
                const float* const* ray, float* t, int* idx, float* const* nrm,
                cudaStream_t stream) {
  auto fn = t_cull ? (with_normal ? &launch<BAKED, true, true> : &launch<BAKED, true, false>)
                   : (with_normal ? &launch<BAKED, false, true> : &launch<BAKED, false, false>);
  return fn(S, f_leaf, smem_bytes, n, ray, t, idx, nrm, stream);
}

}  // namespace

// Marches n > 0 rays on `stream`; returns cudaGetLastError() (0 on success).
// `code` and `table` are as for cpt_megakernel_march (the materials are not
// read).  The rays are six float32 (n,) arrays ro.x, ro.y, ro.z, rd.x, rd.y,
// rd.z; the outputs t (float32), idx (int32) and, when with_normal, the
// normal's three float32 components, each (n,).  smem_bytes, the block's
// dynamic shared memory, must be walk_smem_bytes(n_ops, f_box, 4)
// (render/program.py:walk_smem_bytes).  The caller checks the program
// against kMaxDepth and kMaxBoxed.
extern "C" int cpt_march_rays(const int* code, int n_ops, const float* table, int n_boxed,
                              int f_box, int baked, int t_cull, int with_normal, int n,
                              const float* rox, const float* roy, const float* roz,
                              const float* rdx, const float* rdy, const float* rdz, float* t,
                              int* idx, float* nx, float* ny, float* nz, int smem_bytes,
                              void* stream) {
  Scene S{code, n_ops, table, n_boxed, f_box, f_box + 6 * n_boxed, 0, nullptr, 0};
  if (smem_bytes != walk_smem_bytes(n_ops, f_box, kWarps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* ray[6] = {rox, roy, roz, rdx, rdy, rdz};
  float* nrm[3] = {nx, ny, nz};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return baked ? launch_mode<true>(S, f_box, smem_bytes, t_cull, with_normal, n, ray, t, idx,
                                   nrm, st)
               : launch_mode<false>(S, f_box, smem_bytes, t_cull, with_normal, n, ray, t, idx,
                                    nrm, st);
}
