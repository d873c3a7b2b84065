// The three march probes, one thread per ray over flat (n,) rays in baked
// geometry, each K3's march (march_rays.cu) with one thing changed:
//
// * march_dense replaces compute_path_tracer_tpu/benchmarks/dense_probe.py
//   :dense (the pallas_call at :119, body _dense_march_kernel :49): the exact
//   march with every leaf evaluated at every tap and the guard selecting
//   the fold's operand, no branch on a guard; the id of the last tap, -1
//   when far.  It asks whether skipping the shapes a ray's guards reject is
//   worth its branches.  Each block stages the decoded records and the leaf
//   table in shared memory once (csg_program.cuh:stage_walk, with no
//   per-warp lists), and every tap walks the whole staged program
//   (march_walk in map mode DENSE).  With no guard branch every lane of a
//   warp sits on the same record at the same time, so each record and each
//   leaf value is one broadcast shared-memory load, as the records of K3's
//   lists are: dense and K3 differ only in the work each tap does.
// * march_capped replaces benchmarks/analytic_probe.py:capped (:194, body
//   _make_capped_kernel :47): the program without the guard-less shapes of
//   analytic_unboxed (render/program.py:build_program(skip_unboxed=True)),
//   the per-thread t-culled march, and each ray stopped at the closed-form
//   hit of those shapes (cap_scan, K1's leaf_t): K2b's cap on K3's march.
//   It asks what the guard-less shapes cost the march.
// * march_ilp_seq and march_ilp_fused replace benchmarks/ilp_probe.py:run
//   (:184, seq_kernel :75, fused_kernel :86).  The TPU question is whether
//   two independent dependency chains per program close the scheduling gap;
//   here a thread marches two rays, ray i and ray i + kBlock of a
//   2 kBlock-ray block: one after the other (seq), or both in one loop
//   whose map walks the program once and evaluates each shape's two leaves
//   back to back (fused, map_pair_walk), with a done flag per ray.  The
//   thread count halves, so occupancy falls as the instruction-level
//   parallelism rises: that trade is this card's form of the question.
//   Both take K3's per-warp walk of the program staged in shared memory
//   (stage_walk once a block): seq builds one list per 32 rays, each the
//   list K3's warp of the same rays builds; fused one list per warp over
//   the union of its two rays' guards, which may be longer than either.
//   Both run the exact march, so each ray's t is K3's exact march's bit
//   for bit.
//
// What bounds them is K3's: operations (leaf SDFs per tap, up to 80 taps a
// ray) against 24 bytes in and 4-8 out per ray.  The capped probe reads the
// program from global memory at every tap (csg_program.cuh map_ops); it is
// written to answer its question simply, not to be fast.  Parity: the
// flags and helpers of K2 and K3 (note at the head of megakernel_march.cu);
// each probe is held bit for bit to its plain version in kernels/probes.py.

#include "csg_program.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
};

__device__ __forceinline__ void load_ray(const Rays& R, int i, V3& ro, V3& rd) {
  ro = v3(R.ox[i], R.oy[i], R.oz[i]);
  rd = v3(R.dx[i], R.dy[i], R.dz[i]);
}

// Dynamic shared memory: walk_smem_bytes(n_ops, f_leaf, 0).  A thread past
// the end of the rays helps stage the program, then returns.
__global__ void __launch_bounds__(kBlock)
march_dense(Scene S, int f_leaf, int n, Rays R, float* __restrict__ t_out,
            int* __restrict__ idx_out) {
  extern __shared__ int4 walk_smem[];
  const Walk P = stage_walk(S, f_leaf, 0, walk_smem, threadIdx.x, kBlock);
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  V3 ro, rd;
  load_ray(R, i, ro, rd);
  Guards<false> g;
  compute_guards(S, ro, rd, g);
  int idx;
  t_out[i] = march_walk<true, false, DENSE>(S, P.prog, P.n_ops, P.F, g, ro, rd, idx);
  idx_out[i] = idx;
}

__global__ void __launch_bounds__(kBlock)
march_capped(Scene S, int n, Rays R, float* __restrict__ t_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  V3 ro, rd;
  load_ray(R, i, ro, rd);
  Guards<true> g;
  compute_guards(S, ro, rd, g);
  float t_cap;
  int j_cap, idx;
  cap_scan(S, ro, rd, t_cap, j_cap);
  t_out[i] = march<true, true>(S, g, ro, rd, idx, t_cap);
}

// Dynamic shared memory: walk_smem_bytes(n_ops, f_leaf, kWarps).  Warp w
// of block b marches rays 256 b + 32 w + lane (h = 0), then the same + 128
// (h = 1): 32 consecutive rays each time, K3's warp, with K3's list of
// them.  Every lane builds both lists (a warp collective); a lane past the
// end of the rays takes part as not live.
__global__ void __launch_bounds__(kBlock)
march_ilp_seq(Scene S, int f_leaf, int n, Rays R, float* __restrict__ t_out) {
  extern __shared__ int4 walk_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Walk P = stage_walk(S, f_leaf, kWarps, walk_smem, threadIdx.x, kBlock);
  const int4* __restrict__ list = P.lists + warp * P.n_ops;
  const int base = blockIdx.x * 2 * kBlock + threadIdx.x;
  for (int h = 0; h < 2; ++h) {
    const int i = base + h * kBlock;
    const bool live = i < n;
    V3 ro = splat(0.0f), rd = splat(0.0f);
    Guards<false> g;
    if (live) {
      load_ray(R, i, ro, rd);
      compute_guards(S, ro, rd, g);
    }
    const int len = build_warp_list(P, S.n_boxed, g, live, warp, lane);
    if (!live) continue;
    int idx;
    t_out[i] = march_walk<true, false>(S, list, len, P.F, g, ro, rd, idx);
  }
}

// leaf_baked at two points, the kind's branch taken once.
__device__ __forceinline__ void leaf_pair(int kind, const float* __restrict__ g, V3 p0, V3 p1,
                                          float& e0, float& e1) {
  if (kind == KIND_SPHERE) {
    e0 = length_safe(v3(p0.x - g[0], p0.y - g[1], p0.z - g[2])) - g[3];
    e1 = length_safe(v3(p1.x - g[0], p1.y - g[1], p1.z - g[2])) - g[3];
  } else if (kind == KIND_PLANE) {
    e0 = g[0] * p0.x + g[1] * p0.y + g[2] * p0.z + g[3];
    e1 = g[0] * p1.x + g[1] * p1.y + g[2] * p1.z + g[3];
  } else {
    const V3 q0 = v3(g[0] * p0.x + g[1] * p0.y + g[2] * p0.z + g[9],
                     g[3] * p0.x + g[4] * p0.y + g[5] * p0.z + g[10],
                     g[6] * p0.x + g[7] * p0.y + g[8] * p0.z + g[11]);
    const V3 q1 = v3(g[0] * p1.x + g[1] * p1.y + g[2] * p1.z + g[9],
                     g[3] * p1.x + g[4] * p1.y + g[5] * p1.z + g[10],
                     g[6] * p1.x + g[7] * p1.y + g[8] * p1.z + g[11]);
    e0 = leaf_sdf(kind, q0, g + 12);
    e1 = leaf_sdf(kind, q1, g + 12);
  }
}

// map_walk<true, false, false> at two points, each under its own guards, in
// one walk of a warp's list of the staged program: ENTER and LEAVE act on
// both accumulators, a shape's two leaves are evaluated back to back when
// either ray's guard passes, and each is folded where its own guard
// passes.  A ray that is not marching (m0, m1) folds nothing.  The list
// holds every record either ray's guards pass, so each marching ray's (d,
// id) is map_walk's over its own list, and map_ops' over the program.
__device__ void map_pair_walk(const int4* __restrict__ list, int len,
                              const float* __restrict__ F, const Guards<false>& g0,
                              const Guards<false>& g1, V3 p0, V3 p1, bool m0, bool m1,
                              float& d0, int& i0, float& d1, int& i1) {
  float st_d0[kMaxDepth], st_d1[kMaxDepth];
  int st_i0[kMaxDepth], st_i1[kMaxDepth];
  int sp = 0;
  float a0 = kMaxDist, a1 = kMaxDist;
  int b0 = -1, b1 = -1;
  for (int e = 0; e < len; ++e) {
    const int4 r = list[e];
    const int opc = r.x & 3;
    if (opc == OPC_ENTER) {
      st_d0[sp] = a0;
      st_i0[sp] = b0;
      st_d1[sp] = a1;
      st_i1[sp] = b1;
      ++sp;
      a0 = a1 = __int_as_float(r.z);
      b0 = b1 = -1;
    } else if (opc == OPC_SHAPE) {
      const int box = walk_box(r);
      const bool q0 = m0 && (box < 0 || g0.check(box));
      const bool q1 = m1 && (box < 0 || g1.check(box));
      if (!q0 && !q1) continue;
      float e0, e1;
      leaf_pair((r.x >> 2) & 7, F + r.y, p0, p1, e0, e1);
      const int fop = ((r.x >> 5) & 15) - 1;
      const float kv = __int_as_float(r.w);
      if (q0) fold(fop, kv, a0, b0, e0, r.z);
      if (q1) fold(fop, kv, a1, b1, e1, r.z);
    } else {  // OPC_LEAVE
      const float e0 = a0, e1 = a1;
      const int c0 = b0, c1 = b1;
      --sp;
      a0 = st_d0[sp];
      b0 = st_i0[sp];
      a1 = st_d1[sp];
      b1 = st_i1[sp];
      const int fop = ((r.x >> 5) & 15) - 1;
      const float kv = __int_as_float(r.w);
      fold(fop, kv, a0, b0, e0, c0);
      fold(fop, kv, a1, b1, e1, c1);
    }
  }
  d0 = a0;
  i0 = b0;
  d1 = a1;
  i1 = b1;
}

__device__ __forceinline__ V3 at(V3 ro, V3 rd, float t) {
  return v3(ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t);
}

// Dynamic shared memory as march_ilp_seq's.  Each warp builds one list for
// both its rays: every lane ORs its two rays' guard words, and the list is
// build_warp_list over that union (a lane with neither ray takes part as
// not live).  The loop runs while either ray marches, each with its done
// flag.
__global__ void __launch_bounds__(kBlock)
march_ilp_fused(Scene S, int f_leaf, int n, Rays R, float* __restrict__ t_out) {
  extern __shared__ int4 walk_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Walk P = stage_walk(S, f_leaf, kWarps, walk_smem, threadIdx.x, kBlock);
  const int4* __restrict__ list = P.lists + warp * P.n_ops;
  const int i0 = blockIdx.x * 2 * kBlock + threadIdx.x;
  const int i1 = i0 + kBlock;
  const bool v0 = i0 < n, v1 = i1 < n;
  V3 o0 = splat(0.0f), r0 = splat(0.0f), o1 = splat(0.0f), r1 = splat(0.0f);
  Guards<false> g0, g1;
  if (v0) {
    load_ray(R, i0, o0, r0);
    compute_guards(S, o0, r0, g0);
  }
  if (v1) {
    load_ray(R, i1, o1, r1);
    compute_guards(S, o1, r1, g1);
  }
  int len;
  {
    Guards<false> gu;
#pragma unroll
    for (int w = 0; w < kMaxBoxed / 32; ++w) {
      gu.bits[w] = (v0 ? g0.bits[w] : 0u) | (v1 ? g1.bits[w] : 0u);
    }
    len = build_warp_list(P, S.n_boxed, gu, v0 || v1, warp, lane);
  }
  float t0 = 0.0f, t1 = 0.0f;
  bool m0 = v0, m1 = v1;
  for (int step = 0; step < kSteps && (m0 || m1); ++step) {
    float e0, e1;
    int k0, k1;
    map_pair_walk(list, len, P.F, g0, g1, at(o0, r0, t0), at(o1, r1, t1), m0, m1, e0, k0, e1,
                  k1);
    if (m0) {
      const float ad = fabsf(e0);
      t0 = t0 + ad;
      m0 = !(ad < kMhd || t0 > kFar);
    }
    if (m1) {
      const float ad = fabsf(e1);
      t1 = t1 + ad;
      m1 = !(ad < kMhd || t1 > kFar);
    }
  }
  if (v0) t_out[i0] = t0;
  if (v1) t_out[i1] = t1;
}

Scene probe_scene(const int* code, int n_ops, const float* table, int n_boxed, int f_box,
                  int n_cap) {
  return Scene{code, n_ops, table, n_boxed, f_box, f_box + 6 * n_boxed, 0,
               code + OP_WIDTH * n_ops + n_boxed, n_cap};
}

}  // namespace

// Each marches n > 0 rays of a baked program on `stream` and returns
// cudaGetLastError() (0 on success).  `code` and `table` are as for
// cpt_march_rays (program_code_on, program_table with t_cull for capped);
// the rays are six float32 (n,) arrays ro.x, ro.y, ro.z, rd.x, rd.y, rd.z;
// t (float32) and, for dense, idx (int32) are (n,).  The caller checks the
// program against kMaxDepth and kMaxBoxed.  For dense, smem_bytes, the
// block's dynamic shared memory, must be walk_smem_bytes(n_ops, f_box, 0)
// (render/program.py:walk_smem_bytes, which raises for a program a block
// cannot hold).
extern "C" int cpt_march_dense(const int* code, int n_ops, const float* table, int n_boxed,
                               int f_box, int n, const float* rox, const float* roy,
                               const float* roz, const float* rdx, const float* rdy,
                               const float* rdz, float* t, int* idx, int smem_bytes,
                               void* stream) {
  if (smem_bytes != walk_smem_bytes(n_ops, f_box, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        march_dense, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Rays R{rox, roy, roz, rdx, rdy, rdz};
  march_dense<<<(n + kBlock - 1) / kBlock, kBlock, smem_bytes,
                static_cast<cudaStream_t>(stream)>>>(
      probe_scene(code, n_ops, table, n_boxed, f_box, 0), f_box, n, R, t, idx);
  return static_cast<int>(cudaGetLastError());
}

// `code` is a skip_unboxed program's, whose n_cap cap records follow the
// cull flags.
extern "C" int cpt_march_capped(const int* code, int n_ops, const float* table, int n_boxed,
                                int f_box, int n_cap, int n, const float* rox,
                                const float* roy, const float* roz, const float* rdx,
                                const float* rdy, const float* rdz, float* t, void* stream) {
  const Rays R{rox, roy, roz, rdx, rdy, rdz};
  march_capped<<<(n + kBlock - 1) / kBlock, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      probe_scene(code, n_ops, table, n_boxed, f_box, n_cap), n, R, t);
  return static_cast<int>(cudaGetLastError());
}

// interleave 0 launches march_ilp_seq, 1 march_ilp_fused, a block of 128
// threads per 256 rays.  smem_bytes, the block's dynamic shared memory,
// must be walk_smem_bytes(n_ops, f_box, 4) (render/program.py:
// walk_smem_bytes, which raises for a program a block cannot hold).
extern "C" int cpt_march_ilp(const int* code, int n_ops, const float* table, int n_boxed,
                             int f_box, int interleave, int n, const float* rox,
                             const float* roy, const float* roz, const float* rdx,
                             const float* rdy, const float* rdz, float* t, int smem_bytes,
                             void* stream) {
  if (smem_bytes != walk_smem_bytes(n_ops, f_box, kWarps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = interleave ? march_ilp_fused : march_ilp_seq;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Rays R{rox, roy, roz, rdx, rdy, rdz};
  const int grid = (n + 2 * kBlock - 1) / (2 * kBlock);
  kernel<<<grid, kBlock, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      probe_scene(code, n_ops, table, n_boxed, f_box, 0), f_box, n, R, t);
  return static_cast<int>(cudaGetLastError());
}
