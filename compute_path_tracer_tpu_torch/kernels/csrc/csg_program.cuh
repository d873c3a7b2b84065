// The CSG program interpreter shared by the marching kernels
// (megakernel_march.cu, K2; march_rays.cu, K3; train_fused.cu, K4): one
// bounce's AABB guards and t-cull intervals, the leaf SDFs, the fold, the
// scene map over the op list of render/program.py (guarded, dense, or
// counting for debug 4), the 80-step march (with the closed-form cap of
// analytic_unboxed, over-relaxed, and in warp lockstep for debug 4), the
// distance-grid march (dist_grid, K6) with its grid tap, the 6-tap normal,
// and the cap's closed form over the program's cap list.  The parity
// decisions are in the note at the head of megakernel_march.cu; everything
// here has internal linkage, so each kernel's translation unit carries its
// own copy.
//
// Two walks of the program.  map_ops reads every op record of the program
// from global memory at every map tap and tests each guarded shape's bit
// per lane: a tap of the 64-primitive benchmark scene loads and skips some
// 60 records whose box no lane of the warp hits, integer and load work the
// operation count of app/profiling.py does not see.  Only the capped probe
// and fused-bwd keep that walk.  The dense probe walks the whole program
// staged in shared memory (map_walk DENSE over stage_walk's records).
// Every march of K2 (debug 0-4, analytic_unboxed, the over-relaxed march),
// its grid march (K6), K3, K4, the wavefront's bounce and the ILP probe
// (march_probes.cu, with its own pair walk for two rays a thread) take the
// per-warp walk at the end of this file: the block stages the
// decoded records and the leaf table in shared memory once (stage_walk),
// each warp compacts the records its live lanes can need into a list after
// the bounce's guards (build_warp_list), and the map, the marches and the
// gradient walk that list (map_walk, march_walk, march_relax_walk,
// march_stats_walk, march_grid_walk, grad_walk) with the same per-lane
// guard tests and the same arithmetic in the same order, so every lane
// folds the shapes it folded before and every frame, ray, sum and debug-4
// count stays bit for bit.

#pragma once

#include "analytic.cuh"
#include "common.cuh"

namespace {

constexpr int OPC_ENTER = 0;
constexpr int OPC_SHAPE = 1;
constexpr int OP_WIDTH = 8;
constexpr int FOLD_ASSIGN = -1;
constexpr int OP_UNION = 0;
constexpr int OP_SUBTRACTION = 1;

constexpr int kMaxDepth = 16;           // program.py:MAX_DEPTH
constexpr int kMaxBoxed = 256;          // program.py:MAX_BOXED
constexpr int kSteps = 80;              // constants.STEPS
constexpr float kMhd = 0.001f;          // constants.MHD
constexpr float kMaxDist = 10000.0f;    // constants.MAX_DIST
constexpr float kNormalEps = 1e-4f;

struct Scene {
  const int* code;     // n_ops records of OP_WIDTH, then box_cull, then caps
  int n_ops;
  const float* F;      // program_table
  int n_boxed, f_box, f_sph, f_mat;
  const int* caps;     // n_cap records: kind, baked offset in F, shape id
  int n_cap;
};

// One bounce's guards: AABB check bits, and with TCULL each culled box's
// [lo, hi] interval along the ray (written only where the check passes).
template <bool TCULL>
struct Guards {
  uint32_t bits[kMaxBoxed / 32];
  float lo[TCULL ? kMaxBoxed : 1];
  float hi[TCULL ? kMaxBoxed : 1];

  __device__ __forceinline__ bool check(int j) const { return (bits[j >> 5] >> (j & 31)) & 1u; }
};

// AABB checks of every guarded shape, in walk order; returns the debug-1 tint
// (0.1 per hit, summed in walk order).
template <bool TCULL>
__device__ float compute_guards(const Scene& S, V3 ro, V3 rd, Guards<TCULL>& g) {
  const int* cull = S.code + OP_WIDTH * S.n_ops;
#pragma unroll
  for (int w = 0; w < kMaxBoxed / 32; ++w) g.bits[w] = 0u;
  float dbg = 0.0f;
  for (int j = 0; j < S.n_boxed; ++j) {
    bool hit = slab_box(S.F + S.f_box + 6 * j, ro, rd);
    dbg = dbg + 0.1f * (hit ? 1.0f : 0.0f);
    if (!hit) continue;
    g.bits[j >> 5] |= 1u << (j & 31);
    if constexpr (TCULL) {
      if (!cull[j]) continue;
      // The ray's interval through the leaf's bounding sphere
      // (program.py:program_bounds).
      const float* s = S.F + S.f_sph + 4 * j;
      float ocx = ro.x - s[0], ocy = ro.y - s[1], ocz = ro.z - s[2];
      float b = ocx * rd.x + ocy * rd.y + ocz * rd.z;
      float disc = b * b - ((ocx * ocx + ocy * ocy + ocz * ocz) - s[3] * s[3]);
      if (disc >= 0.0f) {
        float root = sqrtf(disc);
        g.lo[j] = nan_max(-b - root, 0.0f);
        g.hi[j] = -b + root;
      } else {
        g.lo[j] = kBig;
        g.hi[j] = -kBig;
      }
    }
  }
  return dbg;
}

// Nearest culled interval entry still ahead of t (kBig when none).
template <bool TCULL>
__device__ float next_entry(const Scene& S, const Guards<TCULL>& g, float t) {
  const int* cull = S.code + OP_WIDTH * S.n_ops;
  float m = kBig;
  for (int w = 0; w * 32 < S.n_boxed; ++w) {
    uint32_t bits = g.bits[w];
    while (bits) {
      int j = 32 * w + __ffs(bits) - 1;
      bits &= bits - 1u;
      if (cull[j] && g.lo[j] > t && g.lo[j] < m) m = g.lo[j];
    }
  }
  return m;
}

// -- leaves ---------------------------------------------------------------------

__device__ __forceinline__ float length_safe(V3 v) {
  float l2 = dot(v, v);
  return l2 > 0.0f ? sqrtf(l2) : 0.0f;
}

__device__ __forceinline__ float octa_branch(float qx, float qy, float qz, float s) {
  float k = nan_min(nan_max(0.5f * (qz - qy + s), 0.0f), s);
  return length_safe(v3(qx, qy - s + k, qz - k));
}

// Leaf SDFs in the leaf's frame (ops/sdf.py); `sz` is the size slots.
__device__ float leaf_sdf(int kind, V3 q, const float* __restrict__ sz) {
  if (kind == KIND_SPHERE) return length_safe(q) - sz[0];
  if (kind == KIND_PLANE) return q.y;
  if (kind == KIND_CUBE) {
    V3 a = v3(fabsf(q.x) - sz[0], fabsf(q.y) - sz[1], fabsf(q.z) - sz[2]);
    float outside = length_safe(v3(nan_max(a.x, 0.0f), nan_max(a.y, 0.0f), nan_max(a.z, 0.0f)));
    float inside = nan_min(nan_max(a.x, nan_max(a.y, a.z)), 0.0f);
    return outside + inside;
  }
  float s = sz[0];
  V3 p = v3(fabsf(q.x), fabsf(q.y), fabsf(q.z));
  float m = p.x + p.y + p.z - s;
  float out = m * 0.57735027f;
  if (3.0f * p.z < m) out = octa_branch(p.z, p.x, p.y, s);
  if (3.0f * p.y < m) out = octa_branch(p.y, p.z, p.x, s);
  if (3.0f * p.x < m) out = octa_branch(p.x, p.y, p.z, s);
  return out;
}

// apply_transform from a faithful node record r: p*inv - pos*inv, then the
// rotation from the stored cos/sin (ops/sdf.py:rot3d_cs).
__device__ __forceinline__ V3 xform(V3 p, const float* __restrict__ r) {
  V3 q = v3(p.x * r[1] - r[2], p.y * r[1] - r[3], p.z * r[1] - r[4]);
  float cx = r[5], sx = r[6], cy = r[7], sy = r[8], cz = r[9], sz = r[10];
  float y1 = cx * q.y + sx * q.z;
  float z1 = -sx * q.y + cx * q.z;
  float x2 = cy * q.x - sy * z1;
  float z2 = sy * q.x + cy * z1;
  float x3 = cz * x2 + sz * y1;
  float y3 = -sz * x2 + cz * y1;
  return v3(x3, y3, z2);
}

// World-space leaf SDF from baked slots (render/baked.py:leaf_distance).
__device__ float leaf_baked(int kind, const float* __restrict__ g, V3 p) {
  if (kind == KIND_SPHERE) return length_safe(v3(p.x - g[0], p.y - g[1], p.z - g[2])) - g[3];
  if (kind == KIND_PLANE) return g[0] * p.x + g[1] * p.y + g[2] * p.z + g[3];
  V3 q = v3(g[0] * p.x + g[1] * p.y + g[2] * p.z + g[9],
            g[3] * p.x + g[4] * p.y + g[5] * p.z + g[10],
            g[6] * p.x + g[7] * p.y + g[8] * p.z + g[11]);
  return leaf_sdf(kind, q, g + 12);
}

// Fold hit (d, i) into the accumulator (ops/sdf.py:combine).
__device__ __forceinline__ void fold(int op, float k, float& acc_d, int& acc_i, float d, int i) {
  if (op == FOLD_ASSIGN) {
    acc_d = d;
    acc_i = i;
  } else if (op == OP_UNION) {
    if (!(acc_d < d)) {
      acc_d = d;
      acc_i = i;
    }
  } else if (op == OP_SUBTRACTION) {
    float nd = -acc_d;
    if (nd >= d) {
      acc_d = nd;
    } else {
      acc_d = d;
      acc_i = i;
    }
  } else {
    float h = nan_min(nan_max(0.5f + 0.5f * (d - acc_d) / k, 0.0f), 1.0f);
    float blended = d * (1.0f - h) + acc_d * h - k * h * (1.0f - h);
    if (!(h > 0.5f)) acc_i = i;
    acc_d = blended;
  }
}

// How a map treats a guarded shape: GUARDED skips it where its guard fails;
// DENSE (map_walk only: the dense march probe, march_probes.cu) evaluates
// every leaf at every tap and lets the guard select the fold's operand,
// with no branch; the two COUNT modes (map_walk only: debug 4,
// megakernel_march.cu STATS) are GUARDED and add one to *tally for each
// listed shape that at least one live lane of the warp evaluates: the
// guarded shapes only (COUNT_BOXED, the march) or every shape (COUNT_ALL,
// the normal taps).  The COUNT modes take one __ballot_sync over the full
// warp per listed shape, so every lane of the warp must walk the list
// together; a lane that is not live evaluates nothing.
enum MapMode { GUARDED = 0, DENSE = 1, COUNT_BOXED = 2, COUNT_ALL = 3 };
constexpr unsigned kFullWarp = 0xffffffffu;

// The scene map at p: interprets the program from global memory, skipping
// a guarded shape where its guard fails.  With CULLED a guarded shape marked
// in box_cull is evaluated only while its interval holds t.
template <bool BAKED, bool TCULL, bool CULLED>
__device__ __forceinline__ float map_ops(const Scene& S, const Guards<TCULL>& g, V3 p, float t,
                                         int& id) {
  float st_d[kMaxDepth];
  int st_i[kMaxDepth];
  V3 st_p[BAKED ? 1 : kMaxDepth];
  int sp = 0;
  float acc_d = kMaxDist;
  int acc_i = -1;
  const float* __restrict__ F = S.F;
  for (int pc = 0; pc < S.n_ops; ++pc) {
    const int* __restrict__ op = S.code + OP_WIDTH * pc;
    const int opc = __ldg(op);
    if (opc == OPC_ENTER) {
      st_d[sp] = acc_d;
      st_i[sp] = acc_i;
      if (!BAKED) {
        st_p[sp] = p;
        p = xform(p, F + __ldg(op + 1));
      }
      ++sp;
      const int init = __ldg(op + 2);
      acc_d = init >= 0 ? __ldg(F + init) : kMaxDist;
      acc_i = -1;
    } else if (opc == OPC_SHAPE) {
      const int box = __ldg(op + 3);
      if (box >= 0) {
        bool pass = g.check(box);
        if constexpr (CULLED) {
          if (pass && __ldg(op + 7)) pass = g.lo[box] <= t && g.hi[box] >= t;
        }
        if (!pass) continue;
      }
      const int kind = __ldg(op + 1);
      const float* __restrict__ r = F + __ldg(op + 2);
      float d;
      if (BAKED) {
        d = leaf_baked(kind, r, p);
      } else {
        d = leaf_sdf(kind, xform(p, r), r + 11) * __ldg(r);
      }
      const int k = __ldg(op + 6);
      fold(__ldg(op + 5), k >= 0 ? __ldg(F + k) : 0.0f, acc_d, acc_i, d, __ldg(op + 4));
    } else {  // OPC_LEAVE
      float d = BAKED ? acc_d : acc_d * __ldg(F + __ldg(op + 1));
      int i = acc_i;
      --sp;
      acc_d = st_d[sp];
      acc_i = st_i[sp];
      if (!BAKED) p = st_p[sp];
      const int k = __ldg(op + 3);
      fold(__ldg(op + 2), k >= 0 ? __ldg(F + k) : 0.0f, acc_d, acc_i, d, i);
    }
  }
  id = acc_i;
  return acc_d;
}

// The scene map at p.
template <bool BAKED, bool TCULL, bool CULLED>
__device__ float map_scene(const Scene& S, const Guards<TCULL>& g, V3 p, float t, int& id) {
  return map_ops<BAKED, TCULL, CULLED>(S, g, p, t, id);
}

// The 80-step march of one ray (cast_ray, or cast_tcull with TCULL);
// returns t, and the id of the last map tap in idx (-1 when far).  A finite
// t_cap (analytic_unboxed) stops the ray on it: t = min(t, t_cap), done once
// t >= t_cap; the default INFINITY leaves the march as it is.
template <bool BAKED, bool TCULL>
__device__ float march(const Scene& S, const Guards<TCULL>& g, V3 ro, V3 rd, int& idx,
                       float t_cap = INFINITY) {
  float t = 0.0f;
  float m = kBig;
  if constexpr (TCULL) m = next_entry(S, g, 0.0f);
  idx = -1;
  for (int step = 0; step < kSteps; ++step) {
    int mi;
    float d = map_scene<BAKED, TCULL, TCULL>(S, g, v3(ro.x + rd.x * t, ro.y + rd.y * t,
                                                      ro.z + rd.z * t), t, mi);
    float ad = fabsf(d);
    float nt = TCULL ? t + nan_min(ad, nan_max(m - t, kMhd)) : t + ad;
    nt = nan_min(nt, t_cap);
    bool far = nt > kFar;
    idx = far ? -1 : mi;
    t = nt;
    if (ad < kMhd || far || nt >= t_cap) break;
    if constexpr (TCULL) {
      if (t >= m) m = next_entry(S, g, t);
    }
  }
  return t;
}

// -- the distance grid (K6) -----------------------------------------------------

constexpr int kGridExtraIters = 256;    // distgrid.py:GRID_EXTRA_ITERS

// The frame's baked lower-bound grid (render/distgrid.py): meta holds lo.xyz,
// inv_cell.xyz, hi.xyz; cells the gz*gy*gx per-cell bounds, flat index
// (iz*gy + iy)*gx + ix; offs the n_planes plane-row offsets into the table,
// then the n_k smooth-union k offsets, in walk order.  A few KiB to 128 KiB
// read with __ldg, so they stay in L1 and L2.
struct Grid {
  const float* meta;
  const float* cells;
  int gx, gy, gz;
  const int* offs;
  int n_planes, n_k;
  float tau;
};

// The bound at p (distgrid.py:make_grid_tap, JAX make_grid_tap): the cell's
// value inside the box, else the distance to the box min'ed with the exact
// plane distances; minus k/4 per smooth node.  Floor, clip as float, then
// the int cast, in JAX's order.
__device__ float grid_tap(const Grid& G, const float* __restrict__ F, V3 p) {
  const float* __restrict__ mt = G.meta;
  const float lox = __ldg(mt), loy = __ldg(mt + 1), loz = __ldg(mt + 2);
  const float ivx = __ldg(mt + 3), ivy = __ldg(mt + 4), ivz = __ldg(mt + 5);
  const float hix = __ldg(mt + 6), hiy = __ldg(mt + 7), hiz = __ldg(mt + 8);
  const int ix = (int)nan_min(nan_max(floorf((p.x - lox) * ivx), 0.0f), (float)(G.gx - 1));
  const int iy = (int)nan_min(nan_max(floorf((p.y - loy) * ivy), 0.0f), (float)(G.gy - 1));
  const int iz = (int)nan_min(nan_max(floorf((p.z - loz) * ivz), 0.0f), (float)(G.gz - 1));
  float g = __ldg(G.cells + (iz * G.gy + iy) * G.gx + ix);
  const bool inside = p.x >= lox && p.x <= hix && p.y >= loy && p.y <= hiy && p.z >= loz &&
                      p.z <= hiz;
  if (!inside) {
    const float qx = nan_max(nan_max(lox - p.x, p.x - hix), 0.0f);
    const float qy = nan_max(nan_max(loy - p.y, p.y - hiy), 0.0f);
    const float qz = nan_max(nan_max(loz - p.z, p.z - hiz), 0.0f);
    float db = sqrtf(qx * qx + qy * qy + qz * qz);
    for (int j = 0; j < G.n_planes; ++j) {
      const float* __restrict__ r = F + __ldg(G.offs + j);
      db = nan_min(db, __ldg(r) * p.x + __ldg(r + 1) * p.y + __ldg(r + 2) * p.z + __ldg(r + 3));
    }
    g = db;
  }
  for (int j = 0; j < G.n_k; ++j) g = g - 0.25f * __ldg(F + __ldg(G.offs + G.n_planes + j));
  return g;
}

// The closed-form cap of analytic_unboxed over the program's cap list
// (kernels/megakernel.py:make_analytic_unboxed): the nearest hit t_cap (kBig
// when none) and its record j (-1); a strict < keeps the earlier shape.
__device__ void cap_scan(const Scene& S, V3 ro, V3 rd, float& t_cap, int& j_cap) {
  t_cap = kBig;
  j_cap = -1;
  for (int j = 0; j < S.n_cap; ++j) {
    const int* c = S.caps + 3 * j;
    const int kind = __ldg(c);
    const float* __restrict__ gv = S.F + __ldg(c + 1);
    float t;
    if (kind == KIND_SPHERE) {
      t = leaf_t<KIND_SPHERE>(gv, ro, rd);
    } else if (kind == KIND_PLANE) {
      t = leaf_t<KIND_PLANE>(gv, ro, rd);
    } else {
      t = leaf_t<KIND_CUBE>(gv, ro, rd);
    }
    if (t < t_cap) {
      t_cap = t;
      j_cap = j;
    }
  }
}

// The exact normal of cap record j at p.
__device__ __forceinline__ V3 cap_normal(const Scene& S, int j, V3 p) {
  return leaf_normal(__ldg(S.caps + 3 * j), S.F + __ldg(S.caps + 3 * j + 1), p);
}

__device__ __forceinline__ int cap_id(const Scene& S, int j) { return __ldg(S.caps + 3 * j + 2); }

// The signed closest approach of the ray to the capped spheres (planes and
// cubes are skipped): d_ca (kBig when none), t_ca and the shape id i_ca.
__device__ void closest_scan(const Scene& S, V3 ro, V3 rd, float& d_ca, float& t_ca, int& i_ca) {
  d_ca = kBig;
  t_ca = 0.0f;
  i_ca = -1;
  for (int j = 0; j < S.n_cap; ++j) {
    const int* c = S.caps + 3 * j;
    if (__ldg(c) != KIND_SPHERE) continue;
    const float* __restrict__ gv = S.F + __ldg(c + 1);
    const float ocx = ro.x - gv[0], ocy = ro.y - gv[1], ocz = ro.z - gv[2];
    const float b = ocx * rd.x + ocy * rd.y + ocz * rd.z;
    const float oo = ocx * ocx + ocy * ocy + ocz * ocz;
    // A closest point behind the origin: the origin's distance.
    const float d = -b > 0.0f ? sqrtf(nan_max(oo - b * b, 0.0f)) - gv[3] : sqrtf(oo) - gv[3];
    if (d < d_ca) {
      d_ca = d;
      t_ca = nan_max(-b, 0.0f);
      i_ca = __ldg(c + 2);
    }
  }
}

// Central differences of the map, 6 taps under the bounce's full guards,
// before normalisation (calc_grad, funcs.glsl:21-35).
template <bool BAKED, bool TCULL>
__device__ V3 calc_grad(const Scene& S, const Guards<TCULL>& g, V3 p) {
  const float e = kNormalEps;
  int id;
  float d[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float off = (k & 1) ? -e : e;
    V3 q = v3(p.x + (k / 2 == 0 ? off : 0.0f), p.y + (k / 2 == 1 ? off : 0.0f),
              p.z + (k / 2 == 2 ? off : 0.0f));
    d[k] = map_scene<BAKED, TCULL, false>(S, g, q, 0.0f, id);
  }
  return v3(d[0] - d[1], d[2] - d[3], d[4] - d[5]);
}

// Central-difference normal (calc_normal).
template <bool BAKED, bool TCULL>
__device__ V3 calc_normal(const Scene& S, const Guards<TCULL>& g, V3 p) {
  return normalize_safe(calc_grad<BAKED, TCULL>(S, g, p));
}

// -- the per-warp walk (K2, K6, K3, K4, the wavefront, the ILP probe) ---------
//
// Shared memory of a block of W warps, from its base (16-byte aligned):
//   n_ops decoded records (int4), the program in walk order;
//   W lists of n_ops records, one per warp;
//   the leaf table F[0, f_leaf) (f_leaf = the program's f_box: every node
//   record or baked slot the walk reads), behind up to 3 floats of padding
//   that give it the table's own alignment modulo 16 bytes.
// render/program.py:walk_smem_bytes is the same arithmetic on the host; the
// launchers check that the two agree.
//
// A decoded record is one 16-byte shared load:
//   x: opc | kind << 2 | (fold + 1) << 5 | cull << 9 | (box + 1) << 16
//      (box + 1 = 0 for ENTER, LEAVE and a guard-less shape);
//   y: ENTER the faithful node record (xform) offset; SHAPE the leaf's
//      record (faithful) or slots (baked) offset;
//   z: ENTER the seed value (F[init], or MAX_DIST); SHAPE the shape id;
//      LEAVE the faithful un-scale F[scale] (float bits);
//   w: SHAPE and LEAVE the fold's smooth k, F[k] (0 when none; float bits).

constexpr int kWalkCull = 1 << 9;

__host__ __device__ constexpr int walk_table_offset(int n_ops, int warps) {
  return 16 * n_ops * (1 + warps);
}

__host__ __device__ constexpr int walk_smem_bytes(int n_ops, int f_leaf, int warps) {
  return walk_table_offset(n_ops, warps) + 16 * ((f_leaf + 3 + 3) / 4);
}

__device__ __forceinline__ int walk_box(int4 r) { return (r.x >> 16) - 1; }

// The program staged in a block's shared memory.
struct Walk {
  const int4* prog;  // n_ops decoded records
  int4* lists;       // warps x n_ops
  const float* F;    // the leaf table
  int n_ops;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

// Stages the program for a block of nthreads threads (thread tid): the leaf
// table by 16-byte cp.async (the unaligned head and tail by hand), and each
// op record decoded once, its table values read from global memory.  Ends
// with __syncthreads(), so every thread of the block must call it.
__device__ __forceinline__ Walk stage_walk(const Scene& S, int f_leaf, int warps,
                                           int4* __restrict__ smem, int tid, int nthreads) {
  int4* prog = smem;
  const int n_ops = S.n_ops;
  float* base = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                         walk_table_offset(n_ops, warps));
  const uintptr_t src = reinterpret_cast<uintptr_t>(S.F);
  float* F = base + ((src >> 2) & 3);
  const int head = min(static_cast<int>(((16 - (src & 15)) & 15) >> 2), f_leaf);
  const int nvec = (f_leaf - head) >> 2;
  for (int v = tid; v < nvec; v += nthreads) cp_async16(F + head + 4 * v, S.F + head + 4 * v);
  for (int j = tid; j < head; j += nthreads) F[j] = S.F[j];
  for (int j = head + 4 * nvec + tid; j < f_leaf; j += nthreads) F[j] = S.F[j];
  for (int pc = tid; pc < n_ops; pc += nthreads) {
    const int* __restrict__ op = S.code + OP_WIDTH * pc;
    const int opc = __ldg(op);
    int4 r;
    if (opc == OPC_ENTER) {
      const int init = __ldg(op + 2);
      r = make_int4(OPC_ENTER, __ldg(op + 1), __float_as_int(init >= 0 ? __ldg(S.F + init) : kMaxDist), 0);
    } else if (opc == OPC_SHAPE) {
      const int k = __ldg(op + 6);
      r = make_int4(OPC_SHAPE | __ldg(op + 1) << 2 | (__ldg(op + 5) + 1) << 5 |
                        (__ldg(op + 7) ? kWalkCull : 0) | (__ldg(op + 3) + 1) << 16,
                    __ldg(op + 2), __ldg(op + 4), __float_as_int(k >= 0 ? __ldg(S.F + k) : 0.0f));
    } else {
      const int scale = __ldg(op + 1);
      const int k = __ldg(op + 3);
      r = make_int4(opc | (__ldg(op + 2) + 1) << 5, 0,
                    __float_as_int(scale >= 0 ? __ldg(S.F + scale) : 1.0f),
                    __float_as_int(k >= 0 ? __ldg(S.F + k) : 0.0f));
    }
    prog[pc] = r;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  return Walk{prog, smem + n_ops, F, n_ops};
}

// The OR of a warp's guard words over its live lanes: lane w ends holding
// word w.  A warp collective: all 32 lanes call it, `live` or not; a lane
// that is not live adds no bits.
template <bool TCULL>
__device__ __forceinline__ uint32_t warp_box_word(int n_boxed, const Guards<TCULL>& g, bool live,
                                                  int lane) {
  uint32_t word_of_lane = 0u;
  for (int w = 0; w * 32 < n_boxed; ++w) {
    const uint32_t v = __reduce_or_sync(kFullWarp, live ? g.bits[w] : 0u);
    if (lane == w) word_of_lane = v;
  }
  return word_of_lane;
}

// The list of warp `warp` for this bounce: the records, in walk order, that
// a live lane of the warp can need (every ENTER, LEAVE and guard-less shape,
// and each guarded shape whose box bit is set for at least one live lane).
// A warp collective (warp_box_word); then each 32 records are compacted by
// a ballot prefix.  Returns the list's length, the same in every lane.
template <bool TCULL>
__device__ __forceinline__ int build_warp_list(const Walk& P, int n_boxed, const Guards<TCULL>& g,
                                               bool live, int warp, int lane) {
  const uint32_t word_of_lane = warp_box_word(n_boxed, g, live, lane);
  int4* __restrict__ list = P.lists + warp * P.n_ops;
  __syncwarp();  // no lane still reads the previous bounce's list
  int n = 0;
  for (int base = 0; base < P.n_ops; base += 32) {
    const int pc = base + lane;
    int4 r = make_int4(0, 0, 0, 0);
    if (pc < P.n_ops) r = P.prog[pc];
    const int box = walk_box(r);
    const uint32_t word = __shfl_sync(kFullWarp, word_of_lane, box >= 0 ? box >> 5 : 0);
    const bool keep = pc < P.n_ops && (box < 0 || ((word >> (box & 31)) & 1u));
    const uint32_t m = __ballot_sync(kFullWarp, keep);
    if (keep) list[n + __popc(m & ((1u << lane) - 1u))] = r;
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// Adds a warp's list length n to row i of walk_stats (when not null): the
// sum of the lengths, then the number of lists.
__device__ __forceinline__ void record_list(unsigned long long* __restrict__ walk_stats, int i,
                                            int n, int lane) {
  if (walk_stats != nullptr && lane == 0) {
    atomicAdd(walk_stats + 2 * i, static_cast<unsigned long long>(n));
    atomicAdd(walk_stats + 2 * i + 1, 1ull);
  }
}

// map_scene over a warp's list: map_ops' arithmetic, record for record,
// over the records the list holds (the others fail every live lane's guard,
// so map_ops would skip them).  Each lane still tests its own guard bit
// and, with CULLED, its own interval.  MAP COUNT_BOXED and COUNT_ALL (debug
// 4) count into *tally as map_ops counted over the whole program, and only
// live lanes evaluate: a record off the list fails the guard of every lane
// the list was built from, so its ballot over lanes among those would be 0.
// MAP DENSE walks a list that holds every record (the staged program):
// each shape's leaf is evaluated by every lane, the fold into a copy of the
// accumulator, and the lane's guard selects the copy or the accumulator, so
// the lanes of a warp never part and every record is one broadcast load;
// the values are GUARDED's.  GUARDED has its own guard branch, and live and
// tally defaults, so that its callers compile to the same SASS as without
// the other modes.
template <bool BAKED, bool TCULL, bool CULLED, int MAP = GUARDED>
__device__ __forceinline__ float map_walk(const int4* __restrict__ list, int n,
                                          const float* __restrict__ F, const Guards<TCULL>& g,
                                          V3 p, float t, int& id, bool live = true,
                                          unsigned* tally = nullptr) {
  float st_d[kMaxDepth];
  int st_i[kMaxDepth];
  V3 st_p[BAKED ? 1 : kMaxDepth];
  int sp = 0;
  float acc_d = kMaxDist;
  int acc_i = -1;
  for (int e = 0; e < n; ++e) {
    const int4 r = list[e];
    const int opc = r.x & 3;
    if (opc == OPC_ENTER) {
      st_d[sp] = acc_d;
      st_i[sp] = acc_i;
      if (!BAKED) {
        st_p[sp] = p;
        p = xform(p, F + r.y);
      }
      ++sp;
      acc_d = __int_as_float(r.z);
      acc_i = -1;
    } else if (opc == OPC_SHAPE) {
      const int box = walk_box(r);
      if constexpr (MAP == DENSE) {
        bool pass = true;
        if (box >= 0) {
          pass = g.check(box);
          if constexpr (CULLED) {
            if (pass && (r.x & kWalkCull)) pass = g.lo[box] <= t && g.hi[box] >= t;
          }
        }
        const int kind = (r.x >> 2) & 7;
        const float* __restrict__ gr = F + r.y;
        const float d = BAKED ? leaf_baked(kind, gr, p)
                              : leaf_sdf(kind, xform(p, gr), gr + 11) * gr[0];
        float fd = acc_d;
        int fi = acc_i;
        fold(((r.x >> 5) & 15) - 1, __int_as_float(r.w), fd, fi, d, r.z);
        acc_d = pass ? fd : acc_d;
        acc_i = pass ? fi : acc_i;
        continue;
      } else if constexpr (MAP == GUARDED) {
        if (box >= 0) {
          bool pass = g.check(box);
          if constexpr (CULLED) {
            if (pass && (r.x & kWalkCull)) pass = g.lo[box] <= t && g.hi[box] >= t;
          }
          if (!pass) continue;
        }
      } else {
        bool pass = live;
        if (pass && box >= 0) {
          pass = g.check(box);
          if constexpr (CULLED) {
            if (pass && (r.x & kWalkCull)) pass = g.lo[box] <= t && g.hi[box] >= t;
          }
        }
        if ((MAP == COUNT_ALL || box >= 0) && __ballot_sync(kFullWarp, pass)) ++*tally;
        if (!pass) continue;
      }
      const int kind = (r.x >> 2) & 7;
      const float* __restrict__ gr = F + r.y;
      float d;
      if (BAKED) {
        d = leaf_baked(kind, gr, p);
      } else {
        d = leaf_sdf(kind, xform(p, gr), gr + 11) * gr[0];
      }
      fold(((r.x >> 5) & 15) - 1, __int_as_float(r.w), acc_d, acc_i, d, r.z);
    } else {  // OPC_LEAVE
      float d = BAKED ? acc_d : acc_d * __int_as_float(r.z);
      int i = acc_i;
      --sp;
      acc_d = st_d[sp];
      acc_i = st_i[sp];
      if (!BAKED) p = st_p[sp];
      fold(((r.x >> 5) & 15) - 1, __int_as_float(r.w), acc_d, acc_i, d, i);
    }
  }
  id = acc_i;
  return acc_d;
}

// march() over a warp's list, its map in mode MAP (GUARDED, or DENSE over
// the staged program).
template <bool BAKED, bool TCULL, int MAP = GUARDED>
__device__ float march_walk(const Scene& S, const int4* __restrict__ list, int n,
                            const float* __restrict__ F, const Guards<TCULL>& g, V3 ro, V3 rd,
                            int& idx, float t_cap = INFINITY) {
  float t = 0.0f;
  float m = kBig;
  if constexpr (TCULL) m = next_entry(S, g, 0.0f);
  idx = -1;
  for (int step = 0; step < kSteps; ++step) {
    int mi;
    float d = map_walk<BAKED, TCULL, TCULL, MAP>(list, n, F, g, v3(ro.x + rd.x * t,
                                                                  ro.y + rd.y * t,
                                                                  ro.z + rd.z * t), t, mi);
    float ad = fabsf(d);
    float nt = TCULL ? t + nan_min(ad, nan_max(m - t, kMhd)) : t + ad;
    nt = nan_min(nt, t_cap);
    bool far = nt > kFar;
    idx = far ? -1 : mi;
    t = nt;
    if (ad < kMhd || far || nt >= t_cap) break;
    if constexpr (TCULL) {
      if (t >= m) m = next_entry(S, g, t);
    }
  }
  return t;
}

// The over-relaxed t-culled march over a warp's list (cast_tcull with omega
// != 1, JAX _march_while_tcull :785-820): an exterior sample steps
// min(omega |d|, clamp); when the unbounding spheres of the last two
// samples stop overlapping (d_prev > 0 and s_prev > d_prev + d, signed) the
// ray reverts to t_prev + f_prev, the exact march's step from the previous
// sample, and a hit needs no such overshoot.
//
// The clamp reads m, the nearest culled entry strictly ahead of t
// (next_entry), kept across steps: with M(t) = next_entry(t), mp = M(tp)
// of the last sample that did not revert, and every new t either t + a
// step (tp = the old t, mp = the old m) or, after a revert, tp + fp, the
// next t satisfies tp <= t < mp only if M(t) = mp: the entries beyond t lie
// beyond tp, so none is below mp, and mp, when an entry, lies beyond t.  So
// m = mp there and next_entry(t) elsewhere (a NaN t included) gives every
// step the M(t) that a call per step gives, and t, idx and every pixel are
// the same bit for bit.  The kept test costs two compares; a call walks the
// ray's hit boxes.
template <bool BAKED>
__device__ float march_relax_walk(const Scene& S, const int4* __restrict__ list, int n,
                                  const float* __restrict__ F, const Guards<true>& g, V3 ro,
                                  V3 rd, int& idx, float omega, float t_cap) {
  float t = 0.0f, tp = 0.0f, dp = 0.0f, sp = 0.0f, fp = 0.0f;
  float m = next_entry(S, g, 0.0f), mp = m;
  idx = -1;
  for (int step = 0; step < kSteps; ++step) {
    int mi;
    float d = map_walk<BAKED, true, true>(list, n, F, g, v3(ro.x + rd.x * t, ro.y + rd.y * t,
                                                            ro.z + rd.z * t), t, mi);
    float ad = fabsf(d);
    float clamp = nan_max(m - t, kMhd);
    float exact = nan_min(ad, clamp);
    bool over = dp > 0.0f && sp > dp + d;
    float stretch = d > 0.0f ? nan_min(omega * ad, clamp) : exact;
    float nt = over ? tp + fp : t + stretch;
    nt = nan_min(nt, t_cap);
    bool hit = !over && ad < kMhd;
    bool far = nt > kFar;
    idx = far ? -1 : mi;
    if (!over) {
      tp = t;
      dp = d;
      sp = stretch;
      fp = exact;
      mp = m;
    } else {
      sp = fp;
    }
    t = nt;
    if (hit || far || nt >= t_cap) break;
    m = tp <= t && t < mp ? mp : next_entry(S, g, t);
  }
  return t;
}

// Debug 4's counters of one warp (megakernel_march.cu STATS), the same in
// every lane: march iterations of the warp (x), guarded shapes evaluated by
// at least one lane per iteration (y), and shapes evaluated by at least one
// lane per normal tap (z, six taps a bounce).
struct WarpStats {
  unsigned steps, shapes, aux;
};

// march_walk() of a warp in lockstep, with debug 4's counters: every lane
// runs the loop while at least one lane of the warp marches (__any_sync
// over the full warp, so the counts do not depend on how the compiler
// reconverges), and a lane that is not live, or done, evaluates nothing.
// With TCULL each iteration adds one to x and walks the list with
// COUNT_BOXED's ballots into y; a live lane's t and idx are march_walk()'s.
// The counters move with TCULL only, as JAX counts in its t-culled march
// only.  live must be the lanes the list was built from, or a subset.
template <bool BAKED, bool TCULL>
__device__ float march_stats_walk(const Scene& S, const int4* __restrict__ list, int n,
                                  const float* __restrict__ F, const Guards<TCULL>& g, V3 ro,
                                  V3 rd, int& idx, float t_cap, bool live, WarpStats& st) {
  float t = 0.0f;
  float m = kBig;
  if constexpr (TCULL) {
    if (live) m = next_entry(S, g, 0.0f);
  }
  idx = -1;
  bool marching = live;
  for (int step = 0; step < kSteps; ++step) {
    if (!__any_sync(kFullWarp, marching)) break;
    const V3 p = v3(ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t);
    int mi;
    float d;
    if constexpr (TCULL) {
      ++st.steps;
      d = map_walk<BAKED, true, true, COUNT_BOXED>(list, n, F, g, p, t, mi, marching,
                                                   &st.shapes);
      if (!marching) continue;
    } else {
      if (!marching) continue;
      d = map_walk<BAKED, false, false>(list, n, F, g, p, t, mi);
    }
    float ad = fabsf(d);
    float nt = TCULL ? t + nan_min(ad, nan_max(m - t, kMhd)) : t + ad;
    nt = nan_min(nt, t_cap);
    bool far = nt > kFar;
    idx = far ? -1 : mi;
    t = nt;
    if (ad < kMhd || far || nt >= t_cap) {
      marching = false;
    } else if constexpr (TCULL) {
      if (t >= m) m = next_entry(S, g, t);
    }
  }
  return t;
}

// calc_grad() over a warp's list: the 6 taps under the full guards, before
// normalisation.  MAP COUNT_ALL counts debug 4's z (live and tally as for
// map_walk).
template <bool BAKED, bool TCULL, int MAP = GUARDED>
__device__ __forceinline__ V3 grad_walk(const int4* __restrict__ list, int n,
                                        const float* __restrict__ F, const Guards<TCULL>& g,
                                        V3 p, bool live = true, unsigned* tally = nullptr) {
  const float e = kNormalEps;
  int id;
  float d[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float off = (k & 1) ? -e : e;
    V3 q = v3(p.x + (k / 2 == 0 ? off : 0.0f), p.y + (k / 2 == 1 ? off : 0.0f),
              p.z + (k / 2 == 2 ? off : 0.0f));
    d[k] = map_walk<BAKED, TCULL, false, MAP>(list, n, F, g, q, 0.0f, id, live, tally);
  }
  return v3(d[0] - d[1], d[2] - d[3], d[4] - d[5]);
}

// calc_normal() over a warp's list.
template <bool BAKED, bool TCULL>
__device__ V3 normal_walk(const int4* __restrict__ list, int n, const float* __restrict__ F,
                          const Guards<TCULL>& g, V3 p) {
  return normalize_safe(grad_walk<BAKED, TCULL>(list, n, F, g, p));
}

// Warp statistics of the grid march (K6's GRID_STATS), per iteration of the
// warp's march loop: [0] iterations (at least one lane still marching),
// [1] those in which some lane took an exact tap, [2] those in which the
// marching lanes took both kinds of step, [3] lane exact taps, [4] lane
// cheap taps.  Full-warp ballots over the lanes still marching, so every
// lane of the warp must call it, and the counts do not depend on how the
// compiler reconverges; lane 0 keeps them.
struct GridStats {
  unsigned long long v[5];
};

__device__ __forceinline__ void grid_stats_add(GridStats& st, bool marching, bool near, int lane) {
  const unsigned act = __ballot_sync(kFullWarp, marching);
  const unsigned nb = __ballot_sync(kFullWarp, near);
  if (lane == 0) {
    const int n_near = __popc(nb), n_act = __popc(act);
    st.v[0] += 1;
    st.v[1] += n_near > 0;
    st.v[2] += n_near > 0 && n_near < n_act;
    st.v[3] += n_near;
    st.v[4] += n_act - n_near;
  }
}

// The distance-grid march of one ray (cast_grid; JAX _march_while_grid with
// the tile reduced to this ray) over a warp's list: each iteration taps the
// grid for g; with g < tau one exact tap of the t-culled map, stepping
// min(|d|, max(m - t, MHD)), else a step of g with no map tap.  Only exact
// taps count against kSteps; at most kSteps + kGridExtraIters iterations.
// A hit needs an exact tap with |d| < MHD.  A cheap step can carry t past
// the nearest interval entry m, so m is re-read before an exact tap
// whenever t >= m.  Returns t, and in idx the id of the last exact tap (-1
// when far or none); a ray still marching when the iterations run out
// takes the id of a map tap under the full guards at its previous t (JAX
// _final_idx).  The grid tap and the near/cheap decision stay per lane; the
// list is read only inside map_walk, which holds no collective.  With
// STATS the warp marches in lockstep: every lane, live or not, runs the
// loop while any lane of the warp marches (a lane not live, or done, taps
// nothing), and grid_stats_add counts each iteration into st; a live
// lane's t and idx are the same as without.
template <bool STATS>
__device__ float march_grid_walk(const Scene& S, const int4* __restrict__ list, int n,
                                 const float* __restrict__ F, const Guards<true>& g,
                                 const Grid& G, V3 ro, V3 rd, int& idx, float t_cap, bool live,
                                 int lane, GridStats& st) {
  float t = 0.0f, tp = 0.0f;
  float m = -INFINITY;
  int last = -1, exact = 0;
  bool marching = live;
  idx = -1;
  for (int it = 0; it < kSteps + kGridExtraIters; ++it) {
    if constexpr (STATS) {
      if (!__any_sync(kFullWarp, marching)) return t;
    }
    const V3 p = v3(ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t);
    const float gv = marching ? grid_tap(G, S.F, p) : 0.0f;
    const bool near = marching && gv < G.tau;
    if constexpr (STATS) grid_stats_add(st, marching, near, lane);
    if (!marching) continue;
    float nt;
    bool hit = false;
    if (near) {
      if (t >= m) m = next_entry(S, g, t);
      int mi;
      const float d = map_walk<true, true, true>(list, n, F, g, p, t, mi);
      const float ad = fabsf(d);
      nt = t + nan_min(ad, nan_max(m - t, kMhd));
      hit = ad < kMhd;
      last = mi;
      ++exact;
    } else {
      nt = t + gv;
    }
    nt = nan_min(nt, t_cap);
    const bool far = nt > kFar;
    idx = far ? -1 : last;
    tp = t;
    t = nt;
    if (hit || far || exact >= kSteps || nt >= t_cap) {
      if constexpr (!STATS) return t;
      marching = false;
    }
  }
  if (marching) {
    map_walk<true, true, false>(list, n, F, g,
                                v3(ro.x + rd.x * tp, ro.y + rd.y * tp, ro.z + rd.z * tp), 0.0f,
                                idx);
  }
  return t;
}

}  // namespace
