// Sphere-marched progressive path-traced frame of any CSG scene, one thread
// per pixel.
//
// Replaces compute_path_tracer_tpu/kernels/megakernel.py:_pallas_frame_planes
// in its marching modes (the pallas_call at megakernel.py:1546, kernel body
// _make_kernel at :1198): per pixel the wang-hash RNG, AA jitter and primary
// ray, then bounces+1 iterations of AABB guards, the 80-step sphere march
// (_march_while :979 = cast_ray, or _march_while_tcull :625 per thread),
// the 6-tap central-difference normal, the 18-channel material, shade_bounce
// and Russian roulette; or, for debug 1 and 2, one march and the normal tint
// or the albedo (:1407-1443).  The result overwrites (debug 1-3) or is
// averaged into (debug 0) the (H, W, 3) float32 accumulator.
//
// What bounds it on an H100: per-thread ALU work and the latency of uniform
// table loads.  Every march step evaluates the whole CSG program (about 64
// leaf SDFs of 10-40 flops on the benchmark scene, times up to 80 steps and
// 9 bounces, plus 6 normal taps per hit), against ~25 MB of accumulator
// traffic per 1080p frame, so memory bandwidth is idle.  The design keeps the
// per-ray state in registers, reads the program and its table with loads
// that are uniform across a warp (one transaction, L1-resident: about 2 KB
// of ops and 4-6 KB of floats at 64 shapes), and lets a guarded leaf be
// skipped by the lanes whose guard fails, a whole warp at once when no lane
// needs it.  The guard bits and t-cull intervals live in per-thread local
// memory, touched only for the boxes a ray hits.
//
// A program, not generated code: the CSG tree arrives as the int32 op list
// of render/program.py (ENTER / SHAPE / LEAVE records) and its per-frame
// float table, interpreted with a per-thread stack of union frames, so one
// compiled kernel serves every scene and a structure edit costs no compile.
// Opcodes are the same for every thread, so their branches do not diverge;
// only the guard tests do.
//
// Parity decisions (render/program.py's interpreter and march, and the JAX
// package, are the references):
// * The flags and the shared helpers are K1's (common.cuh, notes in
//   megakernel_analytic.cu): no FMA contraction, IEEE division and square
//   root, NaN-propagating min/max, the bit-exact RNG.
// * Faithful geometry reads each node's cos/sin from the table, computed
//   once per frame by torch, so the kernel and the plain version apply the
//   same rotation; p*inv - pos*inv and the rotation keep the operation order
//   of apply_transform and rot3d (render/scenegen.py, ops/sdf.py).
// * Tie rules of the fold: a union keeps the accumulator on acc < d, a
//   subtraction on -acc >= d, a smooth union's id on h > 0.5; the first shape
//   of a union assigns; a failed guard leaves the accumulator untouched,
//   first shape included (containers.rs:244-252, 419-437).
// * The exact march is cast_ray step for step: t += |d|, a hit at |d| < MHD,
//   far (id -1) once t > FP, the id of the last map tap.  t_cull is
//   _march_while_tcull with the tile reduced to this one ray, on the
//   shapes whose value reaches the scene through min folds alone
//   (program.py:box_cull): such a shape is in the map while the ray's
//   interval through its bounding sphere holds t, and the nearest interval
//   ahead clamps the step to max(entry - t, MHD).  The nearest entry is
//   recomputed only when t reaches it: it cannot change before.
// * Normals take 6 map taps under the bounce's full guards, also with
//   t_cull; the debug-1 tint adds 0.1 per AABB hit in walk order.

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

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;

struct Scene {
  const int* code;     // n_ops records of OP_WIDTH, then box_cull
  int n_ops;
  const float* F;      // program_table
  int n_boxed, f_box, f_sph, f_mat;
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

// The scene map at p: interprets the program.  With CULLED a guarded shape
// marked in box_cull is evaluated only while its interval holds t.
template <bool BAKED, bool TCULL, bool CULLED>
__device__ float map_scene(const Scene& S, const Guards<TCULL>& g, V3 p, float t, int& id) {
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

// The 80-step march of one ray (cast_ray, or cast_tcull with TCULL);
// returns t, and the id of the last map tap in idx (-1 when far).
template <bool BAKED, bool TCULL>
__device__ float march(const Scene& S, const Guards<TCULL>& g, V3 ro, V3 rd, int& idx) {
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
    bool far = nt > kFar;
    idx = far ? -1 : mi;
    t = nt;
    if (ad < kMhd || far) break;
    if constexpr (TCULL) {
      if (t >= m) m = next_entry(S, g, t);
    }
  }
  return t;
}

// Central-difference normal, 6 taps under the bounce's full guards
// (calc_normal, funcs.glsl:21-35).
template <bool BAKED, bool TCULL>
__device__ V3 calc_normal(const Scene& S, const Guards<TCULL>& g, V3 p) {
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
  return normalize_safe(v3(d[0] - d[1], d[2] - d[3], d[4] - d[5]));
}

template <bool BAKED, bool TCULL>
__global__ void __launch_bounds__(kBlockX * kBlockY)
megakernel_march(Scene S, float* __restrict__ accum, int width, int height, int frame,
                 int last_clear, int bounces, float fov, float aspect, int debug) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= width || y >= height) return;

  uint32_t rng;
  V3 ro, rd;
  primary_ray(x, y, frame, width, height, fov, aspect, rng, ro, rd);
  Guards<TCULL> g;
  V3 col;

  if (debug == 1 || debug == 2) {
    float dbg = compute_guards(S, ro, rd, g);
    int idx;
    float t = march<BAKED, TCULL>(S, g, ro, rd, idx);
    if (debug == 1) {
      // normals + AABB tint (test_compute.glsl:170-179)
      if (t > kFar) {
        col = splat(dbg);
      } else {
        V3 n = calc_normal<BAKED, TCULL>(S, g, ro + rd * t);
        col = (normalize_safe(n) * 0.5f + splat(0.5f)) * 0.2f + splat(dbg);
      }
    } else {
      // first-hit albedo (test_compute.glsl:183-195)
      const float* mt = S.F + S.f_mat + kMatSize * idx;
      col = idx >= 0 ? v3(mt[0], mt[1], mt[2]) : splat(0.0f);
    }
  } else {
    V3 ret = v3(0.0f, 0.0f, 0.0f);
    V3 thr = v3(1.0f, 1.0f, 1.0f);
    int i_exit = -1;
    for (int i = 0; i <= bounces; ++i) {
      compute_guards(S, ro, rd, g);
      int idx;
      float t = march<BAKED, TCULL>(S, g, ro, rd, idx);
      if (t > kFar) {
        i_exit = i;
        break;
      }
      V3 hit = ro + rd * t;
      V3 n = calc_normal<BAKED, TCULL>(S, g, hit);
      const float* mt = idx >= 0 ? S.F + S.f_mat + kMatSize * idx : nullptr;
      if (!scatter(rng, ro, rd, ret, thr, hit, n, mt)) {
        i_exit = i;
        break;
      }
    }
    if (i_exit < 0) i_exit = bounces + 1;
    // debug 3: the bounce heatmap (test_compute.glsl:163).
    col = debug == 3 ? splat((float)i_exit / (float)bounces) : ret;
  }
  write_pixel(accum, x, y, width, col, last_clear, debug);
}

template <bool BAKED, bool TCULL>
void launch(const Scene& S, float* accum, int width, int height, int frame, int last_clear,
            int bounces, float fov, float aspect, int debug, cudaStream_t stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY);
  megakernel_march<BAKED, TCULL><<<grid, block, 0, stream>>>(
      S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug);
}

}  // namespace

// Launches one frame on `stream`; returns cudaGetLastError() (0 on success).
// `code` is program_code_on's int32 vector (n_ops op records, then n_boxed
// cull flags), `table` program_table's float32 vector; accum is (height,
// width, 3) float32, contiguous, updated in place.  The caller checks the
// program against kMaxDepth and kMaxBoxed.
extern "C" int cpt_megakernel_march(const int* code, int n_ops, const float* table,
                                    int n_boxed, int f_box, int f_mat, int baked,
                                    int t_cull, float* accum, int width, int height,
                                    int frame, int last_clear, int bounces, float fov,
                                    float aspect, int debug, void* stream) {
  Scene S{code, n_ops, table, n_boxed, f_box, f_box + 6 * n_boxed, f_mat};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (baked) {
    if (t_cull) {
      launch<true, true>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, st);
    } else {
      launch<true, false>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, st);
    }
  } else if (t_cull) {
    launch<false, true>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, st);
  } else {
    launch<false, false>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, st);
  }
  return static_cast<int>(cudaGetLastError());
}
