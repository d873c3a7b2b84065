// Full-analytic progressive path-traced frame, one thread per pixel.
//
// Replaces compute_path_tracer_tpu/kernels/megakernel.py:_pallas_frame_planes
// in its analytic_all mode (the pallas_call at megakernel.py:1546, kernel
// body _make_kernel with _make_analytic_all): per pixel the wang-hash RNG,
// AA jitter and primary ray, then bounces+1 iterations of AABB membership
// (with the first-shape clobber), the closed-form nearest hit over every
// leaf, the exact normal, the 18-channel material, shade_bounce and Russian
// roulette, and finally the running mean accum*(1-w) + col*w written in
// place into the (H, W, 3) float32 accumulator.
//
// What bounds it on an H100: per-thread ALU work.  Each live bounce tests
// every shape of the scene in closed form (64 shapes x up to 9 bounces per
// pixel on the benchmark scene: a slab test of ~25 flops plus a hit test of
// 20-90 flops each), against ~25 MB of accumulator traffic per 1080p frame
// (2.07 M pixels x 12 bytes read and written), so the memory system is idle
// and the FP32 pipes and branch divergence set the time.  The design keeps
// every per-ray value in registers, reads the scene from small packed
// tables (render/soa.py, about 12 KB at 64 shapes) that stay resident in L1
// under uniform warp-wide loads, and lets each thread leave its bounce loop
// as soon as its ray dies.  Culling whole warps of shapes, staging the
// tables in shared memory and tuning the block shape are later work.
//
// Tables, not generated code: the kind groups, shape rows and material rows
// come from the tables that pack_soa_smem builds, read at run time, so one
// compiled kernel serves every union-only scene.  kmeta holds one record of
// KM_FIELDS ints per kind group; sid_lut maps a shape id to its kind and the
// f32 offset of its geometry row, so the normal and the material are indexed
// loads of the winner's row.
//
// Parity decisions (the plain torch version in render/soa.py and
// render/reference.py, and the JAX package, are the references):
// * Built with -fmad=false -prec-div=true -prec-sqrt=true -ftz=false (see
//   kernels/build.py) and never --use_fast_math: no a*b+c is contracted into
//   an FMA, so the slab and quadratic arithmetic rounds like the plain
//   version, op by op.
// * nan_min / nan_max propagate NaN like jnp.minimum and torch.minimum;
//   fminf/fmaxf would drop it.  In the AABB slab test, (lo - o)/d is 0/0 =
//   NaN for an axis-parallel ray starting on a box face, and the reference
//   semantics make that ray miss the box.
// * sign_of(0) == 0 as jnp.sign; copysignf would give +-1 on cube and
//   octahedron normals.
// * normalize_safe is x * (1/sqrtf(l2)), not rsqrtf.  sqrtf, cosf, sinf are
//   the full-precision versions; cosf/sinf can still differ from the CPU's by
//   an ulp, which flips RNG-driven branches at isolated pixels, so images are
//   compared by the share of pixels that differ, not elementwise.
// * gen_rng scales the integer pixel coordinate in float32 and truncates,
//   as the JAX version does; the RNG is the wang hash in uint32_t, bit-exact,
//   and random_float01 is __uint2float_rn(s) * 2^-32, which rounds like the
//   JAX version's two-halves split.
// * Sentinels: BIG = 4*FP = 400 for "no hit"; SID_NONE = 2^30 for "no
//   shape"; the tables' pad rows (id -2, a degenerate lo=hi=0 box) are
//   never walked.  The sphere takes the exit root from inside; planes reject
//   |denom| <= 1e-12.
// * Each thread stops its loop when its ray dies (path_trace's per-lane
//   semantics); the TPU kernel's whole-tile exit changes no live pixel.

#include "common.cuh"

namespace {

constexpr int kSidNone = 1 << 30;

// kmeta record: kind, n, w, a, f_geom, f_aabb, f_anc, i_sid, i_guard,
// i_anc_valid (render/soa.py:SmemKind).  Only the n real rows of a kind are
// walked; the pad rows that keep the tables equal to the JAX package's are
// skipped.
constexpr int KM_FIELDS = 10;

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;

// -- closed-form hits (megakernel.py:_leaf_analytic_t_slots) ------------------

// Nearest hit of |oq_k + t dq_k| <= b_k: exit face from inside, BIG on a miss.
template <int N>
__device__ __forceinline__ float slab_polytope_t(const float* oq, const float* dq, const float* b) {
  float lo = -kBig, hi = kBig;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    bool ok = fabsf(dq[k]) > 1e-9f;
    float inv = 1.0f / (ok ? dq[k] : 1.0f);
    float ta = (-b[k] - oq[k]) * inv;
    float tb = (b[k] - oq[k]) * inv;
    float axlo = nan_min(ta, tb);
    float axhi = nan_max(ta, tb);
    if (!ok) {
      bool inside = fabsf(oq[k]) <= b[k];
      axlo = inside ? -kBig : kBig;
      axhi = inside ? kBig : -kBig;
    }
    lo = nan_max(lo, axlo);
    hi = nan_min(hi, axhi);
  }
  bool hit = lo <= hi && hi > 0.0f;
  return hit ? (lo > 0.0f ? lo : hi) : kBig;
}

__device__ __forceinline__ void leaf_frame(const float* __restrict__ g, V3 ro, V3 rd,
                                           float* oq, float* dq) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    oq[r] = g[3 * r] * ro.x + g[3 * r + 1] * ro.y + g[3 * r + 2] * ro.z + g[9 + r];
    dq[r] = g[3 * r] * rd.x + g[3 * r + 1] * rd.y + g[3 * r + 2] * rd.z;
  }
}

template <int KIND>
__device__ __forceinline__ float leaf_t(const float* __restrict__ g, V3 ro, V3 rd) {
  if (KIND == KIND_SPHERE) {
    float ocx = ro.x - g[0], ocy = ro.y - g[1], ocz = ro.z - g[2];
    float r = g[3];
    float b = ocx * rd.x + ocy * rd.y + ocz * rd.z;
    float c = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
    float disc = b * b - c;  // |rd| == 1
    if (!(disc >= 0.0f)) return kBig;
    float root = sqrtf(disc);
    float t0 = -b - root;
    float t1 = -b + root;
    return t0 > 0.0f ? t0 : (t1 > 0.0f ? t1 : kBig);
  } else if (KIND == KIND_PLANE) {
    float denom = g[0] * rd.x + g[1] * rd.y + g[2] * rd.z;
    float f0 = g[0] * ro.x + g[1] * ro.y + g[2] * ro.z + g[3];
    float t = fabsf(denom) > 1e-12f ? -f0 / denom : kBig;
    return t > 0.0f ? t : kBig;
  } else if (KIND == KIND_CUBE) {
    float oq[3], dq[3];
    leaf_frame(g, ro, rd, oq, dq);
    return slab_polytope_t<3>(oq, dq, g + 12);
  } else {
    // Octahedron |x|+|y|+|z| <= s as 4 diagonal slab pairs.
    float oq[3], dq[3];
    leaf_frame(g, ro, rd, oq, dq);
    const float sy[4] = {1.0f, 1.0f, -1.0f, -1.0f};
    const float sz[4] = {1.0f, -1.0f, 1.0f, -1.0f};
    float oqs[4], dqs[4], s4[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      oqs[k] = 1.0f * oq[0] + sy[k] * oq[1] + sz[k] * oq[2];
      dqs[k] = 1.0f * dq[0] + sy[k] * dq[1] + sz[k] * dq[2];
      s4[k] = g[12];
    }
    return slab_polytope_t<4>(oqs, dqs, s4);
  }
}

// Nearest member of one kind group, walked in walk order with a strict <
// so that an equal t keeps the earlier shape.
template <int KIND>
__device__ void fold_kind(const float* __restrict__ F, const int* __restrict__ I,
                          const int* __restrict__ m, V3 ro, V3 rd, float& t_k, int& s_k) {
  const int n = m[1], w = m[2], a = m[3];
  const int f_geom = m[4], f_aabb = m[5], f_anc = m[6];
  const int i_sid = m[7], i_guard = m[8], i_anc_valid = m[9];
  for (int s = 0; s < n; ++s) {
    bool incl = I[i_guard + s] == 0 || slab_box(F + f_aabb + 6 * s, ro, rd);
    for (int j = 0; j < a && incl; ++j) {
      if (I[i_anc_valid + s * a + j] != 0 && slab_box(F + f_anc + 6 * (s * a + j), ro, rd)) {
        incl = false;
      }
    }
    if (!incl) continue;
    float t = leaf_t<KIND>(F + f_geom + s * w, ro, rd);
    if (t < t_k) {
      t_k = t;
      s_k = I[i_sid + s];
    }
  }
}

__device__ void cast(const float* __restrict__ F, const int* __restrict__ I,
                     const int* __restrict__ kmeta, int n_kinds, V3 ro, V3 rd,
                     float& t_out, int& idx_out) {
  float t_best = kBig;
  int sid_best = kSidNone;
  for (int k = 0; k < n_kinds; ++k) {
    const int* m = kmeta + KM_FIELDS * k;
    float t_k = kBig;
    int s_k = kSidNone;
    switch (m[0]) {
      case KIND_SPHERE: fold_kind<KIND_SPHERE>(F, I, m, ro, rd, t_k, s_k); break;
      case KIND_CUBE: fold_kind<KIND_CUBE>(F, I, m, ro, rd, t_k, s_k); break;
      case KIND_PLANE: fold_kind<KIND_PLANE>(F, I, m, ro, rd, t_k, s_k); break;
      default: fold_kind<KIND_OCTAHEDRON>(F, I, m, ro, rd, t_k, s_k); break;
    }
    // Lexicographic (t, shape id): walk-order ties across kind groups.
    if (t_k < t_best || (t_k == t_best && s_k < sid_best)) {
      t_best = t_k;
      sid_best = s_k;
    }
  }
  t_out = t_best;
  idx_out = sid_best == kSidNone ? -1 : sid_best;
}

// -- exact normals (megakernel.py:_leaf_analytic_normal_slots) ----------------

__device__ V3 leaf_normal(int kind, const float* __restrict__ g, V3 p) {
  if (kind == KIND_SPHERE) return normalize_safe(v3(p.x - g[0], p.y - g[1], p.z - g[2]));
  if (kind == KIND_PLANE) return v3(g[0], g[1], g[2]);
  float q[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    q[r] = g[3 * r] * p.x + g[3 * r + 1] * p.y + g[3 * r + 2] * p.z + g[9 + r];
  }
  float nl[3];
  if (kind == KIND_CUBE) {
    // Hit face = axis where |q| reaches its half-extent, signed by q.
    float r0 = fabsf(q[0]) - g[12];
    float r1 = fabsf(q[1]) - g[13];
    float r2 = fabsf(q[2]) - g[14];
    bool ax0 = r0 >= r1 && r0 >= r2;
    bool ax1 = !ax0 && r1 >= r2;
    nl[0] = ax0 ? sign_of(q[0]) : 0.0f;
    nl[1] = ax1 ? sign_of(q[1]) : 0.0f;
    nl[2] = (ax0 || ax1) ? 0.0f : sign_of(q[2]);
  } else {
    // Hit face = diagonal slab whose |value| reaches s, signed by it.
    const float sy[4] = {1.0f, 1.0f, -1.0f, -1.0f};
    const float sz[4] = {1.0f, -1.0f, 1.0f, -1.0f};
    float best = -kBig;
    nl[0] = nl[1] = nl[2] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v = 1.0f * q[0] + sy[k] * q[1] + sz[k] * q[2];
      float r = fabsf(v) - g[12];
      if (r > best) {
        best = r;
        float sg = sign_of(v);
        nl[0] = sg * 1.0f;
        nl[1] = sg * sy[k];
        nl[2] = sg * sz[k];
      }
    }
  }
  // World normal = Mw^T n_leaf (Mw orthonormal).
  return normalize_safe(v3(g[0] * nl[0] + g[3] * nl[1] + g[6] * nl[2],
                           g[1] * nl[0] + g[4] * nl[1] + g[7] * nl[2],
                           g[2] * nl[0] + g[5] * nl[1] + g[8] * nl[2]));
}

// -- kernel ---------------------------------------------------------------------

__global__ void __launch_bounds__(kBlockX * kBlockY)
megakernel_analytic(const float* __restrict__ F, const int* __restrict__ I,
                    const int* __restrict__ kmeta, int n_kinds,
                    const int* __restrict__ sid_lut, int f_mat,
                    float* __restrict__ accum, int width, int height, int frame,
                    int last_clear, int bounces, float fov, float aspect, int debug) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= width || y >= height) return;

  uint32_t rng;
  V3 ro, rd;
  primary_ray(x, y, frame, width, height, fov, aspect, rng, ro, rd);

  V3 ret = v3(0.0f, 0.0f, 0.0f);
  V3 thr = v3(1.0f, 1.0f, 1.0f);
  int i_exit = -1;
  for (int i = 0; i <= bounces; ++i) {
    float t;
    int idx;
    cast(F, I, kmeta, n_kinds, ro, rd, t, idx);
    if (t > kFar) {
      i_exit = i;
      break;
    }
    V3 hit = ro + rd * t;
    V3 n = leaf_normal(sid_lut[2 * idx], F + sid_lut[2 * idx + 1], hit);
    if (!scatter(rng, ro, rd, ret, thr, hit, n, F + f_mat + kMatSize * idx)) {
      i_exit = i;
      break;
    }
  }
  if (i_exit < 0) i_exit = bounces + 1;
  // debug 3: the bounce heatmap (test_compute.glsl:163).
  V3 col = debug == 3 ? splat((float)i_exit / (float)bounces) : ret;
  write_pixel(accum, x, y, width, col, last_clear, debug);
}

}  // namespace

// Launches one frame on `stream`; returns cudaGetLastError() (0 on success).
// Pointers are device pointers; accum is (height, width, 3) float32,
// contiguous, updated in place.
extern "C" int cpt_megakernel_analytic(const float* soa_f, const int* soa_i,
                                       const int* kmeta, int n_kinds,
                                       const int* sid_lut, int f_mat, float* accum,
                                       int width, int height, int frame, int last_clear,
                                       int bounces, float fov, float aspect, int debug,
                                       void* stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY);
  megakernel_analytic<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      soa_f, soa_i, kmeta, n_kinds, sid_lut, f_mat, accum, width, height, frame,
      last_clear, bounces, fov, aspect, debug);
  return static_cast<int>(cudaGetLastError());
}
