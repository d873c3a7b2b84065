// The fused training step: one sample of the frame and the whole per-pixel
// backward of its MSE, one thread per pixel.
//
// Replaces compute_path_tracer_tpu/kernels/train.py:_fused_planes (the
// pallas_call at train.py:1018, kernel body _make_train_kernel at :278).
// Per pixel:
// * phase 1, the bounce loop (train.py:425-692): K2's baked, t-culled march
//   and 6-tap gradient g (csg_program.cuh), or with ANALYTIC K1's closed
//   form (analytic.cuh) and g = n * 2e-4; per bounce the state phase 2
//   needs (ray, t, id, throughput, g, 1/(g.rd), RNG, alive) in thread-local
//   arrays; the shading is K2's scatter, so the image is K1's or K2's frame;
//   with UNBOXED (analytic_unboxed, :314-325, :465-520) the program lacks the
//   eligible guard-less shapes, their closed form caps the march, and a
//   capped hit takes that shape's id and g = n * 2e-4 from its exact normal;
// * phase 2, the reverse sweep (:694-806): the hand-written adjoint of each
//   bounce's shading replay, with the hit distance linearised by the
//   implicit identity t = t* + A.(ro - ro*) + B.(rd - rd*) + t_aux (A =
//   -g/(g.rd), B = A t*), seeded with the MSE's cotangent; in the winner
//   mode (union-only trees) the material cotangent and the partials of the
//   winning leaf in its baked slots, scaled by -dt/(g.rd) (:711-737);
// * with EDGE the primary-silhouette coverage term (:808-864): the closest
//   approach of the exact march of the primary ray, the signed
//   continuation march through the surface it hit (from t = 0 with
//   ANALYTIC), the 6-tap slope and the sigmoid's derivative seed the
//   partials of the nearest leaf, with UNBOXED the march capped and the
//   closed-form closest approach of the skipped spheres folded in
//   (:682-687); with SECONDARY the same per bounce over the
//   exclusion-masked union of leaves (_make_excl_closest, :175; :866-904),
//   which reads every leaf of the full program, the skipped ones included.
// The winner mode reduces every (shape, channel) sum in the kernel: each
// warp adds its lanes' rows into its own copy of the (S, C) accumulator in
// shared memory, one lane after another in lane order; the block sums its
// warps' copies in warp order into its row of `part`; and sum_rows adds the
// blocks' rows in block order.  No float atomics, so the sums repeat bit
// for bit.  The map-vjp mode (other trees) writes the per-bounce segment
// planes for the map vjp in torch, as the JAX kernel leaves it to XLA; its
// secondary rows are reduced like the winner mode's.
//
// What bounds it on an H100: per-thread ALU work and the latency of local
// memory.  Phase 1 is K2's march (or K1's closed form) plus, with EDGE, two
// more marches of the primary ray; phase 2 is a few hundred operations per
// bounce.  A pixel reads 12 bytes of target and writes 12 of image (plus
// the segment planes in the map-vjp mode), so bandwidth is idle.  Each
// thread keeps its per-bounce state (about 90 bytes a bounce) and one
// bounce's guards (2 KB) in local memory, L1-resident for a block of 128
// threads; no global scratch is allocated for it.
//
// Every map tap walks a per-warp list, as K2's (csg_program.cuh): the
// block stages the decoded program and the leaf table in shared memory
// behind the warps' accumulators, and each warp compacts, after each set of
// guards, the records its live lanes can need (build_warp_list) for phase
// 1's march and gradient, the edge term's marches, id tap and slope, and
// the secondary rows' slope; the exclusion march walks its own list of the
// full program's shapes (build_excl_list).  A record left out fails every
// live lane's guard, so every lane folds what it folded, in the same order,
// and every output is what the walk of the whole program gives.  The lists
// are warp collectives, so every lane of a warp runs phase 1 and the edge
// terms to the end, out-of-range and finished lanes as not live.

// Parity with the plain version (kernels/train.py:fused_planes_plain):
// * the forward is K1's or K2's, operation for operation (same flags, see
//   kernels/build.py), so the image equals theirs bit for bit;
// * the adjoint follows the derivative rules of torch's autograd over the
//   plain replay: maximum and minimum split a tie's gradient in halves,
//   clamp passes it at the bound, abs is sign(x) with sign(0) = 0, and a
//   zero vector's normalize_safe and length_safe pass none; the refraction
//   branch is never taken (train.py:check_no_refraction), so its adjoint is
//   left out and channels 12, 14-17 get no cotangent;
// * sums are taken in another order than autograd's, so the gradient
//   agrees to rounding; the edge marches do not cull, per thread or per
//   tile (see the module note of kernels/train.py).

#include "analytic.cuh"
#include "csg_program.cuh"

namespace {

constexpr int kBX = 16;
constexpr int kBY = 8;
constexpr int kThreads = kBX * kBY;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB1 = 16;          // kernels/train.py:MAX_BOUNCES + 1
constexpr int kMatCh = 13;          // kernels/train.py:MAT_CHANNELS
constexpr int kGeomCh = 15;         // render/baked.py:GEOM_CHANNELS
constexpr int kSumGroup = 128;      // block rows summed per thread of sum_rows

constexpr int FLAG_WINNER = 1;
constexpr int FLAG_EDGE = 2;
constexpr int FLAG_SECONDARY = 4;
constexpr int FLAG_ANALYTIC = 8;
constexpr int FLAG_UNBOXED = 16;

constexpr float kDenomEps = 1e-6f;
constexpr float kEdgeStep = 2e-3f;
constexpr float kHalfOverEps = 5000.0f;  // float32(0.5 / 1e-4)
constexpr float kTwoEps = 2e-4f;         // float32(2 * 1e-4)

struct Args {
  Scene S;                  // the baked program; S.F begins with bv
  const int* excl_code;     // the full baked program's ops (the exclusion fold)
  int excl_n_ops;
  const int* leaf_lut;      // (n_shapes, 2): kind, offset of its slots in S.F
  int n_shapes;
  const float* soa_f;       // ANALYTIC: K1's packed tables
  const int* soa_i;
  const int* kmeta;
  const int* sid_lut;
  int n_kinds;
  const float* target;      // (3, crop_h, width)
  float* col;               // (3, crop_h, width)
  float* part;              // (blocks, n_shapes, n_acc) when n_acc > 0
  int n_acc;
  float* seg_ro;            // map-vjp planes (B1P, 3, n) ...
  float* seg_rd;
  float* seg_t;             // (B1P, n)
  int* seg_idx;
  float* seg_scale;
  float* mat_cot;           // (B1, 13, n)
  unsigned long long* walk_stats;  // (3, B1, 2) list lengths and counts, or null
  int width, height, crop_h, row_offset, frame, bounces, flags;
  float fov, aspect, seed_scale, foot1, foot2;
};

// One bounce's state for phase 2.
struct Seg {
  V3 ro, rd, thr, g, ret;   // ret: the radiance before this bounce
  float t, invd, d2, t2;    // d2, t2, i2: the secondary closest approach
  int idx, i2;
  uint32_t rng;
  bool alive;
};

// The share of d max(a, b) that goes to a (torch.maximum's backward), and
// of d min(a, b) (torch.minimum's).
__device__ __forceinline__ float wmax(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}
__device__ __forceinline__ float wmin(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// Adjoint of normalize_safe(v) for the output cotangent oc.
__device__ V3 normalize_adj(V3 v, V3 oc) {
  float l2 = dot(v, v);
  if (!(l2 > 0.0f)) return splat(0.0f);
  float inv = 1.0f / sqrtf(l2);
  float s = dot(oc, v);
  return oc * inv - v * (s * inv * inv * inv);
}

// Adjoint of length_safe(v) for the cotangent c.
__device__ V3 length_adj(V3 v, float c) {
  float l2 = dot(v, v);
  if (!(l2 > 0.0f)) return splat(0.0f);
  return v * (c / sqrtf(l2));
}

__device__ __forceinline__ const float* mat_row(const Scene& S, int idx) {
  return S.F + S.f_mat + kMatSize * idx;
}

// -- phase 2: the adjoint of one bounce's replay (train.py:760-791) ---------
//
// Cotangents in: roc, rdc, thrc of the bounce's outputs (ro2, rd2, thr2) and
// cc of its radiance increment; out: roc, rdc, thrc of its inputs, tc of
// t_aux and mc of the MAT_CHANNELS material channels.  Only for a lane that
// hit (act).
__device__ void replay_adjoint(const Seg& s, const float* __restrict__ mt, V3 cc, V3& roc, V3& rdc,
                               V3& thrc, float& tc, float* mc) {
  float m[kMatSize];
#pragma unroll
  for (int c = 0; c < kMatSize; ++c) m[c] = mt ? mt[c] : 0.0f;
  const V3 m_col = v3(m[0], m[1], m[2]);
  const float bright = m[3];
  const V3 light = v3(m[4], m[5], m[6]);
  const float spec = m[7];
  const V3 spec_col = v3(m[8], m[9], m[10]);
  const float rough = m[11];
  const float refr = m[13];
  const V3 refr_col = v3(m[15], m[16], m[17]);

  // The forward values the adjoint reads (shade_bounce, path_trace).
  const V3 n = normalize_safe(s.g);
  uint32_t rng = s.rng;
  const float r_branch = random_float01(rng);
  const bool do_spec = r_branch < spec;
  const bool do_refr = !do_spec && r_branch < spec + refr;
  const float raw = do_spec ? spec : (do_refr ? refr : 1.0f - spec - refr);
  const float rp = nan_max(raw, 1e-4f);
  const V3 ruv = random_unit_vector(rng);
  const V3 diffuse = normalize_safe(n + ruv);
  const float rr2 = rough * rough;
  const V3 refl = reflect(s.rd, n);
  const V3 mixv = vmix(refl, diffuse, rr2);
  const V3 ln = normalize_safe(light);
  const V3 emit = ln * bright;
  const V3 thr_f = do_spec ? spec_col : (do_refr ? refr_col : m_col);
  const V3 u = s.thr * thr_f;
  const V3 new_thr = u / rp;
  const float myz = nan_max(new_thr.y, new_thr.z);
  const float p_rr = nan_max(new_thr.x, myz);
  const float r_rr = random_float01(rng);
  const bool surv = !(r_rr > p_rr);
  const float inv_p = p_rr > 0.0f ? 1.0f / p_rr : 0.0f;

  // thr2 = surv ? new_thr * inv_p : new_thr, inv_p = 1 / max(new_thr)
  V3 ntc = thrc;
  if (surv) {
    ntc = thrc * inv_p;
    if (p_rr > 0.0f) {
      float pc = -dot(thrc, new_thr) * (inv_p * inv_p);
      ntc.x = ntc.x + pc * wmax(new_thr.x, myz);
      float yzc = pc * wmax(myz, new_thr.x);
      ntc.y = ntc.y + yzc * wmax(new_thr.y, new_thr.z);
      ntc.z = ntc.z + yzc * wmax(new_thr.z, new_thr.y);
    }
  }
  // new_thr = (thr * thr_f) / ray_prob
  const V3 uc = ntc / rp;
  const float rpc = -(ntc.x * u.x / (rp * rp) + ntc.y * u.y / (rp * rp) +
                      ntc.z * u.z / (rp * rp));
  V3 thr_in = uc * thr_f;
  const V3 thr_fc = uc * s.thr;
  // ret_incr = emit * thr
  thr_in = thr_in + cc * emit;
  const V3 emitc = cc * s.thr;

#pragma unroll
  for (int c = 0; c < kMatCh; ++c) mc[c] = 0.0f;
  if (do_spec) {
    mc[8] = thr_fc.x;
    mc[9] = thr_fc.y;
    mc[10] = thr_fc.z;
  } else if (!do_refr) {
    mc[0] = thr_fc.x;
    mc[1] = thr_fc.y;
    mc[2] = thr_fc.z;
  }
  // ray_prob = max(raw, 1e-4): torch's clamp passes the gradient at the bound
  const float rawc = raw >= 1e-4f ? rpc : 0.0f;
  if (do_spec) {
    mc[7] = mc[7] + rawc;
  } else if (do_refr) {
    mc[12] = mc[12] + rawc;
  } else {
    mc[7] = mc[7] - rawc;
    mc[12] = mc[12] - rawc;
  }
  // emit = normalize_safe(light) * brightness
  mc[3] = dot(emitc, ln);
  const V3 lc = normalize_adj(light, emitc * bright);
  mc[4] = lc.x;
  mc[5] = lc.y;
  mc[6] = lc.z;

  // rd2 = new_rd: only the specular direction reads rd and the roughness.
  V3 rd_in = splat(0.0f);
  if (do_spec) {
    const V3 vc = normalize_adj(mixv, rdc);
    const V3 reflc = vc * (1.0f - rr2);
    const float rr2c = dot(vc, diffuse) - dot(vc, refl);
    mc[11] = 2.0f * (rr2c * rough);
    // refl = rd - n * (2 * dot(n, rd))
    rd_in = reflc + n * (-2.0f * dot(n, reflc));
  }
  // ro2 = hit + n * OFFSET, hit = ro + rd * t
  const V3 hitc = roc;
  tc = dot(hitc, s.rd);
  rd_in = rd_in + hitc * s.t;
  // t = t* + A.(ro - ro*) + B.(rd - rd*) + t_aux
  const V3 A = s.g * (-kHalfOverEps * s.invd);
  const V3 B = A * s.t;
  roc = hitc + A * tc;
  rdc = rd_in + B * tc;
  thrc = thr_in;
}

// -- leaf partials (train.py:winner_leaf_channels) ---------------------------
//
// out[0..slots) = seed * d leaf(p) / d slots for one baked leaf
// (render/baked.py:leaf_distance), the rest of out untouched.
__device__ void leaf_partials(int kind, const float* __restrict__ g, V3 p, float seed, float* out) {
  if (kind == KIND_SPHERE) {
    const V3 vc = length_adj(v3(p.x - g[0], p.y - g[1], p.z - g[2]), seed);
    out[0] = -vc.x;
    out[1] = -vc.y;
    out[2] = -vc.z;
    out[3] = -seed;
    return;
  }
  if (kind == KIND_PLANE) {
    out[0] = seed * p.x;
    out[1] = seed * p.y;
    out[2] = seed * p.z;
    out[3] = seed;
    return;
  }
  float q[3], qc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    q[r] = g[3 * r] * p.x + g[3 * r + 1] * p.y + g[3 * r + 2] * p.z + g[9 + r];
  }
  if (kind == KIND_CUBE) {
    // sd_cube: a = |q| - b; |max(a, 0)| + min(max(a.x, max(a.y, a.z)), 0)
    float a[3], ac[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) a[k] = fabsf(q[k]) - g[12 + k];
    const V3 uc = length_adj(v3(nan_max(a[0], 0.0f), nan_max(a[1], 0.0f), nan_max(a[2], 0.0f)),
                             seed);
    ac[0] = uc.x * wmax(a[0], 0.0f);
    ac[1] = uc.y * wmax(a[1], 0.0f);
    ac[2] = uc.z * wmax(a[2], 0.0f);
    const float myz = nan_max(a[1], a[2]);
    const float mc = nan_max(a[0], myz) <= 0.0f ? seed : 0.0f;
    ac[0] = ac[0] + mc * wmax(a[0], myz);
    const float yzc = mc * wmax(myz, a[0]);
    ac[1] = ac[1] + yzc * wmax(a[1], a[2]);
    ac[2] = ac[2] + yzc * wmax(a[2], a[1]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      qc[k] = ac[k] * sign_of(q[k]);
      out[12 + k] = -ac[k];
    }
  } else {
    // sd_octahedron: the branch that wins (x over y over z over linear).
    const float s = g[12];
    const float pa[3] = {fabsf(q[0]), fabsf(q[1]), fabsf(q[2])};
    const float m = pa[0] + pa[1] + pa[2] - s;
    float pac[3] = {0.0f, 0.0f, 0.0f};
    float sc = 0.0f;
    const int which = 3.0f * pa[0] < m ? 0 : (3.0f * pa[1] < m ? 1 : (3.0f * pa[2] < m ? 2 : -1));
    if (which < 0) {
      const float mcc = seed * 0.57735027f;
      pac[0] = mcc;
      pac[1] = mcc;
      pac[2] = mcc;
      sc = -mcc;
    } else {
      const int ix = which, iy = (which + 1) % 3, iz = (which + 2) % 3;
      const float qx = pa[ix], qy = pa[iy], qz = pa[iz];
      const float e = 0.5f * (qz - qy + s);
      const float h = nan_max(e, 0.0f);
      const float k = nan_min(h, s);
      const V3 vc = length_adj(v3(qx, qy - s + k, qz - k), seed);
      float qyc = vc.y, qzc = vc.z;
      sc = -vc.y;
      const float kc = vc.y - vc.z;
      const float hc = kc * wmin(h, s);
      sc = sc + kc * wmin(s, h);
      const float ec = e >= 0.0f ? hc : 0.0f;
      qzc = qzc + 0.5f * ec;
      qyc = qyc - 0.5f * ec;
      sc = sc + 0.5f * ec;
      pac[ix] = vc.x;
      pac[iy] = qyc;
      pac[iz] = qzc;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) qc[k] = pac[k] * sign_of(q[k]);
    out[12] = sc;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    out[3 * r] = qc[r] * p.x;
    out[3 * r + 1] = qc[r] * p.y;
    out[3 * r + 2] = qc[r] * p.z;
    out[9 + r] = qc[r];
  }
}

__device__ __forceinline__ void shape_partials(const Args& A, int sid, V3 p, float seed,
                                               float* out) {
  leaf_partials(A.leaf_lut[2 * sid], A.S.F + A.leaf_lut[2 * sid + 1], p, seed, out);
}

// -- the edge estimator's marches (train.py:175-275, :610-687) ---------------

__device__ __forceinline__ V3 at(V3 ro, V3 rd, float t) {
  return v3(ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t);
}

// The exact march (cast_ray, no t-cull) with its closest approach, capped at
// t_cap, over a warp's list; returns t.
__device__ float march_closest(const int4* __restrict__ list, int n, const float* __restrict__ F,
                               const Guards<true>& g, V3 ro, V3 rd, float t_cap, float& d_min,
                               float& t_min) {
  float t = 0.0f;
  d_min = kBig;
  t_min = 0.0f;
  for (int step = 0; step < kSteps; ++step) {
    int id;
    const float d = map_walk<true, true, false>(list, n, F, g, at(ro, rd, t), t, id);
    if (d < d_min) {
      d_min = d;
      t_min = t;
    }
    const float ad = fabsf(d);
    const float nt = nan_min(t + ad, t_cap);
    t = nt;
    if (ad < kMhd || nt > kFar || nt >= t_cap) break;
  }
  return t;
}

// The signed continuation march from t over a warp's list: floored steps,
// until the ray leaves the first shape it entered, passes FP or takes `cap`
// steps.
__device__ void continue_march(const int4* __restrict__ list, int n, const float* __restrict__ F,
                               const Guards<true>& g, V3 ro, V3 rd, float t, int cap,
                               float& d_min, float& t_min) {
  d_min = kBig;
  t_min = t;
  bool was_neg = false;
  for (int step = 0; step < cap; ++step) {
    int id;
    const float d = map_walk<true, true, false>(list, n, F, g, at(ro, rd, t), t, id);
    if (d < d_min) {
      d_min = d;
      t_min = t;
    }
    const float nt = t + nan_max(fabsf(d), kEdgeStep);
    const bool exited = was_neg && d > 0.0f;
    was_neg = was_neg || d < 0.0f;
    t = nt;
    if (exited || nt > kFar) break;
  }
}

// The warp's list of the exclusion fold: the SHAPE records of the op list
// `code` (the full program's), in walk order, that are guard-less or whose
// box some live lane of the warp hits, decoded as stage_walk decodes them
// (x: OPC_SHAPE | kind << 2 | (box + 1) << 16, y: the slots' offset, z: the
// shape id).  The full program numbers its boxes as the march program does
// (a shape it adds in analytic_unboxed has none; kernels/train.py checks
// it), so the lanes' guard words serve.  A warp collective, as
// build_warp_list; returns the list's length.
__device__ int build_excl_list(const int* __restrict__ code, int n_ops, int n_boxed,
                               const Guards<true>& g, bool live, int4* __restrict__ list,
                               int lane) {
  const uint32_t word_of_lane = warp_box_word(n_boxed, g, live, lane);
  __syncwarp();  // no lane still reads the previous list
  int n = 0;
  for (int base = 0; base < n_ops; base += 32) {
    const int pc = base + lane;
    const int* __restrict__ op = code + OP_WIDTH * min(pc, n_ops - 1);
    const bool shape = pc < n_ops && __ldg(op) == OPC_SHAPE;
    const int box = shape ? __ldg(op + 3) : -1;
    const uint32_t word = __shfl_sync(kFullWarp, word_of_lane, box >= 0 ? box >> 5 : 0);
    const bool keep = shape && (box < 0 || ((word >> (box & 31)) & 1u));
    const uint32_t m = __ballot_sync(kFullWarp, keep);
    if (keep) {
      list[n + __popc(m & ((1u << lane) - 1u))] =
          make_int4(OPC_SHAPE | __ldg(op + 1) << 2 | (box + 1) << 16, __ldg(op + 2), __ldg(op + 4),
                    0);
    }
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// The union of the leaves of an exclusion list without the shapes e1, e2,
// guarded leaves under the bounce's checks (BIG and -1 when none is left).
__device__ float excl_fold(const int4* __restrict__ list, int n, const float* __restrict__ F,
                           const Guards<true>& g, V3 p, int e1, int e2, int& id) {
  float d = kBig;
  id = -1;
  for (int e = 0; e < n; ++e) {
    const int4 r = list[e];
    if (r.z == e1 || r.z == e2) continue;
    const int box = walk_box(r);
    if (box >= 0 && !g.check(box)) continue;
    const float ld = leaf_baked((r.x >> 2) & 7, F + r.y, p);
    if (ld < d) {
      d = ld;
      id = r.z;
    }
  }
  return d;
}

__device__ void excl_closest(const int4* __restrict__ list, int n, const float* __restrict__ F,
                             const Guards<true>& g, V3 ro, V3 rd, int e1, int e2, float t_stop,
                             float& d_min, float& t_min, int& i_min) {
  float t = 0.0f;
  d_min = kBig;
  t_min = 0.0f;
  bool was_neg = false;
  int id;
  for (int step = 0; step < kSteps; ++step) {
    const float d = excl_fold(list, n, F, g, at(ro, rd, t), e1, e2, id);
    if (d < d_min) {
      d_min = d;
      t_min = t;
    }
    const float nt = t + nan_max(fabsf(d), kEdgeStep);
    const bool exited = was_neg && d > 0.0f;
    was_neg = was_neg || d < 0.0f;
    t = nt;
    if (exited || nt > kFar || nt > t_stop) break;
  }
  excl_fold(list, n, F, g, at(ro, rd, t_min), e1, e2, id);
  i_min = d_min < 0.5f * kBig ? id : -1;
}

// The coverage bandwidth's slope factor (train.py:_edge_slope), the normal
// over a warp's list.
__device__ float edge_slope(const int4* __restrict__ list, int n, const float* __restrict__ F,
                            const Guards<true>& g, V3 ro, V3 rd, float t) {
  const V3 nrm = normal_walk<true, true>(list, n, F, g, at(ro, rd, t));
  const float g_par = nrm.x * rd.x + nrm.y * rd.y + nrm.z * rd.z;
  const float perp = sqrtf(nan_max(1.0f - g_par * g_par, 1e-6f));
  return nan_min(nan_max(perp, 0.15f), 1.0f);
}

// -dL.proxy * sigmoid'(z) / beta, z = (MHD - d_min) / beta.
__device__ float coverage_seed(V3 cc, V3 proxy, float d_min, float beta) {
  const float z = (kMhd - d_min) / beta;
  const float cvg = 1.0f / (1.0f + expf(-z));
  const float sig = cvg * (1.0f - cvg);
  return -(cc.x * proxy.x + cc.y * proxy.y + cc.z * proxy.z) * sig / beta;
}

__device__ V3 emission(const float* __restrict__ mt) {
  return normalize_safe(v3(mt[4], mt[5], mt[6])) * mt[3];
}

// -- the deterministic (shape, channel) sums ---------------------------------
//
// Adds each lane's NV values v at channel `off` of row `sid` (none when sid <
// 0) into the warp's (S, C) accumulator, lane after lane in lane order.
// Every lane of the warp must call it.
template <int NV>
__device__ void warp_add(float* __restrict__ acc, int C, int sid, const float* v, int off,
                         int lane) {
  unsigned todo = __ballot_sync(0xffffffffu, sid >= 0);
  while (todo) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1u;
    const int s = __shfl_sync(0xffffffffu, sid, l);
    float mine = 0.0f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float x = __shfl_sync(0xffffffffu, v[c], l);
      if (lane == c) mine = x;
    }
    if (lane < NV) acc[s * C + off + lane] += mine;
  }
}

// -- the kernel ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) train_fused(Args A) {
  extern __shared__ int4 smem[];
  float* sh = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int C = A.n_acc;
  const int SC = A.n_shapes * C;
  for (int j = tid; j < kWarps * SC; j += kThreads) sh[j] = 0.0f;
  __syncthreads();
  float* acc = sh + warp * SC;

  const bool winner = A.flags & FLAG_WINNER;
  const bool edge = A.flags & FLAG_EDGE;
  const bool secondary = A.flags & FLAG_SECONDARY;
  const bool analytic = A.flags & FLAG_ANALYTIC;
  const bool unboxed = A.flags & FLAG_UNBOXED;
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int yl = blockIdx.y * kBY + threadIdx.y;
  const bool valid = x < A.width && yl < A.crop_h;
  const size_t n = (size_t)A.crop_h * A.width;
  const size_t pix = (size_t)yl * A.width + x;
  const int b1 = A.bounces + 1;
  const Scene& S = A.S;

  // The program and its leaf table, staged behind the accumulator, and the
  // warp's exclusion list behind them (fused_smem_bytes); a winner-only
  // analytic step without the edge term maps nothing and stages nothing.
  Walk P{};
  int4* xlist = nullptr;
  if (!analytic || edge) {
    int4* base = smem + (kWarps * SC + 3) / 4;
    P = stage_walk(S, S.f_box, kWarps, base, tid, kThreads);
    xlist = base + walk_smem_bytes(S.n_ops, S.f_box, kWarps) / 16 + warp * A.n_shapes;
  }
  const int4* __restrict__ list = P.lists + warp * P.n_ops;

  Seg seg[kMaxB1];
  Guards<true> g;
  V3 ret = splat(0.0f), ro0 = splat(0.0f), rd0 = splat(0.0f), cc = splat(0.0f);

  // ---- phase 1: the bounce loop, storing each bounce's state ----
  // Every lane of a warp runs it to the end, as not live when out of range
  // or once its path has ended, so that each bounce's lists are built by
  // the whole warp.
  {
    uint32_t rng = 0u;
    V3 ro = splat(0.0f), rd = splat(0.0f);
    if (valid) {
      primary_ray(x, A.row_offset + yl, A.frame, A.width, A.height, A.fov, A.aspect, rng, ro,
                  rd);
    }
    ro0 = ro;
    rd0 = rd;
    V3 thr = splat(1.0f);
    bool alive = valid;
    int idx_prev = -1;
    for (int b = 0; b < b1; ++b) {
      Seg& s = seg[b];
      s.ro = ro;
      s.rd = rd;
      s.thr = thr;
      s.ret = ret;
      s.rng = rng;
      s.alive = alive;
      s.t = 0.0f;
      s.idx = -1;
      s.g = splat(0.0f);
      s.invd = 0.0f;
      s.d2 = kBig;
      s.t2 = 0.0f;
      s.i2 = -1;
      if (!__any_sync(kFullWarp, alive)) continue;
      float t = 0.0f;
      int idx = -1;
      float t_cap = INFINITY;
      int j_cap = -1;
      int len = 0;
      if (analytic) {
        if (alive) cast(A.soa_f, A.soa_i, A.kmeta, A.n_kinds, ro, rd, t, idx);
      } else {
        if (alive) {
          compute_guards(S, ro, rd, g);
          if (unboxed) cap_scan(S, ro, rd, t_cap, j_cap);
        }
        len = build_warp_list(P, S.n_boxed, g, alive, warp, lane);
        record_list(A.walk_stats, b, len, lane);
        if (alive) t = march_walk<true, true>(S, list, len, P.F, g, ro, rd, idx, t_cap);
      }
      bool hit = false;
      V3 hp = splat(0.0f), nrm = splat(0.0f);
      if (alive) {
        hit = !(t > kFar);
        const bool capped = hit && t >= t_cap;
        if (capped) idx = cap_id(S, j_cap);
        s.t = t;
        s.idx = idx;
        hp = ro + rd * t;
        if (hit) {
          if (analytic) {
            nrm = leaf_normal(A.sid_lut[2 * idx], A.soa_f + A.sid_lut[2 * idx + 1], hp);
            s.g = nrm * kTwoEps;
          } else if (capped) {
            s.g = cap_normal(S, j_cap, hp) * kTwoEps;
            nrm = normalize_safe(s.g);
          } else {
            s.g = grad_walk<true, true>(list, len, P.F, g, hp);
            nrm = normalize_safe(s.g);
          }
          const float denom = dot(s.g, rd) * kHalfOverEps;
          s.invd = fabsf(denom) > kDenomEps ? 1.0f / denom : 0.0f;
        }
      }
      if (secondary && b >= 1) {
        if (analytic && alive) compute_guards(S, ro, rd, g);
        const int nx = build_excl_list(A.excl_code, A.excl_n_ops, S.n_boxed, g, alive, xlist, lane);
        record_list(A.walk_stats, 2 * b1 + b, nx, lane);
        if (alive) excl_closest(xlist, nx, P.F, g, ro, rd, idx, idx_prev, t, s.d2, s.t2, s.i2);
      }
      if (!alive) continue;
      idx_prev = idx;
      if (!hit) {
        alive = false;
        continue;
      }
      alive = scatter(rng, ro, rd, ret, thr, hp, nrm, idx >= 0 ? mat_row(S, idx) : nullptr);
    }
    if (valid) {
      A.col[pix] = ret.x;
      A.col[n + pix] = ret.y;
      A.col[2 * n + pix] = ret.z;
      cc = v3((ret.x - A.target[pix]) * A.seed_scale, (ret.y - A.target[n + pix]) * A.seed_scale,
              (ret.z - A.target[2 * n + pix]) * A.seed_scale);
    }
  }

  // ---- phase 2: the reverse sweep, bounce by bounce ----
  V3 roc = splat(0.0f), rdc = splat(0.0f), thrc = splat(0.0f);
  for (int b = b1 - 1; b >= 0; --b) {
    int sid = -1;
    float mc[kMatCh], gc[kGeomCh];
#pragma unroll
    for (int c = 0; c < kMatCh; ++c) mc[c] = 0.0f;
#pragma unroll
    for (int c = 0; c < kGeomCh; ++c) gc[c] = 0.0f;
    if (valid) {
      const Seg& s = seg[b];
      const bool act = s.alive && !(s.t > kFar);
      float scale = 0.0f;
      if (act) {
        float tc;
        replay_adjoint(s, s.idx >= 0 ? mat_row(S, s.idx) : nullptr, cc, roc, rdc, thrc, tc, mc);
        scale = -tc * s.invd;
        if (winner && s.idx >= 0) {
          sid = s.idx;
          shape_partials(A, s.idx, s.ro + s.rd * s.t, scale, gc);
        }
      }
      if (!winner) {
        const size_t r3 = (size_t)b * 3 * n + pix;
        A.seg_ro[r3] = s.ro.x;
        A.seg_ro[r3 + n] = s.ro.y;
        A.seg_ro[r3 + 2 * n] = s.ro.z;
        A.seg_rd[r3] = s.rd.x;
        A.seg_rd[r3 + n] = s.rd.y;
        A.seg_rd[r3 + 2 * n] = s.rd.z;
        A.seg_t[(size_t)b * n + pix] = s.t;
        A.seg_idx[(size_t)b * n + pix] = s.idx;
        A.seg_scale[(size_t)b * n + pix] = scale;
        for (int c = 0; c < kMatCh; ++c) A.mat_cot[((size_t)b * kMatCh + c) * n + pix] = mc[c];
      }
    }
    if (winner) {
      warp_add<kMatCh>(acc, C, sid, mc, 0, lane);
      warp_add<kGeomCh>(acc, C, sid, gc, kMatCh, lane);
    }
  }

  // ---- the primary-silhouette coverage term ----
  if (edge) {
    int sid = -1;
    float gc[kGeomCh];
#pragma unroll
    for (int c = 0; c < kGeomCh; ++c) gc[c] = 0.0f;
    if (valid) compute_guards(S, ro0, rd0, g);
    const int len = build_warp_list(P, S.n_boxed, g, valid, warp, lane);
    record_list(A.walk_stats, b1, len, lane);
    if (valid) {
      float d_min = kBig, t_min = 0.0f, t0 = 0.0f;
      int cap = kSteps + 32;
      bool go = true;
      if (!analytic) {
        float t_cap = INFINITY;
        int j_cap;
        if (unboxed) cap_scan(S, ro0, rd0, t_cap, j_cap);
        t0 = march_closest(list, len, P.F, g, ro0, rd0, t_cap, d_min, t_min);
        go = d_min < kMhd;
        cap = 32;
      }
      if (go) {
        float cd, ct;
        continue_march(list, len, P.F, g, ro0, rd0, t0, cap, cd, ct);
        if (cd < d_min) t_min = ct;
        d_min = nan_min(d_min, cd);
      }
      int id;
      map_walk<true, true, false>(list, len, P.F, g, at(ro0, rd0, t_min), 0.0f, id);
      int i_min = d_min < 0.5f * kBig ? id : -1;
      if (unboxed) {
        // The skipped spheres are in no map tap: their closed-form closest
        // approach.
        float d_ca, t_ca;
        int i_ca;
        closest_scan(S, ro0, rd0, d_ca, t_ca, i_ca);
        if (d_ca < d_min) {
          i_min = i_ca;
          t_min = t_ca;
          d_min = d_ca;
        }
      }
      float w = 0.0f;
      if (i_min >= 0) {
        const float beta =
            nan_max(t_min, 0.2f) * A.foot1 * edge_slope(list, len, P.F, g, ro0, rd0, t_min);
        const V3 proxy = d_min < kMhd ? ret : emission(mat_row(S, i_min));
        w = coverage_seed(cc, proxy, d_min, beta);
      }
      if (winner) {
        if (i_min >= 0 && w != 0.0f) {
          sid = i_min;
          shape_partials(A, i_min, at(ro0, rd0, t_min), w, gc);
        }
      } else {
        const size_t r3 = (size_t)b1 * 3 * n + pix;
        A.seg_ro[r3] = ro0.x;
        A.seg_ro[r3 + n] = ro0.y;
        A.seg_ro[r3 + 2 * n] = ro0.z;
        A.seg_rd[r3] = rd0.x;
        A.seg_rd[r3 + n] = rd0.y;
        A.seg_rd[r3 + 2 * n] = rd0.z;
        A.seg_t[(size_t)b1 * n + pix] = t_min;
        A.seg_idx[(size_t)b1 * n + pix] = i_min;
        A.seg_scale[(size_t)b1 * n + pix] = w;
      }
    }
    if (winner) warp_add<kGeomCh>(acc, C, sid, gc, kMatCh, lane);
  }

  // ---- the secondary coverage rows ----
  if (secondary) {
    for (int b = 1; b < b1; ++b) {
      int sid = -1;
      float gc[kGeomCh];
#pragma unroll
      for (int c = 0; c < kGeomCh; ++c) gc[c] = 0.0f;
      const Seg& s = seg[b];
      const bool row = s.alive && s.i2 >= 0;
      if (__any_sync(kFullWarp, row)) {
        if (row) compute_guards(S, s.ro, s.rd, g);
        const int len = build_warp_list(P, S.n_boxed, g, row, warp, lane);
        record_list(A.walk_stats, b1 + b, len, lane);
        if (row) {
          const float beta =
              nan_max(s.t2, 0.2f) * A.foot2 * edge_slope(list, len, P.F, g, s.ro, s.rd, s.t2);
          const V3 em = emission(mat_row(S, s.i2));
          const V3 prox = v3(s.thr.x * em.x - (ret.x - s.ret.x), s.thr.y * em.y - (ret.y - s.ret.y),
                             s.thr.z * em.z - (ret.z - s.ret.z));
          const float w = coverage_seed(cc, prox, s.d2, beta);
          if (w != 0.0f) {
            sid = s.i2;
            shape_partials(A, s.i2, at(s.ro, s.rd, s.t2), w, gc);
          }
        }
      }
      warp_add<kGeomCh>(acc, C, sid, gc, winner ? kMatCh : 0, lane);
    }
  }

  // The block's row of partial sums, its warps' copies added in warp order.
  if (C > 0) {
    __syncthreads();
    float* row = A.part + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * SC;
    for (int j = tid; j < SC; j += kThreads) {
      float v = sh[j];
      for (int w = 1; w < kWarps; ++w) v += sh[w * SC + j];
      row[j] = v;
    }
  }
}

// out[g][j] = sum of in[r][j] over the rows r of group g, in row order.
__global__ void sum_rows(const float* __restrict__ in, int rows, int cols, int group,
                         float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int gi = blockIdx.y;
  if (j >= cols) return;
  const int r1 = min(rows, (gi + 1) * group);
  float v = 0.0f;
  for (int r = gi * group; r < r1; ++r) v += in[(size_t)r * cols + j];
  out[(size_t)gi * cols + j] = v;
}

// The block's dynamic shared memory (render/program.py:fused_smem_bytes):
// the warps' (S, C) accumulators, acc_floats floats; with the walk, behind
// them from the next 16 bytes, the staged program (walk_smem_bytes) and,
// for the exclusion march, one list of n_excl records a warp.
constexpr size_t fused_smem_bytes(int acc_floats, bool walk, int n_ops, int f_leaf, int n_excl) {
  return walk ? 16 * ((static_cast<size_t>(acc_floats) + 3) / 4) +
                    walk_smem_bytes(n_ops, f_leaf, kWarps) + 16 * kWarps * static_cast<size_t>(n_excl)
              : sizeof(float) * acc_floats;
}

}  // namespace

// Launches the fused step on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not hold.
// `code`, `table` are the baked program's (program_code_on, program_table
// with its t-cull spheres; with the UNBOXED flag the skip program, whose
// n_cap cap records follow its cull flags); excl_code the full baked
// program's ops, which the secondary exclusion fold walks; leaf_lut
// (n_shapes, 2) int32 each shape's kind and slot offset in `table`; soa_f
// .. n_kinds K1's packed tables (with the ANALYTIC flag, else null).
// target and col are (3, crop_h, width) float32 planes; part has room for
// blocks + ceil(blocks / 128) rows of n_shapes * n_acc floats, acc for one
// (n_acc > 0); the six seg_* / mat_cot planes are written in the map-vjp
// mode (flags without WINNER).  smem_bytes must be fused_smem_bytes of the
// launch: the walk is staged unless the step is ANALYTIC without EDGE, and
// SECONDARY (which needs EDGE) adds n_shapes exclusion records a warp.  A
// non-null walk_stats (3 (bounces + 1) x 2 zeroed uint64) takes, as K2's
// does, the summed length and the count of the warps' lists: row b the
// march of bounce b, row B1 the edge term's, row B1 + b the secondary
// slope taps' of bounce b, row 2 B1 + b the exclusion march's.
extern "C" int cpt_train_fused(const int* code, int n_ops, int n_cap, const int* excl_code,
                               int excl_n_ops, const float* table, int n_boxed, int f_box,
                               int f_mat, const int* leaf_lut, int n_shapes,
                               const float* soa_f, const int* soa_i, const int* kmeta,
                               const int* sid_lut, int n_kinds, const float* target, float* col,
                               float* part, float* acc, float* seg_ro, float* seg_rd,
                               float* seg_t, int* seg_idx, float* seg_scale, float* mat_cot,
                               int n_acc, int width, int height, int crop_h, int row_offset,
                               int frame, int bounces, float fov, float aspect, float seed_scale,
                               int flags, float foot1, float foot2, int smem_bytes,
                               unsigned long long* walk_stats, void* stream) {
  if (bounces + 1 > kMaxB1 || bounces < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool edge = flags & FLAG_EDGE, secondary = flags & FLAG_SECONDARY;
  if (secondary && !edge) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fused_smem_bytes(kWarps * n_shapes * n_acc, !(flags & FLAG_ANALYTIC) || edge,
                                       n_ops, f_box, secondary ? n_shapes : 0);
  if (smem != static_cast<size_t>(smem_bytes) || smem > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(train_fused, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Args A;
  A.S = Scene{code, n_ops, table, n_boxed, f_box, f_box + 6 * n_boxed, f_mat,
              code + OP_WIDTH * n_ops + n_boxed, n_cap};
  A.excl_code = excl_code;
  A.excl_n_ops = excl_n_ops;
  A.leaf_lut = leaf_lut;
  A.n_shapes = n_shapes;
  A.soa_f = soa_f;
  A.soa_i = soa_i;
  A.kmeta = kmeta;
  A.sid_lut = sid_lut;
  A.n_kinds = n_kinds;
  A.target = target;
  A.col = col;
  A.part = part;
  A.n_acc = n_acc;
  A.seg_ro = seg_ro;
  A.seg_rd = seg_rd;
  A.seg_t = seg_t;
  A.seg_idx = seg_idx;
  A.seg_scale = seg_scale;
  A.mat_cot = mat_cot;
  A.walk_stats = walk_stats;
  A.width = width;
  A.height = height;
  A.crop_h = crop_h;
  A.row_offset = row_offset;
  A.frame = frame;
  A.bounces = bounces;
  A.flags = flags;
  A.fov = fov;
  A.aspect = aspect;
  A.seed_scale = seed_scale;
  A.foot1 = foot1;
  A.foot2 = foot2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(kBX, kBY);
  dim3 grid((width + kBX - 1) / kBX, (crop_h + kBY - 1) / kBY);
  train_fused<<<grid, block, smem, st>>>(A);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_acc == 0) return static_cast<int>(e);
  const int blocks = static_cast<int>(grid.x * grid.y);
  const int cols = n_shapes * n_acc;
  const int groups = (blocks + kSumGroup - 1) / kSumGroup;
  float* mid = part + (size_t)blocks * cols;
  sum_rows<<<dim3((cols + 127) / 128, groups), 128, 0, st>>>(part, blocks, cols, kSumGroup, mid);
  sum_rows<<<dim3((cols + 127) / 128, 1), 128, 0, st>>>(mid, groups, cols, groups, acc);
  return static_cast<int>(cudaGetLastError());
}
