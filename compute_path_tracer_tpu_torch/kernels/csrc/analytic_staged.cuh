// K1's cast over the scene staged in shared memory (megakernel_analytic.cu):
// the records of render/soa.py:build_staged_layout, each shape's box test
// with the ray's reciprocal direction hoisted out of the shape loop, and
// the nearest closed-form hit with the first-shape clobber.  The closed
// forms and normals are analytic.cuh's; its `cast` over the packed tables
// stays the fused train step's (train_fused.cu).  Everything has internal
// linkage.

#pragma once

#include "analytic.cuh"

namespace {

constexpr int kKinds = 4;        // one group per kind, in kind order
constexpr int kRecHead = 8;      // box lo + guard flag, box hi + shape id
constexpr int kAncWords = 8;     // an ancestor box: lo + valid flag, hi + pad

// render/soa.py:StagedLayout.meta, word for word.
struct StagedMeta {
  int n_words, f_len, mat;
  int n[kKinds], rec[kKinds], stride[kKinds], a[kKinds], gw[kKinds];
};

// -- the quotient with the reciprocal hoisted --------------------------------
//
// Each box test divides by the ray's direction: (box[k] - o[k]) / d[k].  For
// a ray and a table in the range below, the cast computes y = RN(1/d) once
// per axis (__frcp_rn) and each quotient as the tail of div.rn.f32:
//   q0 = RN(x y),  r = RN(x - d q0) (an FMA, exact),  q1 = RN(q0 + r y),
// which is RN(x / d) by Markstein's theorem (Markstein 1990; Muller et al.,
// Handbook of Floating-Point Arithmetic, the FMA-based division theorem): y
// within half an ulp of 1/d and q0 within one ulp of x/d, with no overflow
// or underflow, make r exact and q1 the correctly rounded quotient.  Where
// r == 0, x = d q0 exactly and q0 is the quotient; taking q0 there also
// gives x = -0 its IEEE sign, which q0 + r y (= -0 + +0) would lose.
//
// The range, proved once per ray and once per staged table instead of per
// division: every box word b is 0 or 2^-20 <= |b| <= 2^20 (each block checks
// its table after staging it), and the ray's o[k] likewise, and 2^-20 <=
// |d[k]| <= 2^20.  Then x = RN(b - o) is 0 or a multiple of 2^-43 (both
// operands are), so 2^-43 <= |x| <= 2^21 where it is not 0; |y| lies in
// [2^-20, 2^20] and |q0| in [2^-63, 2^41]; the exact product d q0, within
// a factor 2 of x, is a multiple of ulp(d) ulp(q0) >= |x| 2^-49 >= 2^-92,
// so r, a multiple of 2^-92 where it is not 0, and r y >= 2^-112 are
// normal: nothing underflows or overflows.
// A ray outside the range (a direction component that is 0, subnormal or
// below 2^-20, an origin component below 2^-20 that is not 0) or a table
// outside it takes the plain `/` (div.rn.f32 under -prec-div=true) for the
// whole cast.  chip_smoke.py holds the quotient to __fdiv_rn on 2^24
// seeded triples (b, o, d) and the edge values (megakernel_analytic.cu:
// quotient_check); tests/test_torch_analytic_staged.py holds its plain
// model (render/soa.py:recip_quotient_plain) to x / d.

__device__ __forceinline__ bool recip_range(float v) {
  const float a = fabsf(v);
  return a >= 0x1p-20f && a <= 0x1p20f;
}

__device__ __forceinline__ bool recip_range_or_zero(float v) {
  return v == 0.0f || recip_range(v);
}

__device__ __forceinline__ float recip_quotient(float x, float d, float y) {
  const float q0 = __fmul_rn(x, y);
  const float r = __fmaf_rn(-d, q0, x);
  const float q1 = __fmaf_rn(r, y, q0);
  return r == 0.0f ? q0 : q1;
}

// A ray as the box test reads it: origin, direction and, with FAST, the
// reciprocal direction.
struct BoxRay {
  V3 o, d, y;
};

template <bool FAST>
__device__ __forceinline__ BoxRay box_ray(V3 o, V3 d) {
  BoxRay r{o, d, d};
  if (FAST) r.y = v3(__frcp_rn(d.x), __frcp_rn(d.y), __frcp_rn(d.z));
  return r;
}

template <bool FAST>
__device__ __forceinline__ float box_quotient(float x, float d, float y) {
  return FAST ? recip_quotient(x, d, y) : x / d;
}

template <bool FAST>
__device__ __forceinline__ void slab_axis(float lo, float hi, float o, float d, float y,
                                          float& tn, float& tf) {
  const float ta = box_quotient<FAST>(lo - o, d, y);
  const float tb = box_quotient<FAST>(hi - o, d, y);
  tn = nan_max(tn, nan_min(ta, tb));
  tf = nan_min(tf, nan_max(ta, tb));
}

// common.cuh:slab_box on a staged box (two 16-byte rows), axis by axis in
// its order.
template <bool FAST>
__device__ __forceinline__ bool slab_staged(float4 lo, float4 hi, const BoxRay& r) {
  float tn = -INFINITY, tf = INFINITY;
  slab_axis<FAST>(lo.x, hi.x, r.o.x, r.d.x, r.y.x, tn, tf);
  slab_axis<FAST>(lo.y, hi.y, r.o.y, r.d.y, r.y.y, tn, tf);
  slab_axis<FAST>(lo.z, hi.z, r.o.z, r.d.z, r.y.z, tn, tf);
  return tn < tf && tf > 0.0f;
}

__device__ __forceinline__ bool recip_ray_ok(V3 o, V3 d) {
  return recip_range(d.x) && recip_range(d.y) && recip_range(d.z) &&
         recip_range_or_zero(o.x) && recip_range_or_zero(o.y) && recip_range_or_zero(o.z);
}

// Whether every box word of the staged table is in the range above; each
// thread checks its share of the records, the block agrees.
__device__ bool staged_boxes_ok(const float* S, const StagedMeta& m) {
  bool ok = true;
  for (int k = 0; k < kKinds; ++k) {
    for (int s = threadIdx.x; s < m.n[k]; s += blockDim.x) {
      const float* rec = S + m.rec[k] + m.stride[k] * s;
      for (int b = 0; b <= m.a[k]; ++b) {
        const float* box = b == 0 ? rec : rec + kRecHead + m.gw[k] + kAncWords * (b - 1);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          ok = ok && recip_range_or_zero(box[c]) && recip_range_or_zero(box[4 + c]);
        }
      }
    }
  }
  return __syncthreads_and(ok);
}

// -- the cast -------------------------------------------------------------------

// What a lane of the STATS instantiation counts (launch_megakernel's
// lane_stats), summed over the frame.
enum {
  ST_WARP_CASTS,     // warp iterations that cast (some lane holds a pixel)
  ST_LANE_CASTS,     // lane casts
  ST_WARP_SHAPES,    // per warp cast, the shapes some lane entered
  ST_LANE_SHAPES,    // per lane cast, the shapes it entered
  ST_SLOW_CASTS,     // lane casts that took the plain division
  ST_FIELDS
};

struct Hit {
  float t;
  int sid, off, kind;
};

// The winner's geometry row, from 16-byte rows of the record into registers.
template <int KIND>
__device__ __forceinline__ float staged_leaf_t(const float* __restrict__ rec, V3 ro, V3 rd) {
  constexpr int W = (KIND == KIND_CUBE || KIND == KIND_OCTAHEDRON) ? 16 : 4;
  float g[W];
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(rec + kRecHead)[q];
    g[4 * q] = v.x;
    g[4 * q + 1] = v.y;
    g[4 * q + 2] = v.z;
    g[4 * q + 3] = v.w;
  }
  return leaf_t<KIND>(g, ro, rd);
}

// Nearest member of one kind group, walked in walk order with a strict <
// (analytic.cuh:fold_kind over the staged records), then the lexicographic
// (t, shape id) combine into `best`.  `mask` holds the lanes casting with
// this FAST (STATS only).
template <int KIND, bool FAST, bool STATS>
__device__ __forceinline__ void fold_staged(const float* __restrict__ S, const StagedMeta& m,
                                            const BoxRay& br, V3 ro, V3 rd, Hit& best,
                                            unsigned mask, unsigned long long* st) {
  const int n = m.n[KIND], stride = m.stride[KIND], a = m.a[KIND];
  const int anc0 = kRecHead + m.gw[KIND];
  float t_k = kBig;
  int s_k = kSidNone, o_k = 0;
  int off = m.rec[KIND];
  for (int s = 0; s < n; ++s, off += stride) {
    const float4 lo = *reinterpret_cast<const float4*>(S + off);
    const float4 hi = *reinterpret_cast<const float4*>(S + off + 4);
    bool incl = __float_as_int(lo.w) == 0 || slab_staged<FAST>(lo, hi, br);
    for (int j = 0; j < a && incl; ++j) {
      const float* anc = S + off + anc0 + kAncWords * j;
      const float4 alo = *reinterpret_cast<const float4*>(anc);
      const float4 ahi = *reinterpret_cast<const float4*>(anc + 4);
      if (__float_as_int(alo.w) != 0 && slab_staged<FAST>(alo, ahi, br)) incl = false;
    }
    if (STATS) {
      const unsigned entered = __ballot_sync(mask, incl);
      if ((threadIdx.x & 31) == __ffs(mask) - 1 && entered) ++st[ST_WARP_SHAPES];
      st[ST_LANE_SHAPES] += incl;
    }
    if (!incl) continue;
    const float t = staged_leaf_t<KIND>(S + off, ro, rd);
    if (t < t_k) {
      t_k = t;
      s_k = __float_as_int(hi.w);
      o_k = off;
    }
  }
  if (t_k < best.t || (t_k == best.t && s_k < best.sid)) best = Hit{t_k, s_k, o_k, KIND};
}

template <bool FAST, bool STATS>
__device__ Hit cast_staged(const float* __restrict__ S, const StagedMeta& m, V3 ro, V3 rd,
                           unsigned mask, unsigned long long* st) {
  const BoxRay br = box_ray<FAST>(ro, rd);
  Hit best{kBig, kSidNone, 0, 0};
  fold_staged<KIND_SPHERE, FAST, STATS>(S, m, br, ro, rd, best, mask, st);
  fold_staged<KIND_CUBE, FAST, STATS>(S, m, br, ro, rd, best, mask, st);
  fold_staged<KIND_PLANE, FAST, STATS>(S, m, br, ro, rd, best, mask, st);
  fold_staged<KIND_OCTAHEDRON, FAST, STATS>(S, m, br, ro, rd, best, mask, st);
  return best;
}

}  // namespace
