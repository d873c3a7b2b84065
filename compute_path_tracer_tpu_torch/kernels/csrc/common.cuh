// Device code shared by the megakernels (megakernel_analytic.cu,
// megakernel_march.cu): vec3 math, the wang-hash RNG, the camera ray, the
// AABB slab test, the shading of one hit with Russian roulette, and the
// accumulator write.  Each function follows its plain torch version
// (render/reference.py, ops/) operation by operation; see the parity notes
// in megakernel_analytic.cu.  Everything has internal linkage, so each
// kernel's translation unit carries its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kFar = 100.0f;          // constants.FP
constexpr float kBig = 4.0f * kFar;     // closed-form "no hit"
constexpr float kOffset = 0.03f;        // constants.OFFSET
constexpr float kPi2 = 6.283185307179586f;

constexpr int KIND_SPHERE = 0;
constexpr int KIND_CUBE = 1;
constexpr int KIND_PLANE = 2;
constexpr int KIND_OCTAHEDRON = 3;

constexpr int kMatSize = 18;            // constants.MAT_SIZE

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 splat(float s) { return {s, s, s}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

__device__ __forceinline__ V3 normalize_safe(V3 v) {
  float l2 = dot(v, v);
  float inv = l2 > 0.0f ? 1.0f / sqrtf(l2) : 0.0f;
  return v * inv;
}

// GLSL mix(a, b, t) = a*(1-t) + b*t.
__device__ __forceinline__ V3 vmix(V3 a, V3 b, float t) {
  float u = 1.0f - t;
  return {a.x * u + b.x * t, a.y * u + b.y * t, a.z * u + b.z * t};
}

// GLSL reflect(I, N) = I - N * (2 * dot(N, I)).
__device__ __forceinline__ V3 reflect(V3 i, V3 n) { return i - n * (2.0f * dot(n, i)); }

// NaN-propagating min/max (jnp.minimum / torch.minimum semantics).
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
}

// -- RNG (ops/rng.py, rng.glsl:1-36) ------------------------------------------

__device__ __forceinline__ uint32_t wang_hash(uint32_t s) {
  s = (s ^ 61u) ^ (s >> 16);
  s = s * 9u;
  s = s ^ (s >> 4);
  s = s * 0x27D4EB2Du;
  s = s ^ (s >> 15);
  return s;
}

__device__ __forceinline__ float random_float01(uint32_t& s) {
  s = wang_hash(s);
  return __uint2float_rn(s) * 0x1p-32f;
}

__device__ __forceinline__ V3 random_unit_vector(uint32_t& s) {
  float r1 = random_float01(s);
  float r2 = random_float01(s);
  float z = r1 * 2.0f - 1.0f;
  float a = r2 * kPi2;
  float r = sqrtf(1.0f - z * z);
  return {r * cosf(a), r * sinf(a), z};
}

__device__ __forceinline__ uint32_t gen_rng(int x, int y, int frame, int width, int height) {
  float fx = ((float)x * 0.5f + 0.5f) * (float)width;
  float fy = ((float)y * 0.5f + 0.5f) * (float)height;
  uint32_t seed = (uint32_t)(int)fx * 1973u + (uint32_t)(int)fy * 9277u +
                  (uint32_t)frame * 26699u;
  return seed | 1u;
}

// Per-pixel RNG, AA jitter and primary ray (test_compute.glsl:218-235).
__device__ __forceinline__ void primary_ray(int x, int y, int frame, int width, int height,
                                            float fov, float aspect, uint32_t& rng, V3& ro,
                                            V3& rd) {
  rng = gen_rng(x, y, frame, width, height);
  float jx = random_float01(rng);
  float jy = random_float01(rng);
  float u = ((((float)x + (jx - 0.5f)) / (float)width) * 2.0f - 1.0f) * aspect;
  float v = (((float)y + (jy - 0.5f)) / (float)height) * 2.0f - 1.0f;
  ro = v3(0.0f, 0.0f, -3.0f);
  rd = v3(u, v, fov);
  rd = rd / sqrtf(dot(rd, rd));
}

// AABB check of box (lo3, hi3) (aabb.glsl:21-33, ops/aabb.py).
__device__ __forceinline__ bool slab_box(const float* __restrict__ box, V3 ro, V3 rd) {
  float o[3] = {ro.x, ro.y, ro.z};
  float d[3] = {rd.x, rd.y, rd.z};
  float tn = -INFINITY, tf = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float ta = (box[k] - o[k]) / d[k];
    float tb = (box[3 + k] - o[k]) / d[k];
    tn = nan_max(tn, nan_min(ta, tb));
    tf = nan_min(tf, nan_max(ta, tb));
  }
  return tn < tf && tf > 0.0f;
}

// One hit's scatter + emission (shade_bounce: test_compute.glsl:118-149 plus
// the refraction extension) and the Russian roulette on the max throughput
// channel (test_compute.glsl:153-159), as path_trace applies them.  `mt` is
// the winner's 18-float material row, or nullptr for the all-zero MDEF
// material of a tap without a winner.  Returns false when the path dies.
__device__ __forceinline__ bool scatter(uint32_t& rng, V3& ro, V3& rd, V3& ret, V3& thr, V3 hit,
                                        V3 n, const float* __restrict__ mt) {
  float m[kMatSize];
#pragma unroll
  for (int c = 0; c < kMatSize; ++c) m[c] = mt ? mt[c] : 0.0f;
  V3 m_col = v3(m[0], m[1], m[2]);
  float m_brightness = m[3];
  V3 m_light = v3(m[4], m[5], m[6]);
  float m_spec = m[7];
  V3 m_spec_col = v3(m[8], m[9], m[10]);
  float m_rough = m[11];
  float m_ior = m[12];
  float m_refr = m[13];
  float m_refr_rough = m[14];
  V3 m_refr_col = v3(m[15], m[16], m[17]);

  float r_branch = random_float01(rng);
  bool do_spec = r_branch < m_spec;
  bool do_refr = !do_spec && r_branch < m_spec + m_refr;
  float ray_prob = do_spec ? m_spec : (do_refr ? m_refr : 1.0f - m_spec - m_refr);
  ray_prob = nan_max(ray_prob, 1e-4f);
  V3 ruv = random_unit_vector(rng);
  V3 diffuse_dir = normalize_safe(n + ruv);
  V3 spec_dir = normalize_safe(vmix(reflect(rd, n), diffuse_dir, m_rough * m_rough));
  bool entering = dot(rd, n) < 0.0f;
  V3 n_eff = sel(entering, n, -n);
  float idx_ref = 1.0f + m_ior;
  float eta = entering ? 1.0f / idx_ref : idx_ref;
  // refract_dir: zero vector on total internal reflection.
  float cosi = dot(n_eff, rd);
  float kk = 1.0f - eta * eta * (1.0f - cosi * cosi);
  float root = kk > 0.0f ? sqrtf(kk) : 0.0f;
  V3 refr = kk >= 0.0f ? rd * eta - n_eff * (eta * cosi + root) : reflect(rd, n_eff);
  V3 trans_diffuse = normalize_safe(-n_eff + ruv);
  refr = normalize_safe(vmix(refr, trans_diffuse, m_refr_rough * m_refr_rough));
  V3 new_rd = do_spec ? spec_dir : (do_refr ? refr : diffuse_dir);
  V3 offset_n = do_refr ? -n_eff : n;
  ro = hit + offset_n * kOffset;
  V3 emit = normalize_safe(m_light) * m_brightness;
  V3 thr_factor = do_spec ? m_spec_col : (do_refr ? m_refr_col : m_col);
  rd = new_rd;
  ret = ret + emit * thr;
  V3 new_thr = (thr * thr_factor) / ray_prob;

  float p_rr = nan_max(new_thr.x, nan_max(new_thr.y, new_thr.z));
  float r_rr = random_float01(rng);
  if (r_rr > p_rr) return false;
  thr = new_thr * (p_rr > 0.0f ? 1.0f / p_rr : 0.0f);
  return true;
}

// The frame's output for pixel (x, y): a debug image overwrites the
// accumulator (debug modes do not accumulate); debug 0 updates the
// progressive running mean in place (test_compute.glsl:242-245).
__device__ __forceinline__ void write_pixel(float* __restrict__ accum, int x, int y, int width,
                                            V3 col, int last_clear, int debug) {
  float* out = accum + 3 * ((size_t)y * width + x);
  if (debug != 0) {
    out[0] = col.x;
    out[1] = col.y;
    out[2] = col.z;
  } else {
    float w = 1.0f / ((float)last_clear + 1.0f);
    float keep = 1.0f - w;
    out[0] = out[0] * keep + col.x * w;
    out[1] = out[1] * keep + col.y * w;
    out[2] = out[2] * keep + col.z * w;
  }
}

}  // namespace
