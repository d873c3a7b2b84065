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
// The closed form (the nearest hit with its AABB membership, the exact
// normal) lives in analytic.cuh, shared with the fused train step
// (train_fused.cu).
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

#include "analytic.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;

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
