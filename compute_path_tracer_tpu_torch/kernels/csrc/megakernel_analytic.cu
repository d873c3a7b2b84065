// Full-analytic progressive path-traced frame: persistent blocks over the
// scene staged in shared memory, warps that refill their lanes with new
// pixels.
//
// Replaces compute_path_tracer_tpu/kernels/megakernel.py:_pallas_frame_planes
// in its analytic_all mode (the pallas_call at megakernel.py:1546, kernel
// body _make_kernel with _make_analytic_all), and its analytic_soa mode
// (K5: the same walk over tables read at run time): per pixel the wang-hash
// RNG, AA jitter and primary ray, then bounces+1 iterations of AABB
// membership (with the first-shape clobber), the closed-form nearest hit
// over every leaf, the exact normal, the 18-channel material, shade_bounce
// and Russian roulette, and finally the running mean accum*(1-w) + col*w
// written in place into the (H, W, 3) float32 accumulator, or into a band
// of its rows: JAX's row offset (iparams_ref[3], :1332-1336, which
// parallel/mesh.py gives each shard) is row_offset here, and the band's
// rows crop_h; each pixel keeps the RNG and camera of its row in the frame.
//
// What bounds it on an H100: issued instructions, not bytes (about 25 MB of
// accumulator traffic per 1080p frame).  Each live bounce tests every
// guarded shape's box (a slab test of six divisions) and intersects the
// shapes it enters in closed form, and three things wasted most of the
// issue slots of the one-thread-per-pixel kernel this replaces:
// * Empty lanes.  A warp ran until its longest path ended, so its lanes
//   filled 0.62, 0.49 and 0.40 of its casts on the 64-, 256- and
//   512-primitive benchmark scenes at 1080p (more shapes, more bounces, a
//   longer longest path; counted on an NVIDIA H100 80GB HBM3, 700.00 W).
//   Here a lane whose path ends writes its pixel and takes the next one
//   (persistent threads, Aila & Laine 2009): each warp
//   takes 16x2 tiles of pixels (K2's warp shape, coherent primary rays)
//   from a counter in device memory, one atomicAdd a tile, and hands their
//   pixels to its free lanes before every cast, so it casts while the
//   frame has pixels and only the tail runs part-empty.
// * Divisions.  Each division of the box test was div.rn.f32, a quarter-
//   rate reciprocal with a Newton step and a range check.  The divisor is
//   the ray's direction, the same for every shape of a cast, so the cast
//   computes its correctly rounded reciprocal once and each quotient with
//   a multiply and two FMAs (analytic_staged.cuh: the proof, and the range
//   in which the quotient is the division bit for bit; rays outside it
//   keep `/`).
// * Table loads.  Each thread read the packed tables from global memory,
//   shape by shape.  Here each block stages the scene once, before any
//   pixel, as 16-byte aligned records in shared memory (render/soa.py:
//   build_staged_layout, gathered through its index vector from the packed
//   tables, so the host does no more per frame): a box is two broadcast
//   16-byte loads with the guard flag and the shape id in their padding,
//   then the geometry row, the ancestor boxes, and the material rows.
//   The grid is as many blocks as fit the SMs at once; the table caps a
//   scene at 232,448 bytes, about 1,600 shapes (render/soa.py:
//   analytic_smem_bytes raises above it).
// The band's row_offset and crop_h come last among the kernel's
// parameters, so the parameters it had before keep their places in the
// constant bank and its code changes only where the band is read.
// With the three, lanes fill 0.91-0.96 of the casts and the kernel takes
// 0.95-1.03 ms at 64 primitives, 12-13x its operation bound (PERF.md; NVIDIA
// H100 80GB HBM3, 700.00 W).  What bounds it now is still the instructions
// it issues, with the lanes full: every guarded shape's box test a cast (two
// shared loads, six quotients, the NaN-propagating folds) and the closed
// forms of the shapes its lanes enter (8.9 a warp cast at 64 primitives,
// 49.8 at 512).
// Each pixel's arithmetic is the one-thread-per-pixel kernel's: the same
// RNG seed, bounce loop, exit bounce and writes, so the order in which
// pixels are taken changes no bit of the frame.  The STATS instantiation
// counts lane fill and the shapes each warp cast enters, under this
// schedule or (REFILL false) under the old one, a warp per 16x2 tile.
//
// Tests on the CPU (the staged layout and its plain cast, the quotient's
// plain model, the lane-fill helper):
//   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_analytic_staged.py
// On the card: python3 chip_smoke.py, and against another checkout
//   python -m compute_path_tracer_tpu_torch.benchmarks.kernel_ab OTHER_DIR
//
// Parity decisions (the plain torch version in render/soa.py and
// render/reference.py, and the JAX package, are the references):
// * Built with -fmad=false -prec-div=true -prec-sqrt=true -ftz=false (see
//   kernels/build.py) and never --use_fast_math: no a*b+c is contracted into
//   an FMA, so the slab and quadratic arithmetic rounds like the plain
//   version, op by op; the box test's FMAs are explicit (__fmaf_rn) and
//   give the division's own result.
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
//   shape"; the tables' pad rows are not staged.  The sphere takes the exit
//   root from inside; planes reject |denom| <= 1e-12.
// * Each lane ends its path when its ray dies (path_trace's per-lane
//   semantics); the TPU kernel's whole-tile exit changes no live pixel.

#include <string.h>

#include "analytic_staged.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kTileW = 16;     // a warp's tile of pixels: 16 wide,
constexpr int kTileH = 2;      // 2 tall (K2's warp)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemCap = 232448;

template <bool STATS, bool REFILL>
__global__ void __launch_bounds__(kThreads)
megakernel_analytic(const float* __restrict__ F, const int* __restrict__ I,
                    const int* __restrict__ stage_src, StagedMeta m,
                    float* __restrict__ accum, int width, int height, int frame,
                    int last_clear, int bounces, float fov, float aspect, int debug,
                    int* __restrict__ tile_next, unsigned long long* __restrict__ stats,
                    int row_offset, int crop_h) {
  extern __shared__ float4 smem4[];
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem4);
  for (int i = threadIdx.x; i < m.n_words; i += kThreads) {
    const int s = stage_src[i];
    sw[i] = s < 0 ? 0u : (s < m.f_len ? __float_as_uint(F[s]) : (uint32_t)I[s - m.f_len]);
  }
  __syncthreads();
  const float* S = reinterpret_cast<const float*>(smem4);
  const bool boxes_ok = staged_boxes_ok(S, m);

  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int n_tiles = tiles_x * ((crop_h + kTileH - 1) / kTileH);
  unsigned long long st[ST_FIELDS] = {};

  // Warp-uniform: the warp's tile, how many of its pixels it handed out,
  // and whether the frame has tiles left.
  int tile = 0, taken = kTileW * kTileH;
  bool more = true;
  // The lane's path; y is the pixel's row in the accumulator, the band's
  // rows, and row_offset + y its row in the frame.
  bool have = false;
  int x = 0, y = 0, i = 0;
  uint32_t rng = 0;
  V3 ro, rd, ret, thr;
  while (true) {
    // Free lanes take the next pixels of the warp's tile, in lane order.
    unsigned need = __ballot_sync(kFull, !have);
    while (more && need != 0 && (REFILL || need == kFull)) {
      if (taken == kTileW * kTileH) {
        int t = 0;
        if (lane == 0) t = atomicAdd(tile_next, 1);
        t = __shfl_sync(kFull, t, 0);
        if (t >= n_tiles) {
          more = false;
          break;
        }
        tile = t;
        taken = 0;
      }
      const int avail = kTileW * kTileH - taken;
      const int rank = __popc(need & lower);
      if (!have && rank < avail) {
        const int j = taken + rank;
        x = (tile % tiles_x) * kTileW + j % kTileW;
        y = (tile / tiles_x) * kTileH + j / kTileW;
        if (x < width && y < crop_h) {
          primary_ray(x, row_offset + y, frame, width, height, fov, aspect, rng, ro, rd);
          ret = v3(0.0f, 0.0f, 0.0f);
          thr = v3(1.0f, 1.0f, 1.0f);
          i = 0;
          have = true;
        }
      }
      taken += min(__popc(need), avail);
      need = __ballot_sync(kFull, !have);
    }
    const unsigned act = __ballot_sync(kFull, have);
    if (act == 0) break;
    if (have) {
      // One bounce of the lane's path.
      const bool fast = boxes_ok && recip_ray_ok(ro, rd);
      unsigned mask = 0;
      if (STATS) {
        mask = __ballot_sync(act, fast);
        if (lane == __ffs(act) - 1) {
          ++st[ST_WARP_CASTS];
          st[ST_LANE_CASTS] += __popc(act);
          st[ST_SLOW_CASTS] += __popc(act & ~mask);
        }
        if (!fast) mask = act & ~mask;
      }
      const Hit h = fast ? cast_staged<true, STATS>(S, m, ro, rd, mask, st)
                         : cast_staged<false, STATS>(S, m, ro, rd, mask, st);
      bool end = h.t > kFar;
      if (!end) {
        const V3 hit = ro + rd * h.t;
        const V3 n = leaf_normal(h.kind, S + h.off + kRecHead, hit);
        end = !scatter(rng, ro, rd, ret, thr, hit, n, S + m.mat + kMatSize * h.sid);
      }
      int i_exit = i;
      if (!end && ++i > bounces) {
        i_exit = bounces + 1;
        end = true;
      }
      if (end) {
        // debug 3: the bounce heatmap (test_compute.glsl:163).
        const V3 col = debug == 3 ? splat((float)i_exit / (float)bounces) : ret;
        write_pixel(accum, x, y, width, col, last_clear, debug);
        have = false;
      }
    }
  }
  if (STATS) {
#pragma unroll
    for (int k = 0; k < ST_FIELDS; ++k) {
      if (st[k]) atomicAdd(stats + k, st[k]);
    }
  }
}

// What a launch asks of the runtime, kept per device and instantiation so
// that a frame's launch repeats no query: the SM count, the dynamic shared
// memory the kernel was allowed, and its resident blocks an SM at the last
// size.  The grid's size only sets how many blocks share the tiles, so a
// stale entry could cost time but no pixel.
struct LaunchCache {
  int sms = 0, smem_allowed = 48 * 1024, smem = -1, per_sm = 0;
};
constexpr int kCachedDevices = 64;

template <bool STATS, bool REFILL>
int launch(const float* F, const int* I, const int* stage_src, const StagedMeta& m,
           float* accum, int width, int height, int row_offset, int crop_h, int frame,
           int last_clear, int bounces, float fov, float aspect, int debug, int* tile_next,
           unsigned long long* stats, cudaStream_t stream) {
  static LaunchCache caches[kCachedDevices];
  auto kernel = megakernel_analytic<STATS, REFILL>;
  const int smem = 4 * m.n_words;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  LaunchCache fresh;
  LaunchCache& c = dev < kCachedDevices ? caches[dev] : fresh;
  if (c.sms == 0) err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > c.smem_allowed) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) c.smem_allowed = smem;
  }
  if (err == cudaSuccess && smem != c.smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel, kThreads, smem);
    if (err == cudaSuccess) c.smem = smem;
  }
  if (err == cudaSuccess) err = cudaMemsetAsync(tile_next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c.per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles =
      (long long)((width + kTileW - 1) / kTileW) * ((crop_h + kTileH - 1) / kTileH);
  const long long need = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  const long long fit = (long long)c.per_sm * c.sms;
  const int blocks = (int)(need < fit ? need : fit);
  kernel<<<blocks, kThreads, smem, stream>>>(F, I, stage_src, m, accum, width, height, frame,
                                             last_clear, bounces, fov, aspect, debug, tile_next,
                                             stats, row_offset, crop_h);
  return static_cast<int>(cudaGetLastError());
}

// One quotient per element on the range check of the cast: x = b - o, the
// hoisted quotient of x by d, __fdiv_rn's, and whether the ray and table
// range (recip_ray_ok's, staged_boxes_ok's) holds for (b, o, d).
__global__ void quotient_check(const float* __restrict__ b, const float* __restrict__ o,
                               const float* __restrict__ d, int n, float* __restrict__ q_fast,
                               float* __restrict__ q_div, int* __restrict__ in_range) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float x = b[k] - o[k];
  q_fast[k] = recip_quotient(x, d[k], __frcp_rn(d[k]));
  q_div[k] = __fdiv_rn(x, d[k]);
  in_range[k] = recip_range_or_zero(b[k]) && recip_range_or_zero(o[k]) && recip_range(d[k]);
}

}  // namespace

// Launches one frame on `stream`; returns the first CUDA error (0 on
// success).  soa_f and soa_i are the packed tables (render/soa.py:
// pack_soa_smem), stage_src the staged table's source indices and `meta`
// (a host pointer) its StagedMeta words (render/soa.py:StagedLayout);
// accum is (crop_h, width, 3) float32, contiguous, updated in place: the
// frame's rows [row_offset, row_offset + crop_h), each pixel's RNG and
// camera those of its row in the (height, width) frame, so a band is bit
// for bit the whole frame's rows (row_offset 0 and crop_h = height: the
// frame);
// tile_next one int32 of device scratch, zeroed here on the stream.  A
// non-null stats (ST_FIELDS zeroed uint64) runs the STATS instantiation,
// which adds the frame's lane statistics; with per_tile, under the old
// schedule (no refill: a warp takes a tile when all its lanes are free).
extern "C" int cpt_megakernel_analytic(const float* soa_f, const int* soa_i,
                                       const int* stage_src, const int* meta, float* accum,
                                       int width, int height, int row_offset, int crop_h,
                                       int frame, int last_clear, int bounces, float fov,
                                       float aspect, int debug, int* tile_next,
                                       unsigned long long* stats, int per_tile, void* stream) {
  StagedMeta m;
  memcpy(&m, meta, sizeof(m));
  if (4 * m.n_words > kSmemCap || m.n_words % 4 != 0 || m.mat % 4 != 0 || row_offset < 0 ||
      crop_h < 1 || crop_h > height - row_offset ||
      (per_tile && stats == nullptr) || (debug != 0 && debug != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fn = stats == nullptr ? &launch<false, true>
                             : (per_tile ? &launch<true, false> : &launch<true, true>);
  return fn(soa_f, soa_i, stage_src, m, accum, width, height, row_offset, crop_h, frame,
            last_clear, bounces, fov, aspect, debug, tile_next, stats, st);
}

// The hoisted quotient against __fdiv_rn on n triples (b, o, d), each
// output n long; returns cudaGetLastError().
extern "C" int cpt_quotient_check(const float* b, const float* o, const float* d, int n,
                                  float* q_fast, float* q_div, int* in_range, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  quotient_check<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      b, o, d, n, q_fast, q_div, in_range);
  return static_cast<int>(cudaGetLastError());
}
