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
// only the guard tests do.  The interpreter, the march and the normal live
// in csg_program.cuh, shared with the ray-plane march (march_rays.cu, K3).
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
// * analytic_unboxed (_make_analytic_unboxed :319, the cap at :753-763,
//   :1060-1063, :1094-1095, :1148-1153): the program leaves the guard-less
//   shapes of render/baked.py:analytic_eligible_ids out of its ops and lists
//   them as caps; once per bounce K1's closed forms (analytic.cuh) give each
//   ray the nearest of them, the march stops on it, and a hit at t >= t_cap
//   takes that shape's id and exact normal instead of the 6 taps.  On the
//   benchmark scene that removes the ground plane and the two lamps from
//   every map tap of every ray.
// * omega != 1 (the RELAX instantiation, :785-820) over-relaxes the t-culled
//   march with the sphere-overlap revert (csg_program.cuh:march_relax);
//   omega == 1 runs the march above, unchanged.
// * dist_grid (K6; the GRID instantiation, baked geometry with t_cull only:
//   _march_while_grid :843, its grid tap render/distgrid.py:187) marches on
//   the frame's baked lower-bound grid (csg_program.cuh:march_grid): a ray
//   whose grid bound is at least tau steps by it with no map tap, a nearer
//   one takes K2's t-culled exact tap.  What bounds it is the same as K2's:
//   the exact taps it keeps.  JAX decides per 8,192-lane tile whether the
//   exact map runs; here each thread decides, and a warp pays for the exact
//   tap when any of its 32 lanes is near (GRID_STATS counts how often).
//   The grid (16 KiB at 16^3) is read with __ldg and stays in L1 and L2.
//   The cheap step's fallback root is the build's -prec-sqrt=true sqrtf,
//   the plain version's vecmath.sqrt_rn.
// * debug 4 (the STATS kernel, :1390-1406, _path_trace_tile(stats=True)
//   :1012-1193): JAX's three statistics of its lockstep unit, the tile, taken
//   of this kernel's, the warp (16x2 pixels of a block), over the same paths
//   as debug 0: x the warp's march iterations, y per iteration the guarded
//   shapes at least one lane evaluated, z per bounce six times the shapes
//   at least one lane evaluated in the normal taps (a guard-less shape counts
//   1, a capped hit takes no taps; JAX's seventh, final-id tap has no
//   counterpart: the id is carried).  x and y count only with t_cull, as in
//   JAX.  The kernel keeps every thread of a warp to the end: an
//   out-of-range or dead lane runs on as done, each loop runs while any lane
//   of the warp needs it, and each count is one __ballot_sync over the full
//   warp, so the counts do not depend on how the compiler reconverges
//   (__activemask, as GRID_STATS uses, would).  Every pixel of a warp gets
//   the warp's (x, y, z), held bit for bit by kernels/megakernel.py's
//   MarchStats.  It costs a ballot per shape per tap and a warp-uniform
//   loop, so it is a diagnostic, not a path to time frames with.
#include "csg_program.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;

// The march of debug 0 and 3: K2's (PLAIN), over-relaxed (RELAX), or on the
// distance grid (GRID, and GRID_STATS, which also counts warp statistics).
enum MarchMode { PLAIN = 0, RELAX = 1, GRID = 2, GRID_STATS = 3 };

template <bool BAKED, bool TCULL, int MODE>
__global__ void __launch_bounds__(kBlockX * kBlockY)
megakernel_march(Scene S, float* __restrict__ accum, int width, int height, int frame,
                 int last_clear, int bounces, float fov, float aspect, int debug, float omega,
                 Grid G, unsigned long long* __restrict__ stats) {
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
    GridStats st = {};
    for (int i = 0; i <= bounces; ++i) {
      compute_guards(S, ro, rd, g);
      float t_cap = INFINITY;
      int j_cap = -1;
      if (S.n_cap > 0) cap_scan(S, ro, rd, t_cap, j_cap);
      int idx;
      float t;
      if constexpr (MODE == RELAX) {
        t = march_relax<BAKED>(S, g, ro, rd, idx, omega, t_cap);
      } else if constexpr (MODE == GRID || MODE == GRID_STATS) {
        t = march_grid<BAKED, MODE == GRID_STATS>(S, g, G, ro, rd, idx, t_cap, st);
      } else {
        t = march<BAKED, TCULL>(S, g, ro, rd, idx, t_cap);
      }
      if (t > kFar) {
        i_exit = i;
        break;
      }
      V3 hit = ro + rd * t;
      V3 n;
      if (t >= t_cap) {
        idx = cap_id(S, j_cap);
        n = cap_normal(S, j_cap, hit);
      } else {
        n = calc_normal<BAKED, TCULL>(S, g, hit);
      }
      const float* mt = idx >= 0 ? S.F + S.f_mat + kMatSize * idx : nullptr;
      if (!scatter(rng, ro, rd, ret, thr, hit, n, mt)) {
        i_exit = i;
        break;
      }
    }
    if (i_exit < 0) i_exit = bounces + 1;
    if constexpr (MODE == GRID_STATS) {
      for (int k = 0; k < 5; ++k) {
        if (st.v[k]) atomicAdd(stats + k, st.v[k]);
      }
    }
    // debug 3: the bounce heatmap (test_compute.glsl:163).
    col = debug == 3 ? splat((float)i_exit / (float)bounces) : ret;
  }
  write_pixel(accum, x, y, width, col, last_clear, debug);
}

// Debug 4: the frame's paths as debug 0 traces them, with the warp's
// counters (csg_program.cuh:WarpStats) written to each in-range pixel.
template <bool BAKED, bool TCULL>
__global__ void __launch_bounds__(kBlockX * kBlockY)
megakernel_stats(Scene S, float* __restrict__ accum, int width, int height, int frame,
                 int bounces, float fov, float aspect) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const bool inrange = x < width && y < height;
  uint32_t rng = 0u;
  V3 ro = splat(0.0f), rd = splat(0.0f);
  if (inrange) primary_ray(x, y, frame, width, height, fov, aspect, rng, ro, rd);
  Guards<TCULL> g;
  V3 ret = v3(0.0f, 0.0f, 0.0f);
  V3 thr = v3(1.0f, 1.0f, 1.0f);
  WarpStats st = {0u, 0u, 0u};
  bool alive = inrange;
  for (int i = 0; i <= bounces; ++i) {
    if (!__any_sync(kFullWarp, alive)) break;
    float t_cap = INFINITY;
    int j_cap = -1;
    if (alive) {
      compute_guards(S, ro, rd, g);
      if (S.n_cap > 0) cap_scan(S, ro, rd, t_cap, j_cap);
    }
    int idx;
    const float t = march_stats<BAKED, TCULL>(S, g, ro, rd, idx, t_cap, alive, st);
    const bool hit = alive && !(t > kFar);
    const bool capped = hit && t >= t_cap;
    const V3 hp = ro + rd * t;
    V3 n = normalize_safe(
        grad_ops<BAKED, TCULL, COUNT_ALL>(S, g, hp, hit && !capped, &st.aux));
    if (hit) {
      if (capped) {
        idx = cap_id(S, j_cap);
        n = cap_normal(S, j_cap, hp);
      }
      const float* mt = idx >= 0 ? S.F + S.f_mat + kMatSize * idx : nullptr;
      alive = scatter(rng, ro, rd, ret, thr, hp, n, mt);
    } else {
      alive = false;
    }
  }
  if (inrange) {
    write_pixel(accum, x, y, width, v3((float)st.steps, (float)st.shapes, (float)st.aux), 0, 4);
  }
}

template <bool BAKED, bool TCULL>
void launch_stats(const Scene& S, float* accum, int width, int height, int frame, int bounces,
                  float fov, float aspect, cudaStream_t stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY);
  megakernel_stats<BAKED, TCULL><<<grid, block, 0, stream>>>(S, accum, width, height, frame,
                                                             bounces, fov, aspect);
}

template <bool BAKED, bool TCULL, int MODE>
void launch(const Scene& S, float* accum, int width, int height, int frame, int last_clear,
            int bounces, float fov, float aspect, int debug, float omega, const Grid& G,
            unsigned long long* stats, cudaStream_t stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY);
  megakernel_march<BAKED, TCULL, MODE><<<grid, block, 0, stream>>>(
      S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, omega, G, stats);
}

}  // namespace

// Launches one frame on `stream`; returns cudaGetLastError() (0 on success).
// `code` is program_code_on's int32 vector (n_ops op records, n_boxed cull
// flags, then n_cap cap records), `table` program_table's float32 vector;
// accum is (height, width, 3) float32, contiguous, updated in place.  The
// caps and omega != 1 need t_cull and debug 0 or 3; the caller checks that
// and the program against kMaxDepth and kMaxBoxed.  A non-null grid_cells
// (dist_grid) marches on the grid: grid_meta f32[9], grid_cells
// f32[gz*gy*gx], grid_offs the n_planes plane-row and n_k smooth-k offsets
// (render/distgrid.py:grid_code_on); it needs baked geometry, t_cull, debug
// 0 or 3 and omega 1.  A non-null grid_stats (5 zeroed uint64) takes the
// grid march's warp statistics.  Debug 4 (omega 1, no grid) writes the
// warp statistics of the march to the accumulator instead of a frame.
extern "C" int cpt_megakernel_march(const int* code, int n_ops, const float* table,
                                    int n_boxed, int f_box, int f_mat, int n_cap, int baked,
                                    int t_cull, float omega, float* accum, int width, int height,
                                    int frame, int last_clear, int bounces, float fov,
                                    float aspect, int debug, const float* grid_meta,
                                    const float* grid_cells, int gx, int gy, int gz,
                                    const int* grid_offs, int n_planes, int n_k, float tau,
                                    unsigned long long* grid_stats, void* stream) {
  Scene S{code, n_ops, table, n_boxed, f_box, f_box + 6 * n_boxed, f_mat,
          code + OP_WIDTH * n_ops + n_boxed, n_cap};
  const Grid G{grid_meta, grid_cells, gx, gy, gz, grid_offs, n_planes, n_k, tau};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool relax = omega != 1.0f;
  if ((n_cap > 0 || relax) && (!t_cull || debug == 1 || debug == 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (debug == 4) {
    if (relax || grid_cells != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (baked) {
      if (t_cull) {
        launch_stats<true, true>(S, accum, width, height, frame, bounces, fov, aspect, st);
      } else {
        launch_stats<true, false>(S, accum, width, height, frame, bounces, fov, aspect, st);
      }
    } else if (t_cull) {
      launch_stats<false, true>(S, accum, width, height, frame, bounces, fov, aspect, st);
    } else {
      launch_stats<false, false>(S, accum, width, height, frame, bounces, fov, aspect, st);
    }
  } else if (grid_cells != nullptr) {
    if (!baked || !t_cull || relax || debug == 1 || debug == 2 || gx < 1 || gy < 1 || gz < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (grid_stats != nullptr) {
      launch<true, true, GRID_STATS>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, omega, G, grid_stats, st);
    } else {
      launch<true, true, GRID>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, omega, G, nullptr, st);
    }
  } else if (baked) {
    if (relax) {
      launch<true, true, RELAX>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, omega, G, nullptr, st);
    } else if (t_cull) {
      launch<true, true, PLAIN>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, omega, G, nullptr, st);
    } else {
      launch<true, false, PLAIN>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, omega, G, nullptr, st);
    }
  } else if (relax) {
    launch<false, true, RELAX>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, omega, G, nullptr, st);
  } else if (t_cull) {
    launch<false, true, PLAIN>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, omega, G, nullptr, st);
  } else {
    launch<false, false, PLAIN>(S, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, omega, G, nullptr, st);
  }
  return static_cast<int>(cudaGetLastError());
}
