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
// averaged into (debug 0) the (H, W, 3) float32 accumulator, or a band of
// its rows: JAX's row offset (iparams_ref[3], :1332-1336, which
// parallel/mesh.py gives each shard) is row_offset here, and the band's
// rows crop_h; each pixel keeps the RNG and camera of its row in the frame.
//
// What bounds it on an H100: neither the card's memory (about 25 MB of
// accumulator traffic per 1080p frame) nor its FP32 rate (the counted work
// of the benchmark scene is about 0.12 ms of it), but the interpreter and
// the lanes' fill.  A walk that loaded and tested all 66 op records of the
// 64-primitive benchmark scene at every map tap, though a warp's lanes hit
// few of its 61 boxes, took most of the frame's time; with the per-warp
// walk below, a tap walks 6 to 11 records on average, and the frame takes
// about a third of the time (PERF.md).  What is left is mostly the lanes'
// fill: a warp marches until its slowest ray is done, and lanes fill 37 %
// of their warps' march iterations.
//
// Every march of the kernel cuts the walk: the plain march
// (megakernel_walk: debug 0-3, analytic_unboxed), the over-relaxed march
// (megakernel_walk's RELAX instantiation, omega != 1), the grid march
// (megakernel_grid, K6) and debug 4's counting march (megakernel_stats).
// The block stages the decoded op records and the leaf table in shared
// memory once (csg_program.cuh:stage_walk, 16-byte cp.async); each bounce,
// after the guards, each warp ORs its live lanes' box bits and compacts the
// records they can need into its own list in shared memory
// (build_warp_list: every ENTER, LEAVE and guard-less shape, and the
// guarded shapes whose box some live lane hits), and the march and the
// normal walk that list, one 16-byte shared load a record.  A tap of the
// benchmark scene walks 5 + k records, k the boxes the warp's rays hit.
// The list is a warp collective, so the kernel keeps every lane of a warp
// to the end: out-of-range and finished lanes run on as not live, and the
// bounce loop runs while any lane of the warp is alive.  The guard bits and
// t-cull intervals stay in per-thread local memory.
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
// * omega != 1 (megakernel_walk<.., RELAX>; JAX :785-820) over-relaxes the
//   t-culled march with the sphere-overlap revert
//   (csg_program.cuh:march_relax_walk), which keeps the nearest entry
//   across steps as the exact march does, and recomputes it only where a
//   step or a revert may have passed it; omega == 1 runs the march above,
//   unchanged.
// * dist_grid (K6; megakernel_grid, baked geometry with t_cull only:
//   _march_while_grid :843, its grid tap render/distgrid.py:187) marches on
//   the frame's baked lower-bound grid (csg_program.cuh:march_grid_walk): a
//   ray whose grid bound is at least tau steps by it with no map tap, a
//   nearer one takes K2's t-culled exact tap over the warp's list, and the
//   normal is K2's.  What bounds it is the same as K2's: the exact taps it
//   keeps.  JAX decides per 8,192-lane tile whether the exact map runs;
//   here each thread decides, and a warp pays for the exact tap when any of
//   its 32 lanes is near (megakernel_grid<true> counts how often, in a
//   lockstep form of the same march).
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
//   (__activemask would).  It walks the per-warp lists as megakernel_walk
//   does, one ballot per listed shape: a shape off the list fails the guard
//   of every lane alive at the bounce, the marching lanes and those taking
//   the normal taps among them, so its ballot over the whole program was 0
//   and the counts are the same.  Every pixel of a warp gets the warp's (x,
//   y, z), held bit for bit by kernels/megakernel.py's MarchStats.  The
//   ballots and the warp-uniform loop make it slower than debug 0.
#include "csg_program.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;

constexpr int kWarps = kBlockX * kBlockY / 32;

// The march of debug 0-3 (and analytic_unboxed's cap) over per-warp lists
// of the program staged in shared memory (csg_program.cuh:stage_walk,
// build_warp_list); with RELAX (t-culled, debug 0 and 3) the over-relaxed
// march by omega (march_relax_walk) in place of march_walk.  Every lane of
// a warp runs to the end: a lane out of the frame, or whose path has ended,
// runs on as not live, so that each bounce's list is built by the whole
// warp.  A non-null walk_stats (debug 0 and 3: 2 (bounces + 1) zeroed
// uint64) takes record_list's figures.  omega follows the older parameters
// and RELAX compiles out the debug 1/2 branch, so the instantiations without
// RELAX compile to the same SASS as before it existed; the band's
// row_offset and crop_h follow omega, for the same reason, in each kernel
// of this file.
template <bool BAKED, bool TCULL, bool RELAX>
__global__ void __launch_bounds__(kBlockX * kBlockY)
megakernel_walk(Scene S, int f_leaf, float* __restrict__ accum, int width, int height, int frame,
                int last_clear, int bounces, float fov, float aspect, int debug,
                unsigned long long* __restrict__ walk_stats, float omega, int row_offset,
                int crop_h) {
  extern __shared__ int4 walk_smem[];
  const int tid = threadIdx.x + kBlockX * threadIdx.y;
  const int warp = tid >> 5, lane = tid & 31;
  const Walk P = stage_walk(S, f_leaf, kWarps, walk_smem, tid, kBlockX * kBlockY);
  const int4* __restrict__ list = P.lists + warp * P.n_ops;
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const bool inrange = x < width && y < crop_h;

  uint32_t rng = 0u;
  V3 ro = splat(0.0f), rd = splat(0.0f);
  if (inrange) primary_ray(x, row_offset + y, frame, width, height, fov, aspect, rng, ro, rd);
  Guards<TCULL> g;
  V3 col = splat(0.0f);

  if (!RELAX && (debug == 1 || debug == 2)) {
    float dbg = 0.0f;
    if (inrange) dbg = compute_guards(S, ro, rd, g);
    const int n = build_warp_list(P, S.n_boxed, g, inrange, warp, lane);
    if (inrange) {
      int idx;
      float t = march_walk<BAKED, TCULL>(S, list, n, P.F, g, ro, rd, idx);
      if (debug == 1) {
        // normals + AABB tint (test_compute.glsl:170-179)
        if (t > kFar) {
          col = splat(dbg);
        } else {
          V3 nrm = normal_walk<BAKED, TCULL>(list, n, P.F, g, ro + rd * t);
          col = (normalize_safe(nrm) * 0.5f + splat(0.5f)) * 0.2f + splat(dbg);
        }
      } else {
        // first-hit albedo (test_compute.glsl:183-195)
        const float* mt = S.F + S.f_mat + kMatSize * idx;
        col = idx >= 0 ? v3(mt[0], mt[1], mt[2]) : splat(0.0f);
      }
    }
  } else {
    V3 ret = v3(0.0f, 0.0f, 0.0f);
    V3 thr = v3(1.0f, 1.0f, 1.0f);
    int i_exit = -1;
    bool alive = inrange;
    for (int i = 0; i <= bounces; ++i) {
      if (!__any_sync(kFullWarp, alive)) break;
      float t_cap = INFINITY;
      int j_cap = -1;
      if (alive) {
        compute_guards(S, ro, rd, g);
        if (S.n_cap > 0) cap_scan(S, ro, rd, t_cap, j_cap);
      }
      const int n = build_warp_list(P, S.n_boxed, g, alive, warp, lane);
      record_list(walk_stats, i, n, lane);
      if (!alive) continue;
      int idx;
      float t;
      if constexpr (RELAX) {
        t = march_relax_walk<BAKED>(S, list, n, P.F, g, ro, rd, idx, omega, t_cap);
      } else {
        t = march_walk<BAKED, TCULL>(S, list, n, P.F, g, ro, rd, idx, t_cap);
      }
      if (t > kFar) {
        i_exit = i;
        alive = false;
        continue;
      }
      V3 hit = ro + rd * t;
      V3 nrm;
      if (t >= t_cap) {
        idx = cap_id(S, j_cap);
        nrm = cap_normal(S, j_cap, hit);
      } else {
        nrm = normal_walk<BAKED, TCULL>(list, n, P.F, g, hit);
      }
      const float* mt = idx >= 0 ? S.F + S.f_mat + kMatSize * idx : nullptr;
      if (!scatter(rng, ro, rd, ret, thr, hit, nrm, mt)) {
        i_exit = i;
        alive = false;
      }
    }
    if (i_exit < 0) i_exit = bounces + 1;
    // debug 3: the bounce heatmap (test_compute.glsl:163).
    col = debug == 3 ? splat((float)i_exit / (float)bounces) : ret;
  }
  if (inrange) write_pixel(accum, x, y, width, col, last_clear, debug);
}

// The grid march (K6; baked, t-culled, debug 0 and 3) over megakernel_walk's
// per-warp lists, the same frame with march_grid_walk in place of
// march_walk.  With STATS it adds the grid march's warp statistics to
// grid_stats (5 zeroed uint64); walk_stats as megakernel_walk's.
template <bool STATS>
__global__ void __launch_bounds__(kBlockX * kBlockY)
megakernel_grid(Scene S, int f_leaf, float* __restrict__ accum, int width, int height, int frame,
                int last_clear, int bounces, float fov, float aspect, int debug, Grid G,
                unsigned long long* __restrict__ grid_stats,
                unsigned long long* __restrict__ walk_stats, int row_offset, int crop_h) {
  extern __shared__ int4 walk_smem[];
  const int tid = threadIdx.x + kBlockX * threadIdx.y;
  const int warp = tid >> 5, lane = tid & 31;
  const Walk P = stage_walk(S, f_leaf, kWarps, walk_smem, tid, kBlockX * kBlockY);
  const int4* __restrict__ list = P.lists + warp * P.n_ops;
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const bool inrange = x < width && y < crop_h;

  uint32_t rng = 0u;
  V3 ro = splat(0.0f), rd = splat(0.0f);
  if (inrange) primary_ray(x, row_offset + y, frame, width, height, fov, aspect, rng, ro, rd);
  Guards<true> g;
  V3 ret = v3(0.0f, 0.0f, 0.0f);
  V3 thr = v3(1.0f, 1.0f, 1.0f);
  int i_exit = -1;
  bool alive = inrange;
  GridStats st = {};
  for (int i = 0; i <= bounces; ++i) {
    if (!__any_sync(kFullWarp, alive)) break;
    float t_cap = INFINITY;
    int j_cap = -1;
    if (alive) {
      compute_guards(S, ro, rd, g);
      if (S.n_cap > 0) cap_scan(S, ro, rd, t_cap, j_cap);
    }
    const int n = build_warp_list(P, S.n_boxed, g, alive, warp, lane);
    record_list(walk_stats, i, n, lane);
    // STATS marches the warp in lockstep, live lanes or not.
    if (!STATS && !alive) continue;
    int idx;
    const float t = march_grid_walk<STATS>(S, list, n, P.F, g, G, ro, rd, idx, t_cap, alive,
                                           lane, st);
    if (!alive) continue;
    if (t > kFar) {
      i_exit = i;
      alive = false;
      continue;
    }
    V3 hit = ro + rd * t;
    V3 nrm;
    if (t >= t_cap) {
      idx = cap_id(S, j_cap);
      nrm = cap_normal(S, j_cap, hit);
    } else {
      nrm = normal_walk<true, true>(list, n, P.F, g, hit);
    }
    const float* mt = idx >= 0 ? S.F + S.f_mat + kMatSize * idx : nullptr;
    if (!scatter(rng, ro, rd, ret, thr, hit, nrm, mt)) {
      i_exit = i;
      alive = false;
    }
  }
  if constexpr (STATS) {
    for (int k = 0; k < 5; ++k) {
      if (st.v[k]) atomicAdd(grid_stats + k, st.v[k]);
    }
  }
  if (i_exit < 0) i_exit = bounces + 1;
  // debug 3: the bounce heatmap (test_compute.glsl:163).
  const V3 col = debug == 3 ? splat((float)i_exit / (float)bounces) : ret;
  if (inrange) write_pixel(accum, x, y, width, col, last_clear, debug);
}

// Debug 4: the frame's paths as debug 0 traces them, with the warp's
// counters (csg_program.cuh:WarpStats) written to each in-range pixel.  The
// walk is megakernel_walk's: the program staged once, each bounce's list
// built from the lanes still alive, and the march (march_stats_walk) and
// the normal taps (grad_walk<COUNT_ALL>) count over that list.
template <bool BAKED, bool TCULL>
__global__ void __launch_bounds__(kBlockX * kBlockY)
megakernel_stats(Scene S, int f_leaf, float* __restrict__ accum, int width, int height,
                 int frame, int bounces, float fov, float aspect, int row_offset, int crop_h) {
  extern __shared__ int4 walk_smem[];
  const int tid = threadIdx.x + kBlockX * threadIdx.y;
  const int warp = tid >> 5, lane = tid & 31;
  const Walk P = stage_walk(S, f_leaf, kWarps, walk_smem, tid, kBlockX * kBlockY);
  const int4* __restrict__ list = P.lists + warp * P.n_ops;
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const bool inrange = x < width && y < crop_h;
  uint32_t rng = 0u;
  V3 ro = splat(0.0f), rd = splat(0.0f);
  if (inrange) primary_ray(x, row_offset + y, frame, width, height, fov, aspect, rng, ro, rd);
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
    const int n = build_warp_list(P, S.n_boxed, g, alive, warp, lane);
    int idx;
    const float t =
        march_stats_walk<BAKED, TCULL>(S, list, n, P.F, g, ro, rd, idx, t_cap, alive, st);
    const bool hit = alive && !(t > kFar);
    const bool capped = hit && t >= t_cap;
    const V3 hp = ro + rd * t;
    V3 nrm = normalize_safe(
        grad_walk<BAKED, TCULL, COUNT_ALL>(list, n, P.F, g, hp, hit && !capped, &st.aux));
    if (hit) {
      if (capped) {
        idx = cap_id(S, j_cap);
        nrm = cap_normal(S, j_cap, hp);
      }
      const float* mt = idx >= 0 ? S.F + S.f_mat + kMatSize * idx : nullptr;
      alive = scatter(rng, ro, rd, ret, thr, hp, nrm, mt);
    } else {
      alive = false;
    }
  }
  if (inrange) {
    write_pixel(accum, x, y, width, v3((float)st.steps, (float)st.shapes, (float)st.aux), 0, 4);
  }
}

// Checks a walk kernel's dynamic shared memory against the program's
// (walk_smem_bytes) and raises the kernel's limit above 48 KiB.
template <typename Kernel>
cudaError_t walk_smem_ready(Kernel kernel, const Scene& S, int f_leaf, int smem_bytes) {
  if (smem_bytes != walk_smem_bytes(S.n_ops, f_leaf, kWarps)) return cudaErrorInvalidValue;
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <bool BAKED, bool TCULL, bool RELAX>
int launch_walk(const Scene& S, int f_leaf, int smem_bytes, float* accum, int width, int height,
                int row_offset, int crop_h, int frame, int last_clear, int bounces, float fov,
                float aspect, int debug, unsigned long long* walk_stats, float omega,
                cudaStream_t stream) {
  const cudaError_t err =
      walk_smem_ready(megakernel_walk<BAKED, TCULL, RELAX>, S, f_leaf, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(kBlockX, kBlockY);
  dim3 grid((width + kBlockX - 1) / kBlockX, (crop_h + kBlockY - 1) / kBlockY);
  megakernel_walk<BAKED, TCULL, RELAX><<<grid, block, smem_bytes, stream>>>(
      S, f_leaf, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, walk_stats,
      omega, row_offset, crop_h);
  return static_cast<int>(cudaGetLastError());
}

template <bool BAKED, bool TCULL>
int launch_stats(const Scene& S, int f_leaf, int smem_bytes, float* accum, int width, int height,
                 int row_offset, int crop_h, int frame, int bounces, float fov, float aspect,
                 cudaStream_t stream) {
  const cudaError_t err = walk_smem_ready(megakernel_stats<BAKED, TCULL>, S, f_leaf, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(kBlockX, kBlockY);
  dim3 grid((width + kBlockX - 1) / kBlockX, (crop_h + kBlockY - 1) / kBlockY);
  megakernel_stats<BAKED, TCULL><<<grid, block, smem_bytes, stream>>>(
      S, f_leaf, accum, width, height, frame, bounces, fov, aspect, row_offset, crop_h);
  return static_cast<int>(cudaGetLastError());
}

template <bool STATS>
int launch_grid(const Scene& S, int f_leaf, int smem_bytes, float* accum, int width, int height,
                int row_offset, int crop_h, int frame, int last_clear, int bounces, float fov,
                float aspect, int debug, const Grid& G, unsigned long long* grid_stats,
                unsigned long long* walk_stats, cudaStream_t stream) {
  const cudaError_t err = walk_smem_ready(megakernel_grid<STATS>, S, f_leaf, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(kBlockX, kBlockY);
  dim3 grid((width + kBlockX - 1) / kBlockX, (crop_h + kBlockY - 1) / kBlockY);
  megakernel_grid<STATS><<<grid, block, smem_bytes, stream>>>(
      S, f_leaf, accum, width, height, frame, last_clear, bounces, fov, aspect, debug, G,
      grid_stats, walk_stats, row_offset, crop_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one frame on `stream`; returns cudaGetLastError() (0 on success).
// `code` is program_code_on's int32 vector (n_ops op records, n_boxed cull
// flags, then n_cap cap records), `table` program_table's float32 vector;
// accum is (crop_h, width, 3) float32, contiguous, updated in place: the
// frame's rows [row_offset, row_offset + crop_h), each pixel's RNG and
// camera those of its row in the (height, width) frame, so a band is bit
// for bit the whole frame's rows (row_offset 0 and crop_h = height: the
// frame); debug 4's warps tile the band's rows, so its band must start on
// an even row and end on one or at the frame's end.  The
// caps and omega != 1 need t_cull and debug 0 or 3 (the caps also debug 4);
// the caller checks that and the program against kMaxDepth and kMaxBoxed.
// A non-null grid_cells (dist_grid) marches on the grid: grid_meta f32[9],
// grid_cells f32[gz*gy*gx], grid_offs the n_planes plane-row and n_k
// smooth-k offsets (render/distgrid.py:grid_code_on); it needs baked
// geometry, t_cull, debug 0 or 3 and omega 1.  A non-null grid_stats (5
// zeroed uint64) takes the grid march's warp statistics.  Debug 4 (omega 1,
// no grid) writes the warp statistics of the march to the accumulator
// instead of a frame.  Every kernel walks per-warp lists of the program
// with smem_bytes of dynamic shared memory, which must be
// walk_smem_bytes(n_ops, f_box, 8) (render/program.py:walk_smem_bytes):
// megakernel_walk (debug 0-3; omega != 1 its RELAX instantiation),
// megakernel_grid and megakernel_stats (debug 4).  A non-null walk_stats
// (debug 0 or 3; 2 (bounces + 1) zeroed uint64) takes each bounce's summed
// list length and list count.
extern "C" int cpt_megakernel_march(const int* code, int n_ops, const float* table,
                                    int n_boxed, int f_box, int f_mat, int n_cap, int baked,
                                    int t_cull, float omega, float* accum, int width, int height,
                                    int row_offset, int crop_h, int frame, int last_clear,
                                    int bounces, float fov,
                                    float aspect, int debug, const float* grid_meta,
                                    const float* grid_cells, int gx, int gy, int gz,
                                    const int* grid_offs, int n_planes, int n_k, float tau,
                                    unsigned long long* grid_stats, int smem_bytes,
                                    unsigned long long* walk_stats, void* stream) {
  Scene S{code, n_ops, table, n_boxed, f_box, f_box + 6 * n_boxed, f_mat,
          code + OP_WIDTH * n_ops + n_boxed, n_cap};
  const Grid G{grid_meta, grid_cells, gx, gy, gz, grid_offs, n_planes, n_k, tau};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool relax = omega != 1.0f;
  if ((n_cap > 0 || relax) && (!t_cull || debug == 1 || debug == 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (row_offset < 0 || crop_h < 1 || crop_h > height - row_offset) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (debug == 4) {
    if (relax || grid_cells != nullptr || row_offset % 2 != 0 ||
        (crop_h % 2 != 0 && row_offset + crop_h != height)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto stats = baked ? (t_cull ? &launch_stats<true, true> : &launch_stats<true, false>)
                       : (t_cull ? &launch_stats<false, true> : &launch_stats<false, false>);
    return stats(S, f_box, smem_bytes, accum, width, height, row_offset, crop_h, frame, bounces,
                 fov, aspect, st);
  }
  if (grid_cells != nullptr) {
    if (!baked || !t_cull || relax || debug == 1 || debug == 2 || gx < 1 || gy < 1 || gz < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto fn = grid_stats != nullptr ? &launch_grid<true> : &launch_grid<false>;
    return fn(S, f_box, smem_bytes, accum, width, height, row_offset, crop_h, frame, last_clear,
              bounces, fov, aspect, debug, G, grid_stats, walk_stats, st);
  }
  auto walk = relax ? (baked ? &launch_walk<true, true, true> : &launch_walk<false, true, true>)
              : baked ? (t_cull ? &launch_walk<true, true, false> : &launch_walk<true, false, false>)
                      : (t_cull ? &launch_walk<false, true, false> : &launch_walk<false, false, false>);
  return walk(S, f_box, smem_bytes, accum, width, height, row_offset, crop_h, frame, last_clear,
              bounces, fov, aspect, debug, walk_stats, omega, st);
}
