// The two particle kernels of the sub-iteration: the neighbour window pass
// (K3) and the nearly-sorted rank repair (K4).
//
// Both work on the particle table in cell-sorted order: skey (n) int32 is
// the row-major cell key ((row + 0x8000) << 16 | (col + 0x8000) & 0xFFFF,
// INT32_MAX for dead lanes), ascending. The row of a key is key >> 16
// (arithmetic), its column key & 0xFFFF, so the cells (R, c-1..c+1) of one
// row R are one contiguous key range of the sorted table.
//
// ---------------------------------------------------------------------------
// K3, window_kernel: replaces box2d_tpu/particles_pallas.py:396
// `window_pass` (its body `_kernel`, :56-181). For each sorted particle i,
// a sum over the live j != i in rows row_i - 1 .. row_i + 1 within one
// diameter (d^2 < D^2):
//   weight   sum (1 - d/D)
//   pressure -sum vel_per_p * w * (p0_i + p0_j) * n
//   damping  sum over approaching pairs of max(lin*w, min(-quad*vn, 0.5))*vn*n
// with n the unit vector i -> j. Gather only: each thread writes its own
// particle's row; there are no atomics, so the result is deterministic.
//
// The TPU kernel evaluates fixed 128-aligned bands of 512/768 lanes against
// each 256-lane block (a dense masked compute), selects its own rows with
// a one-hot matmul and flags a block whose bands miss a neighbour cell.
// None of that is carried over: every neighbour in the three key ranges
// (row + d, col - 1) .. (row + d, col + 1), d = 0, +1, -1, is visited, in
// lane order, and nothing is truncated.
//
// What bounds it: at dam_break-100k a particle has ~16 candidates in its
// three ranges, ~4.5 of them neighbours: the pass needs ~3 MB and ~10
// MFLOP, under a microsecond on this card. A first design (one thread per
// particle, three binary searches over the whole table, candidates read
// from global memory) was bound by the latency of its 51 dependent
// searching loads a thread. This one takes them out of the thread's chain:
// - A block's 256 sorted lanes span one contiguous key range, so for each
//   d the union of its lanes' ranges is one contiguous lane range, from the
//   smallest lower key to the largest upper key. Six warps find the six
//   bounds at once, each by a 32-ary search (ballot over 32 sampled keys a
//   round), first within kBracket lanes of the block: 3 dependent loads.
// - The three unions (~300 lanes each at dam_break) are staged in shared
//   memory as one 16-byte record per lane (x, y, p0, p1; a dead lane's x is
//   NaN, which fails the distance test as the alive check would, so no
//   alive flag is read again) beside their keys. Each thread finds its own
//   three sub-ranges in shared memory by binary search and walks each in
//   two passes (walk): distance tests into a mask, then the neighbours'
//   terms, so that a warp takes the costly branch as often as its busiest
//   lane needs.
// - A block whose unions do not fit the kStage records (a block whose
//   first and last lanes lie in different rows while the rows beside them
//   are long and dense, or a cell denser than the stage) walks its
//   candidates from global memory instead, each thread searching only
//   inside the block's unions. That path is part of the kernel; `paths`
//   (when not null) counts the blocks that took each one.
// What is left (PERF.md; probe_k3.py times the launch floor and the two
// paths): a launch's fixed cost is a large share of its time at
// dam_break-100k, and the walk, which a warp runs at its busiest lane's
// pace, most of the rest; staging saves a few percent over the global
// walk there.
// The sums are taken in the twin's order (d = 0, +1, -1; lanes ascending)
// with the same operations, built with -fmad=false, so the kernel equals
// window_pass_reference bit for bit on either path.
//
// K3 batched (b2t_particle_window_batched): the same kernel as jax.vmap of
// the particle step traces `window_pass` (box2d_tpu/particles.py:855-877:
// a batch axis on the grid, one scalar row a world). W worlds' tables lie
// world-major, (W, n) each, with one scalar row a world (each world its
// own damping, density and so its own terms); the grid is (ceil(n / 256),
// W) and a block takes its world from blockIdx.y and offsets every table,
// its scalar row and its output by it. Its searches and stage then stay
// inside that world's table: no block spans two worlds and no particle
// sees another world's neighbour. A world's blocks do exactly what a
// single launch on that world's table does, so world w of the batched
// launch equals the single launch on world w bit for bit. What bounds it
// is what bounds one launch, W times over, in one launch's fixed cost.
//
// K3 batched for small worlds (b2t_particle_window_small,
// window_small_kernel): a batch of small worlds (64 x dam_break-500: 484
// lanes, a 9.7 KB table a world) gave the grid kernel two blocks a world,
// each running the whole chain above (warp searches over global keys, a
// barrier, the stage, a barrier) for a table that fits one SM's shared
// memory: about 8 us of its 13 us was that chain of dependent global
// loads and barriers, not bytes (the bound is 0.2-0.3 us). This kernel
// gives a group of threads up to 256 of a world's lanes, three threads a
// lane, one for each of its ranges (a world of n lanes takes ceil(n /
// 256) groups, a CTA each; narrower worlds share a CTA). The group copies
// its world's whole table into shared memory in one coalesced pass; each
// thread then searches and walks its one range there (a third of a lane's
// chain), and the three range sums meet in shared memory. A first design,
// one thread a lane and all three ranges, took 11.4-12.1 us against the
// grid kernel's 12.9-13.3 at 64 x dam_break-500: 6 us of searches and
// walks in one thread's chain. particles_kernels.k3_batched_plan picks
// this kernel from a world's capacity alone, up to K3_SMALL_LANES lanes,
// where its time meets the grid kernel's at 64 worlds (time_solver.py
// --k3-paths); wider tables keep the grid kernel. Both give the same bits.
//
// ---------------------------------------------------------------------------
// K4, rank_kernel: replaces box2d_tpu/particles_pallas.py:356 `rank_pass`
// (its body `_rank_kernel`, :276-320). Particles move at most one cell per
// sub-iteration, so the table sorted by last sub-iteration's keys is nearly
// sorted by the new ones, and the new sorted position of lane i is
//   rank_i = off_b + #{ j in [off_b, off_b + rb) : (key_j, j) < (key_i, i) }
// for i in block b (256 lanes), with off_b from rank_offsets (the caller
// checks that the window covers what it must; then this equals the inverse
// permutation of the stable argsort). Lanes at or past n count as
// (INT32_MAX, j) and sort last.
//
// The TPU kernel splits the keys into two exact f32 halves and compares
// each of its lanes with every window lane (a dense (256, rb) compare);
// the first design here did the same in shared memory, 256 x rb = 1e6
// compares a block and 4e8 at 100k, slower than a library radix sort.
// What bounds the function is bytes (0.4 MB of keys in, 0.4 MB of ranks
// out); this design does O(rb) work a block instead of O(256 rb):
// - the block sorts its own 256 (key, lane) pairs once (a bitonic network:
//   the steps within a warp by shuffles, the three wider ones through
//   shared memory);
// - each window lane e, read once from global memory, is placed against
//   the sorted pairs: below the first (it counts for every lane of the
//   block), at or above the last (it counts for none), or else a binary
//   search of 8 steps gives c_e, the number of block pairs <= e, and adds
//   one to a shared histogram at c_e; in a nearly sorted window only the
//   ~256 lanes whose keys fall in the block's own key range search;
// - the block pair at sorted position s has rank off_b + sum_{c <= s}
//   hist[c] (a block-wide prefix sum), written to its lane.
// That count is the same set as the twin's, so the ranks are bit-identical
// to rank_pass_reference whatever the input (and to the stable argsort
// where the preconditions hold).
// ---------------------------------------------------------------------------

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
// K3: the candidate records a block stages in shared memory (16 + 4 bytes
// each: 40 KB, five blocks an SM), and the lanes on either side of a block
// its unions' bounds are first searched within
constexpr int kStage = 2048;
constexpr int kBracket = 4096;
// a build with -DB2T_K3_NO_STAGE sends every block down the global path
// (probe_k3.py times the two paths against each other)
#ifdef B2T_K3_NO_STAGE
constexpr bool kStaging = false;
#else
constexpr bool kStaging = true;
#endif

enum Phase { PH_WEIGHT = 0, PH_PRESSURE = 1, PH_DAMPING = 2 };

// K3 batched for small worlds: a group's most lanes, a CTA's most threads
// (three a lane: the launch bound, two CTAs an SM, which holds the kernel
// to 40 registers: it spills 8-16 bytes, and is faster so than with one
// CTA an SM at 52 registers and none once a world takes more than one
// CTA: time_solver.py --k3-paths), and the most dynamic shared memory a
// CTA can opt in to
constexpr int kSmallLanes = 256;
constexpr int kSmallThreads = 3 * kSmallLanes;
constexpr size_t kSmemMax = 232448;

// A group's shared memory in window_small_kernel: its world's table, a
// float4 record and an int key a lane (n rounded up to 4 lanes, so that
// the next table's records stay 16-byte aligned), and a float2 range sum
// for each of its 3 x lanes threads.
inline size_t small_group_bytes(int n, int lanes) {
  return static_cast<size_t>((n + 3) & ~3) * 20 +
         static_cast<size_t>(3 * lanes) * 8;
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

struct K3Scalars {
  float inv_d, d2max, lin_d, quad_d, vel_per_p;
};

// The first index in [lo, hi) whose key is > target (upper) or >= target
// (lower), hi if none: a 32-ary search by the whole warp, one sampled key a
// lane per round. Every lane returns the answer.
__device__ __forceinline__ int warp_bound(const int* __restrict__ keys,
                                          int lo, int hi, int target,
                                          bool upper) {
  const int wl = threadIdx.x & 31;
  while (hi > lo) {  // the answer lies in [lo, hi]
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (wl + 1) * step - 1;
    bool before = false;  // p lies before the answer
    if (p < hi) {
      const int k = __ldg(keys + p);
      before = upper ? k <= target : k < target;
    }
    const int c = __popc(__ballot_sync(kFull, before));
    const int next_hi = min(lo + (c + 1) * step - 1, hi);
    lo = lo + c * step;
    hi = next_hi;
  }
  return lo;
}

// The first index in [lo, hi) of a sorted key array whose key is > target
// (upper) or >= target (lower), hi if none.
template <typename Keys>
__device__ __forceinline__ int bound(Keys keys, int lo, int hi, int target,
                                     bool upper) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int k = keys(mid);
    if (upper ? k <= target : k < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Lane g's candidate record: (x, y, p0, p1), x NaN for a dead lane. The
// phase reads only what it uses.
template <int PHASE>
__device__ __forceinline__ float4 load_record(
    const float* __restrict__ pos, const bool* __restrict__ alive,
    const float* __restrict__ p0, const float* __restrict__ p1, int g) {
  float4 r;
  r.x = alive[g] ? __ldg(pos + 2 * g) : __int_as_float(0x7fc00000);
  r.y = __ldg(pos + 2 * g + 1);
  r.z = PHASE != PH_WEIGHT ? __ldg(p0 + g) : 0.0f;
  r.w = PHASE == PH_DAMPING ? __ldg(p1 + g) : 0.0f;
  return r;
}

// One candidate (record c) of particle i (at px, py with p0 / p1 my0 /
// my1) into its range's sum: the twin's arithmetic, operation by
// operation.
template <int PHASE>
__device__ __forceinline__ void accumulate(const float4 c, float px,
                                           float py, float my0, float my1,
                                           const K3Scalars& sc, float& sx,
                                           float& sy) {
  const float dx = c.x - px;
  const float dy = c.y - py;
  const float d2 = dx * dx + dy * dy;
  if (!(d2 < sc.d2max)) return;
  const float invdist = d2 > 0.0f ? 1.0f / sqrtf(fmaxf(d2, 1e-30f)) : 0.0f;
  const float w = 1.0f - d2 * invdist * sc.inv_d;
  if (PHASE == PH_WEIGHT) {
    sx = sx + w;
  } else {
    const float nx = dx * invdist;
    const float ny = dy * invdist;
    if (PHASE == PH_PRESSURE) {
      const float fh = sc.vel_per_p * w * (my0 + c.z);
      sx = sx + fh * nx;
      sy = sy + fh * ny;
    } else {
      const float vn = (c.z - my0) * nx + (c.w - my1) * ny;
      if (vn < 0.0f) {
        const float damp = fmaxf(sc.lin_d * w, fminf(-sc.quad_d * vn, 0.5f));
        const float f = damp * vn;
        sx = sx + f * nx;
        sy = sy + f * ny;
      }
    }
  }
}

// One range of particle i (at px, py with p0 / p1 my0 / my1): the
// candidates in [lo, end) whose keys lie in [lo_key, hi_key], skipping
// index `own` (the particle itself). keys(k) / record(k) read index k.
// In two passes over each 32 candidates: the distance tests, independent
// of each other, mark the neighbours in a mask; then the neighbours are
// summed in lane order. A warp's lanes take the costly branch together,
// as often as the lane with the most neighbours needs, not once for every
// candidate of any lane. Returns the range's sums. walk_span: the same
// over the candidates [s, e), whose keys the caller found in range.
template <int PHASE, typename Records>
__device__ __forceinline__ float2 walk_span(Records record, int s, int e,
                                            int own, float px, float py,
                                            float my0, float my1,
                                            const K3Scalars& sc) {
  float sx = 0.0f, sy = 0.0f;
  for (int b = s; b < e; b += 32) {
    const int m_end = min(b + 32, e);
    unsigned mask = 0;
#pragma unroll 4
    for (int k = b; k < m_end; ++k) {
      const float4 c = record(k);
      const float dx = c.x - px;
      const float dy = c.y - py;
      const float d2 = dx * dx + dy * dy;
      if (d2 < sc.d2max && k != own) mask |= 1u << (k - b);
    }
    while (mask != 0) {
      const int k = b + __ffs(mask) - 1;
      mask &= mask - 1;
      accumulate<PHASE>(record(k), px, py, my0, my1, sc, sx, sy);
    }
  }
  return make_float2(sx, sy);
}

template <int PHASE, typename Keys, typename Records>
__device__ __forceinline__ float2 walk(Keys keys, Records record, int lo,
                                       int end, int lo_key, int hi_key,
                                       int own, float px, float py,
                                       float my0, float my1,
                                       const K3Scalars& sc) {
  const int s = bound(keys, lo, end, lo_key, false);
  const int e = bound(keys, s, end, hi_key, true);
  return walk_span<PHASE>(record, s, e, own, px, py, my0, my1, sc);
}

// The key range of row offset drow of a lane with cell key `key`: the
// cells (row + drow, col - 1) .. (row + drow, col + 1), the column clamped
// at 0 and 0xFFFF. A dead lane, or a row outside the 16-bit range (the
// key's row wraps at y = 0: ROADMAP.md section 3), has none (returns false;
// lo_key INT_MAX, hi_key INT_MIN). neighbour_keys: the three ranges,
// same row, row above, row below (d = 0, +1, -1, the order the twin sums
// them in).
__device__ __forceinline__ bool row_range(int key, bool live, int drow,
                                          int& lo_key, int& hi_key) {
  const int row = key >> 16;
  const int col = key & 0xFFFF;
  const long long R = static_cast<long long>(row) + drow;
  const bool open = live && R >= -32768 && R <= 32767;
  lo_key = open ? static_cast<int>(R * 65536 + (col > 0 ? col - 1 : 0))
                : INT_MAX;
  hi_key = open
      ? static_cast<int>(R * 65536 + (col < 0xFFFF ? col + 1 : 0xFFFF))
      : INT_MIN;
  return open;
}

__device__ __forceinline__ void neighbour_keys(int key, bool live,
                                               int lo_key[3], int hi_key[3],
                                               bool open[3]) {
  const int drow[3] = {0, 1, -1};
#pragma unroll
  for (int r = 0; r < 3; ++r)
    open[r] = row_range(key, live, drow[r], lo_key[r], hi_key[r]);
}

// A range's sums into the lane's output, as the twin adds them (the
// pressure term negated).
template <int PHASE>
__device__ __forceinline__ void add_range(float2 v, float& ox, float& oy) {
  if (PHASE == PH_PRESSURE) {
    ox = ox + -v.x;
    oy = oy + -v.y;
  } else {
    ox = ox + v.x;
    oy = oy + v.y;
  }
}

// scalars: [inv_diameter, diameter^2, lin_damping, quad_damping, vel_per_p]
template <int PHASE>
__global__ void __launch_bounds__(kBlock) window_kernel(
    const float* __restrict__ pos, const int* __restrict__ skey,
    const bool* __restrict__ alive, const float* __restrict__ p0,
    const float* __restrict__ p1, const float* __restrict__ scalars,
    float* __restrict__ out, int n, int* __restrict__ paths) {
  __shared__ float4 rec[kStage];
  __shared__ int rkey[kStage];
  __shared__ int lim[6];      // per d: the least lower key, the largest
                              // upper key of the block's lanes
  __shared__ int seg[3][3];   // per d: the union [lo, hi) and its offset
                              // in the stage
  // this block's world (0 in a single launch): its table, its scalar row
  // and its output rows
  const size_t world = static_cast<size_t>(blockIdx.y) * n;
  pos += 2 * world;
  skey += world;
  alive += world;
  p0 += world;
  p1 += world;
  out += 2 * world;
  scalars += 8 * blockIdx.y;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * kBlock;
  const int i = b0 + tid;
  const K3Scalars sc{scalars[0], scalars[1], scalars[2], scalars[3],
                     scalars[4]};

  // this lane's three key ranges: same row, row above, row below (the
  // order the twin sums them in); a dead lane, or a row outside the 16-bit
  // range, has none
  const bool live = i < n && alive[i];
  const int key = live ? skey[i] : 0;
  float px = 0.0f, py = 0.0f, my0 = 0.0f, my1 = 0.0f;
  if (live) {
    px = pos[2 * i];
    py = pos[2 * i + 1];
    my0 = p0[i];
    my1 = p1[i];
  }
  int lo_key[3], hi_key[3];
  bool open[3];
  neighbour_keys(key, live, lo_key, hi_key, open);
  if (tid < 3) {
    lim[tid] = INT_MAX;
    lim[3 + tid] = INT_MIN;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    int lo = lo_key[r], hi = hi_key[r];
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, o));
      hi = max(hi, __shfl_xor_sync(kFull, hi, o));
    }
    if (wl == 0) {
      atomicMin(&lim[r], lo);
      atomicMax(&lim[3 + r], hi);
    }
  }
  __syncthreads();
  // the six bounds of the unions, one warp each (a lane that needs row d
  // has lo_key < INT_MAX, so lim[d] == INT_MAX means no lane does), first
  // within kBracket lanes of the block, then, if the answer may lie
  // outside, over the whole table
  if (warp < 6) {
    const int r = warp % 3;
    const bool upper = warp >= 3;
    int b = 0;
    if (lim[r] != INT_MAX) {
      const int lo = max(b0 - kBracket, 0);
      const int hi = min(b0 + kBlock + kBracket, n);
      b = warp_bound(skey, lo, hi, lim[warp], upper);
      if ((b == lo && lo > 0) || (b == hi && hi < n))
        b = warp_bound(skey, 0, n, lim[warp], upper);
    }
    if (wl == 0) seg[r][upper ? 1 : 0] = b;
  }
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int r = 0; r < 3; ++r) total += seg[r][1] - seg[r][0];
  const bool staged = kStaging && total <= kStage;
  if (paths != nullptr && tid == 0) atomicAdd(paths + (staged ? 0 : 1), 1);

  // the sums of the three ranges, in the twin's order (d = 0, +1, -1); a
  // row that does not exist adds nothing
  float ox = 0.0f, oy = 0.0f;
  auto add = [&](float2 v) { add_range<PHASE>(v, ox, oy); };
  if (staged) {
    // stage index of lane g of union r: g + base[r]
    const int base[3] = {-seg[0][0], seg[0][1] - seg[0][0] - seg[1][0],
                         seg[0][1] - seg[0][0] + seg[1][1] - seg[1][0]
                             - seg[2][0]};
    const int off1 = seg[0][1] + base[0], off2 = seg[1][1] + base[1];
#pragma unroll 4
    for (int s = tid; s < total; s += kBlock) {
      const int g = s - base[s < off1 ? 0 : (s < off2 ? 1 : 2)];
      rec[s] = load_record<PHASE>(pos, alive, p0, p1, g);
      rkey[s] = __ldg(skey + g);
    }
    __syncthreads();
    if (live) {
      auto keys = [&](int k) { return rkey[k]; };
      auto record = [&](int k) { return rec[k]; };
      // the particle lies in its own row's range, at stage index i +
      // base[0]; the other rows' ranges cannot hold it
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if (!open[r]) continue;
        add(walk<PHASE>(keys, record, seg[r][0] + base[r],
                        seg[r][1] + base[r], lo_key[r], hi_key[r],
                        r == 0 ? i + base[0] : -1, px, py, my0, my1, sc));
      }
    }
  } else if (live) {
    auto keys = [&](int g) { return __ldg(skey + g); };
    auto record = [&](int g) {
      return load_record<PHASE>(pos, alive, p0, p1, g);
    };
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (!open[r]) continue;
      add(walk<PHASE>(keys, record, seg[r][0], seg[r][1], lo_key[r],
                      hi_key[r], i, px, py, my0, my1, sc));
    }
  }
  if (i < n) {
    out[2 * i] = ox;
    out[2 * i + 1] = oy;
  }
}

// K3 batched for small worlds. A group of threads takes `lanes` lanes of
// one world (a multiple of 32, at most kSmallLanes) with three threads a
// lane, one for each of its ranges (d = 0, +1, -1; a warp serves one d):
// 3 x lanes threads. A world of n lanes takes ceil(n / lanes) groups, and
// groups_per_cta groups share a CTA where one group covers a world. Each
// group copies its world's whole table into the CTA's dynamic shared
// memory (a 16-byte record and a key a lane, small_group_bytes), then
// each thread finds its range by binary search in shared memory and walks
// it there: no search in global memory, no union bracket, no global path.
// The brackets follow from the sorted order: the own row's range holds
// the lane itself, the row above's lies after it and the row below's
// before it (their keys are all greater or all less than the lane's, the
// y = 0 wrap included, as a row outside the 16-bit range is never
// searched). The three range sums meet in shared memory and the d = 0
// thread adds them in the twin's order; each is the grid kernel's sum of
// the same candidates in the same order, so a world equals window_kernel's
// result bit for bit.
template <int PHASE>
__global__ void __launch_bounds__(kSmallThreads, 2) window_small_kernel(
    const float* __restrict__ pos, const int* __restrict__ skey,
    const bool* __restrict__ alive, const float* __restrict__ p0,
    const float* __restrict__ p1, const float* __restrict__ scalars,
    float* __restrict__ out, int n, int n_worlds, int lanes) {
  extern __shared__ float4 small_table[];
  const int group_threads = 3 * lanes;
  const int groups = blockDim.x / group_threads;
  const int g = threadIdx.x / group_threads;
  const int t = threadIdx.x - g * group_threads;
  const int r = t / lanes;  // this thread's range: d = 0, +1, -1
  const int blocks = (n + lanes - 1) / lanes;  // a world's groups
  const int q = blockIdx.x * groups + g;
  const int world = q / blocks;
  const int i = (q - world * blocks) * lanes + (t - r * lanes);
  // this group's table (n4 records, then n4 keys), after all of them the
  // groups' range sums, one a thread
  const int n4 = (n + 3) & ~3;
  float4* rec = small_table + static_cast<size_t>(g) * (n4 / 4) * 5;
  int* keys = reinterpret_cast<int*>(rec + n4);
  float2* part = reinterpret_cast<float2*>(
      small_table + static_cast<size_t>(groups) * (n4 / 4) * 5) +
      g * group_threads;
  const bool has_world = world < n_worlds;
  const size_t base = static_cast<size_t>(world) * n;
  if (has_world) {
    pos += 2 * base;
    skey += base;
    alive += base;
    p0 += base;
    p1 += base;
    out += 2 * base;
    scalars += 8 * static_cast<size_t>(world);
#pragma unroll 4
    for (int k = t; k < n; k += group_threads) {
      rec[k] = load_record<PHASE>(pos, alive, p0, p1, k);
      keys[k] = __ldg(skey + k);
    }
  }
  __syncthreads();
  const bool live = has_world && i < n && alive[i];
  const int key = live ? keys[i] : 0;
  float2 v = make_float2(0.0f, 0.0f);
  int lo_key, hi_key;
  if (row_range(key, live, r == 0 ? 0 : (r == 1 ? 1 : -1), lo_key,
                hi_key)) {
    const K3Scalars sc{scalars[0], scalars[1], scalars[2], scalars[3],
                       scalars[4]};
    // the lane's own record holds what the phase reads of it (the
    // weight reads no p0 / p1, the pressure no p1)
    const float4 me = rec[i];
    auto key_at = [&](int k) { return keys[k]; };
    auto record = [&](int k) { return rec[k]; };
    // the range [s, e): the own row's starts at or before i and ends
    // after it, the row above's lies in [i + 1, n), the row below's in
    // [0, i)
    const int s = bound(key_at, r == 1 ? i + 1 : 0, r == 1 ? n : i,
                        lo_key, false);
    const int e = bound(key_at, r == 0 ? i + 1 : s, r == 2 ? i : n,
                        hi_key, true);
    v = walk_span<PHASE>(record, s, e, r == 0 ? i : -1, me.x, me.y, me.z,
                         me.w, sc);
  }
  part[t] = v;
  __syncthreads();
  if (r != 0 || !has_world || i >= n) return;
  float ox = 0.0f, oy = 0.0f;
  const int drow[3] = {0, 1, -1};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (row_range(key, live, drow[d], lo_key, hi_key))
      add_range<PHASE>(part[t + d * lanes], ox, oy);
  }
  reinterpret_cast<float2*>(out)[i] = make_float2(ox, oy);
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

// (key, lane) as one int64 whose order is the lexicographic order
__device__ __forceinline__ long long key_lane(int key, int lane) {
  return static_cast<long long>(key) * 4294967296LL + lane;
}

__global__ void __launch_bounds__(kBlock) rank_kernel(
    const int* __restrict__ newkey, const int* __restrict__ offs,
    int* __restrict__ rank, int n, int rb) {
  __shared__ long long own[kBlock];  // the block's pairs, sorted
  __shared__ int hist[kBlock];       // window lanes by c_e (< 256)
  __shared__ int warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int i = blockIdx.x * kBlock + tid;
  const int off = offs[blockIdx.x];

  // bitonic sort of the block's (key, lane) pairs, ascending
  long long v = key_lane(i < n ? newkey[i] : INT_MAX, i);
  for (int k = 2; k <= kBlock; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      long long other;
      if (j >= 32) {
        own[tid] = v;
        __syncthreads();
        other = own[tid ^ j];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(kFull, v, j);
      }
      const bool ascending = (tid & k) == 0;
      const bool lower = (tid & j) == 0;
      v = (lower == ascending) ? min(v, other) : max(v, other);
    }
  }
  own[tid] = v;
  hist[tid] = 0;
  __syncthreads();

  // place every window lane against the sorted pairs
  const long long first = own[0];
  const long long last = own[kBlock - 1];
  int below = 0;
#pragma unroll 4
  for (int t = tid; t < rb; t += kBlock) {
    const int g = off + t;
    const long long e = key_lane(g < n ? __ldg(newkey + g) : INT_MAX, g);
    if (e < first) {
      ++below;
    } else if (e < last) {
      // c_e = #{s : own[s] <= e}, in [1, 255]
      int lo = 1, hi = kBlock - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (own[mid] <= e) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      atomicAdd(&hist[lo], 1);
    }
  }
  for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(kFull, below, o);
  if (wl == 0) atomicAdd(&hist[0], below);
  __syncthreads();

  // count_s = hist[0] + ... + hist[s]: an inclusive prefix sum over the block
  int c = hist[tid];
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, c, o);
    if (wl >= o) c += x;
  }
  if (wl == 31) warp_sum[tid >> 5] = c;
  __syncthreads();
  for (int w = 0; w < (tid >> 5); ++w) c += warp_sum[w];
  const int lane = static_cast<int>(v - (v >> 32) * 4294967296LL);
  if (lane < n) rank[lane] = off + c;
}

}  // namespace

namespace {

int launch_window(const float* pos, const int* skey, const bool* alive,
                  const float* p0, const float* p1, const float* scalars,
                  float* out, int* paths, int n, int n_worlds, int phase,
                  void* stream) {
  if (n <= 0 || n_worlds <= 0) return 0;
  if (n_worlds > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlock - 1) / kBlock, n_worlds);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case PH_WEIGHT:
      window_kernel<PH_WEIGHT><<<grid, kBlock, 0, s>>>(
          pos, skey, alive, p0, p1, scalars, out, n, paths);
      break;
    case PH_PRESSURE:
      window_kernel<PH_PRESSURE><<<grid, kBlock, 0, s>>>(
          pos, skey, alive, p0, p1, scalars, out, n, paths);
      break;
    case PH_DAMPING:
      window_kernel<PH_DAMPING><<<grid, kBlock, 0, s>>>(
          pos, skey, alive, p0, p1, scalars, out, n, paths);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int PHASE>
cudaError_t launch_small_phase(dim3 grid, int threads, size_t smem,
                               cudaStream_t s, const float* pos,
                               const int* skey, const bool* alive,
                               const float* p0, const float* p1,
                               const float* scalars, float* out, int n,
                               int n_worlds, int lanes) {
  // a CTA's dynamic shared memory above 48 KB must be opted in to: once
  static bool opted = false;
  if (!opted) {
    const cudaError_t rc = cudaFuncSetAttribute(
        window_small_kernel<PHASE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemMax));
    if (rc != cudaSuccess) return rc;
    opted = true;
  }
  window_small_kernel<PHASE><<<grid, threads, smem, s>>>(
      pos, skey, alive, p0, p1, scalars, out, n, n_worlds, lanes);
  return cudaGetLastError();
}

// The small kernel's CTA at (n, lanes, groups_per_cta): its threads and
// shared memory; false where the kernel does not take that shape (its
// shared memory may still be more than a CTA can have).
bool small_shape(int n, int lanes, int groups_per_cta, int* threads,
                 size_t* smem) {
  if (n <= 0 || lanes < 32 || lanes % 32 != 0 || lanes > kSmallLanes
      || groups_per_cta < 1
      || 3 * lanes * groups_per_cta > kSmallThreads
      || (groups_per_cta > 1 && lanes < n))
    return false;
  *threads = 3 * lanes * groups_per_cta;
  *smem = groups_per_cta * small_group_bytes(n, lanes);
  return true;
}

int launch_window_small(const float* pos, const int* skey, const bool* alive,
                        const float* p0, const float* p1,
                        const float* scalars, float* out, int n,
                        int n_worlds, int lanes, int groups_per_cta,
                        int phase, void* stream) {
  if (n <= 0 || n_worlds <= 0) return 0;
  int threads;
  size_t smem;
  if (!small_shape(n, lanes, groups_per_cta, &threads, &smem)
      || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups =
      static_cast<long long>(n_worlds) * ((n + lanes - 1) / lanes);
  const dim3 grid(
      static_cast<unsigned>((groups + groups_per_cta - 1) / groups_per_cta));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case PH_WEIGHT:
      return static_cast<int>(launch_small_phase<PH_WEIGHT>(
          grid, threads, smem, s, pos, skey, alive, p0, p1, scalars, out, n,
          n_worlds, lanes));
    case PH_PRESSURE:
      return static_cast<int>(launch_small_phase<PH_PRESSURE>(
          grid, threads, smem, s, pos, skey, alive, p0, p1, scalars, out, n,
          n_worlds, lanes));
    case PH_DAMPING:
      return static_cast<int>(launch_small_phase<PH_DAMPING>(
          grid, threads, smem, s, pos, skey, alive, p0, p1, scalars, out, n,
          n_worlds, lanes));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// pos (n, 2) f32, skey (n) i32 ascending, alive (n) bool, p0 / p1 (n) f32,
// scalars (8) f32, out (n, 2) f32. phase: 0 weight, 1 pressure, 2 damping.
// paths: null, or (2) i32 to which the blocks that walked staged
// candidates (paths[0]) and global ones (paths[1]) are added.
extern "C" int b2t_particle_window(const float* pos, const int* skey,
                                   const bool* alive, const float* p0,
                                   const float* p1, const float* scalars,
                                   float* out, int* paths, int n, int phase,
                                   void* stream) {
  return launch_window(pos, skey, alive, p0, p1, scalars, out, paths, n, 1,
                       phase, stream);
}

// The same for n_worlds tables in one launch: pos (W, n, 2), skey, alive,
// p0, p1 (W, n), scalars (W, 8) one row a world, out (W, n, 2); paths
// counts the blocks of all worlds. n_worlds <= 65535 (the grid's y).
extern "C" int b2t_particle_window_batched(
    const float* pos, const int* skey, const bool* alive, const float* p0,
    const float* p1, const float* scalars, float* out, int* paths, int n,
    int n_worlds, int phase, void* stream) {
  return launch_window(pos, skey, alive, p0, p1, scalars, out, paths, n,
                       n_worlds, phase, stream);
}

// The same function on window_small_kernel: `lanes` lanes of a world a
// group of 3 x lanes threads (lanes a multiple of 32, at most 256),
// groups_per_cta groups a CTA (at most 768 threads; more than one only
// where a group covers a world), each group's world table and range sums
// in shared memory (at most 227 KB a CTA); else cudaErrorInvalidValue.
extern "C" int b2t_particle_window_small(
    const float* pos, const int* skey, const bool* alive, const float* p0,
    const float* p1, const float* scalars, float* out, int n, int n_worlds,
    int lanes, int groups_per_cta, int phase, void* stream) {
  return launch_window_small(pos, skey, alive, p0, p1, scalars, out, n,
                             n_worlds, lanes, groups_per_cta, phase, stream);
}

// How window_small_kernel<phase> runs at that shape: out[0] the shared
// memory a CTA (bytes), out[1] the CTAs an SM holds at once (0 where
// out[0] is more than a CTA can have: the kernel does not take it),
// out[2] the registers a thread, out[3] the local (spill) bytes a thread.
extern "C" int b2t_particle_window_small_shape(int n, int lanes,
                                               int groups_per_cta, int phase,
                                               int* out) {
  int threads;
  size_t smem;
  if (!small_shape(n, lanes, groups_per_cta, &threads, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn =
      phase == PH_WEIGHT ? reinterpret_cast<const void*>(
                               window_small_kernel<PH_WEIGHT>)
      : phase == PH_PRESSURE ? reinterpret_cast<const void*>(
                                   window_small_kernel<PH_PRESSURE>)
                             : reinterpret_cast<const void*>(
                                   window_small_kernel<PH_DAMPING>);
  cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemMax));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int ctas = 0;
  if (smem <= kSmemMax) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                       smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = static_cast<int>(smem);
  out[1] = ctas;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// newkey (n) i32, offs (n_blocks) i32 with n_blocks = ceil(n / 256),
// rank (n) i32; rb <= 12288, the wrapper's contract.
extern "C" int b2t_particle_rank(const int* newkey, const int* offs,
                                 int* rank, int n, int rb, void* stream) {
  if (n <= 0) return 0;
  const int n_blocks = (n + kBlock - 1) / kBlock;
  rank_kernel<<<n_blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      newkey, offs, rank, n, rb);
  return static_cast<int>(cudaGetLastError());
}
