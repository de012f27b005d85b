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
// candidate of any lane. Returns the range's sums.
template <int PHASE, typename Keys, typename Records>
__device__ __forceinline__ float2 walk(Keys keys, Records record, int lo,
                                       int end, int lo_key, int hi_key,
                                       int own, float px, float py,
                                       float my0, float my1,
                                       const K3Scalars& sc) {
  const int s = bound(keys, lo, end, lo_key, false);
  const int e = bound(keys, s, end, hi_key, true);
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
  const int row = key >> 16;
  const int col = key & 0xFFFF;
  const int drow[3] = {0, 1, -1};
  int lo_key[3], hi_key[3];
  bool open[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const long long R = static_cast<long long>(row) + drow[r];
    open[r] = live && R >= -32768 && R <= 32767;
    lo_key[r] = open[r]
        ? static_cast<int>(R * 65536 + (col > 0 ? col - 1 : 0)) : INT_MAX;
    hi_key[r] = open[r]
        ? static_cast<int>(R * 65536 + (col < 0xFFFF ? col + 1 : 0xFFFF))
        : INT_MIN;
  }
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
  auto add = [&](float2 v) {
    if (PHASE == PH_PRESSURE) {
      ox = ox + -v.x;
      oy = oy + -v.y;
    } else {
      ox = ox + v.x;
      oy = oy + v.y;
    }
  };
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
