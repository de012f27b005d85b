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
// K3, window_kernel: replaces box2d_tpu/particles_pallas.py `_kernel`
// (window_pass). For each sorted particle i, a sum over the live j != i in
// rows row_i - 1 .. row_i + 1 within one diameter (d^2 < D^2):
//   weight   sum (1 - d/D)
//   pressure -sum vel_per_p * w * (p0_i + p0_j) * n
//   damping  sum over approaching pairs of max(lin*w, min(-quad*vn, 0.5))*vn*n
// with n the unit vector i -> j. Gather only: each thread writes its own
// particle's row; there are no atomics, so the result is deterministic.
//
// The TPU kernel processes blocks of 256 sorted lanes against three
// 128-aligned bands of 512/768 lanes DMA'd into VMEM, evaluates every band
// lane (a dense masked (256, L) compute on the vector unit), selects its
// own rows with a one-hot matmul, and flags a block whose bands do not
// cover its neighbour cells. None of that is carried over. Here one thread
// per sorted particle finds its three key ranges, (row + d, col - 1) ..
// (row + d, col + 1) for d = 0, +1, -1, by binary search over the sorted
// keys (row + d outside the 16-bit row range is skipped) and walks them in
// lane order. It visits every neighbour, so nothing is ever truncated and
// there is no coverage flag.
//
// What bounds it: at dam_break-100k each particle has ~5 candidates in
// its three ranges (~1.8 particles per cell), so the pass reads ~28 bytes
// per candidate and does ~25 float operations per candidate: a few MB and
// a few tens of MFLOP, microseconds on this card. The binary searches (17
// dependent loads each) and the scattered candidate reads are latency,
// not bandwidth: consecutive threads walk overlapping ranges, so the reads
// hit L1/L2. Staging each block's union of ranges in shared memory is the
// next step, not this one.
//
// ---------------------------------------------------------------------------
// K4, rank_kernel: replaces box2d_tpu/particles_pallas.py `_rank_kernel`
// (rank_pass). Particles move at most one cell per sub-iteration, so the
// table sorted by last sub-iteration's keys is nearly sorted by the new
// ones, and the new sorted position of lane i is
//   rank_i = off_b + #{ j in [off_b, off_b + rb) : (key_j, j) < (key_i, i) }
// for i in block b (256 lanes), with off_b from rank_offsets (the caller
// checks that the window covers what it must; then this equals the inverse
// permutation of the stable argsort). Lanes at or past n sort last.
//
// The TPU kernel splits the keys into two exact f32 halves (Mosaic rejects
// narrow int32 side inputs) and selects its own keys with a one-hot
// matmul. Here the block stages its window of rb int32 keys (16 KB at
// rb = 4096) in shared memory once, and each thread compares its own int32
// key against all of them; every warp reads the same word at a time, a
// shared-memory broadcast.
//
// What bounds it: 256 x rb compares per block, 391 blocks at 100k: about
// 4e8 compares, an integer-throughput bound of tens of microseconds; the
// bytes (0.4 MB of keys in, 0.4 MB of ranks out) are far below that.
// ---------------------------------------------------------------------------

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

enum Phase { PH_WEIGHT = 0, PH_PRESSURE = 1, PH_DAMPING = 2 };

// first index in [0, n) whose key is >= target (n if none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int n, int target) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// scalars: [inv_diameter, diameter^2, lin_damping, quad_damping, vel_per_p]
template <int PHASE>
__global__ void __launch_bounds__(kBlock) window_kernel(
    const float* __restrict__ pos, const int* __restrict__ skey,
    const bool* __restrict__ alive, const float* __restrict__ p0,
    const float* __restrict__ p1, const float* __restrict__ scalars,
    float* __restrict__ out, int n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  float ox = 0.0f, oy = 0.0f;
  if (alive[i]) {
    const float inv_d = scalars[0];
    const float d2max = scalars[1];
    const float lin_d = scalars[2];
    const float quad_d = scalars[3];
    const float vel_per_p = scalars[4];
    const int key = skey[i];
    const int row = key >> 16;
    const int col = key & 0xFFFF;
    const float px = pos[2 * i];
    const float py = pos[2 * i + 1];
    const float my0 = p0[i];
    const float my1 = p1[i];
    // same row, row above, row below: the order the twin sums them in
    const int drow[3] = {0, 1, -1};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const long long R = static_cast<long long>(row) + drow[r];
      if (R < -32768 || R > 32767) continue;
      const int lo_key = static_cast<int>(R * 65536 + (col > 0 ? col - 1 : 0));
      const int hi_key =
          static_cast<int>(R * 65536 + (col < 0xFFFF ? col + 1 : 0xFFFF));
      float sx = 0.0f, sy = 0.0f;
      for (int j = lower_bound(skey, n, lo_key); j < n && skey[j] <= hi_key;
           ++j) {
        if (j == i || !alive[j]) continue;
        const float dx = pos[2 * j] - px;
        const float dy = pos[2 * j + 1] - py;
        const float d2 = dx * dx + dy * dy;
        if (!(d2 < d2max)) continue;
        const float invdist = d2 > 0.0f ? 1.0f / sqrtf(fmaxf(d2, 1e-30f))
                                        : 0.0f;
        const float w = 1.0f - d2 * invdist * inv_d;
        if (PHASE == PH_WEIGHT) {
          sx = sx + w;
        } else {
          const float nx = dx * invdist;
          const float ny = dy * invdist;
          if (PHASE == PH_PRESSURE) {
            const float fh = vel_per_p * w * (my0 + p0[j]);
            sx = sx + fh * nx;
            sy = sy + fh * ny;
          } else {
            const float vn = (p0[j] - my0) * nx + (p1[j] - my1) * ny;
            if (vn < 0.0f) {
              const float damp = fmaxf(lin_d * w, fminf(-quad_d * vn, 0.5f));
              const float f = damp * vn;
              sx = sx + f * nx;
              sy = sy + f * ny;
            }
          }
        }
      }
      if (PHASE == PH_PRESSURE) {
        ox = ox + -sx;
        oy = oy + -sy;
      } else {
        ox = ox + sx;
        oy = oy + sy;
      }
    }
  }
  out[2 * i] = ox;
  out[2 * i + 1] = oy;
}

__global__ void __launch_bounds__(kBlock) rank_kernel(
    const int* __restrict__ newkey, const int* __restrict__ offs,
    int* __restrict__ rank, int n, int rb) {
  extern __shared__ int win[];
  const int off = offs[blockIdx.x];
  for (int t = threadIdx.x; t < rb; t += kBlock) {
    const int g = off + t;
    win[t] = g < n ? newkey[g] : INT_MAX;
  }
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const int ki = newkey[i];
  const int own = i - off;   // window lanes t < own have j < i
  int count = 0;
  for (int t = 0; t < rb; ++t) {
    const int kj = win[t];
    count += (kj < ki) | ((kj == ki) & (t < own));
  }
  rank[i] = off + count;
}

}  // namespace

// pos (n, 2) f32, skey (n) i32 ascending, alive (n) bool, p0 / p1 (n) f32,
// scalars (8) f32, out (n, 2) f32. phase: 0 weight, 1 pressure, 2 damping.
extern "C" int b2t_particle_window(const float* pos, const int* skey,
                                   const bool* alive, const float* p0,
                                   const float* p1, const float* scalars,
                                   float* out, int n, int phase,
                                   void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case PH_WEIGHT:
      window_kernel<PH_WEIGHT><<<grid, kBlock, 0, s>>>(pos, skey, alive, p0,
                                                       p1, scalars, out, n);
      break;
    case PH_PRESSURE:
      window_kernel<PH_PRESSURE><<<grid, kBlock, 0, s>>>(pos, skey, alive, p0,
                                                         p1, scalars, out, n);
      break;
    case PH_DAMPING:
      window_kernel<PH_DAMPING><<<grid, kBlock, 0, s>>>(pos, skey, alive, p0,
                                                        p1, scalars, out, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// newkey (n) i32, offs (n_blocks) i32 with n_blocks = ceil(n / 256),
// rank (n) i32; rb <= 12288 (the window's keys live in shared memory).
extern "C" int b2t_particle_rank(const int* newkey, const int* offs,
                                 int* rank, int n, int rb, void* stream) {
  if (n <= 0) return 0;
  const int n_blocks = (n + kBlock - 1) / kBlock;
  rank_kernel<<<n_blocks, kBlock, rb * sizeof(int),
                static_cast<cudaStream_t>(stream)>>>(newkey, offs, rank, n,
                                                     rb);
  return static_cast<int>(cudaGetLastError());
}
