// Multi-channel inclusive prefix-max scan (int32).
//
// Replaces: csa_tpu/index/mscan.py:_mscan_kernel (Pallas, TPU), reached
// through multi_cummax / multi_cummin from the collect cascade
// (csa_tpu/index/engine.py:_collect_front): PACK_W forward and PACK_W
// backward threshold scans, and k per-sequence last-occurrence scans
// reduced by a min over channels.
//
// Bound on this card: device memory bandwidth.  A scan reads M*N*4 bytes
// and writes M*N*4 (or N*4 with the min); the arithmetic is one max per
// element.  The TPU kernel walked the array with a sequential grid and
// carried the running max in scratch; here blocks run in parallel in no
// order, so the carry comes from a separate pass:
//   1. tile_max:  one block per (tile, channel) writes the tile's maximum;
//   2. scan:      each block folds the maxima of its channel's earlier
//                 tiles into a carry, scans its tile in registers (8 items
//                 a thread), across the warp with __shfl_up_sync and across
//                 warps through shared memory, then applies the carry.
// Every element is read twice and written once.  `reverse` is index
// arithmetic (logical position p lives at N-1-p), never a copy.  With
// `reduce_min` one block owns one tile across ALL channels and keeps the
// running minimum in registers, so the (N,) result is written once, with
// no atomics.  Positions past N are never loaded into a real lane's
// prefix (they follow every real position in scan order) and never
// written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 elements per block
constexpr int kWarps = kThreads / 32;
constexpr int32_t kNeg = -2147483647;     // -(2^31) + 1: the max identity
constexpr int32_t kPosInf = 2147483647;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long phys(long long p, long long n, int rev) {
  return rev ? n - 1 - p : p;
}

// Block-wide max; every thread gets the result.  `sh` holds kWarps ints.
__device__ __forceinline__ int32_t block_max(int32_t v, int32_t* sh) {
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  int32_t r = sh[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = max(r, sh[w]);
  __syncthreads();
  return r;
}

__global__ void tile_max_kernel(const int32_t* __restrict__ x,
                                int32_t* __restrict__ tmax, long long n,
                                int ntiles, int rev) {
  __shared__ int32_t sh[kWarps];
  const int tile = blockIdx.x;
  const int m = blockIdx.y;
  const int32_t* row = x + (long long)m * n;
  const long long p0 = (long long)tile * kTile;
  int32_t v = kNeg;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long p = p0 + i;
    if (p < n) v = max(v, row[phys(p, n, rev)]);
  }
  v = block_max(v, sh);
  if (threadIdx.x == 0) tmax[(long long)m * ntiles + tile] = v;
}

__global__ void scan_kernel(const int32_t* __restrict__ x,
                            const int32_t* __restrict__ tmax,
                            int32_t* __restrict__ out, int M, long long n,
                            int ntiles, int rev, int reduce_min) {
  __shared__ int32_t sh[kWarps];
  __shared__ int32_t warp_tot[kWarps];
  const int tile = blockIdx.x;
  const int m_lo = reduce_min ? 0 : blockIdx.y;
  const int m_hi = reduce_min ? M : m_lo + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p0 = (long long)tile * kTile + (long long)threadIdx.x * kItems;

  int32_t vmin[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) vmin[i] = kPosInf;

  for (int m = m_lo; m < m_hi; ++m) {
    // carry: max over this channel's earlier tiles (later ones if reversed,
    // which is the same thing in logical order)
    int32_t carry = kNeg;
    const int32_t* trow = tmax + (long long)m * ntiles;
    for (int t = threadIdx.x; t < tile; t += kThreads) carry = max(carry, trow[t]);
    carry = block_max(carry, sh);

    const int32_t* row = x + (long long)m * n;
    int32_t v[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long p = p0 + i;
      v[i] = p < n ? row[phys(p, n, rev)] : kNeg;
    }
#pragma unroll
    for (int i = 1; i < kItems; ++i) v[i] = max(v[i], v[i - 1]);

    int32_t tot = v[kItems - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, tot, off);
      if (lane >= off) tot = max(tot, y);
    }
    int32_t excl = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) excl = kNeg;
    if (lane == 31) warp_tot[warp] = tot;
    __syncthreads();
    int32_t pre = max(excl, carry);
    for (int w = 0; w < warp; ++w) pre = max(pre, warp_tot[w]);
    __syncthreads();  // warp_tot is rewritten by the next channel

    if (reduce_min) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) vmin[i] = min(vmin[i], max(v[i], pre));
    } else {
      int32_t* orow = out + (long long)m * n;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const long long p = p0 + i;
        if (p < n) orow[phys(p, n, rev)] = max(v[i], pre);
      }
    }
  }
  if (reduce_min) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long p = p0 + i;
      if (p < n) out[phys(p, n, rev)] = vmin[i];
    }
  }
}

}  // namespace

// x: (M, n) int32 row-major; out: (M, n) int32, or (n,) with reduce_min;
// tmax: scratch of M * ceil(n / 2048) int32.  Returns cudaGetLastError().
extern "C" int csa_mscan(const void* x, void* out, void* tmax, int M,
                         long long n, int rev, int reduce_min, void* stream) {
  if (M <= 0 || n <= 0) return cudaSuccess;
  const long long ntiles_ll = (n + kTile - 1) / kTile;
  if (ntiles_ll > 2147483647LL || M > 65535) return cudaErrorInvalidValue;
  const int ntiles = static_cast<int>(ntiles_ll);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_max_kernel<<<dim3(ntiles, M), kThreads, 0, s>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(tmax), n, ntiles,
      rev);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  scan_kernel<<<dim3(ntiles, reduce_min ? 1 : M), kThreads, 0, s>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(tmax),
      static_cast<int32_t*>(out), M, n, ntiles, rev, reduce_min);
  return cudaGetLastError();
}
