// Multi-channel inclusive prefix scans (int32): running max or running min.
//
// Replaces: csa_tpu/index/mscan.py:_mscan_kernel (Pallas, TPU), reached
// through multi_cummax / multi_cummin from the collect cascade
// (csa_tpu/index/engine.py:_collect_front): PACK_W forward max scans,
// PACK_W backward min scans, and k per-sequence last-occurrence scans
// reduced by a min over channels.
//
// Bound on this card: device memory bandwidth.  A scan reads M*N*4 bytes
// and writes M*N*4 (or N*4 with the reduction over channels); the
// arithmetic is one max or min an element.  Design, for that: one kernel
// that reads every element once and writes it once, a single-pass chained
// scan with decoupled look-back (Merrill & Garland, 2016).
//
//   Tiles.  Each channel is cut into tiles of kTile = 4096 elements, one
//   block a tile (256 threads x 16 items).  The block loads its tile
//   striped (thread t takes words t, t + 256, ..., as 16-byte loads where
//   the row allows it), so every warp's load is one contiguous line, into
//   shared memory, then each thread scans 16 consecutive items in
//   registers, the warp scans the threads' totals by shuffles and the
//   block the warps' totals through shared memory.  The store goes back
//   the same way.  The shared tile is swizzled by 16-byte units, so both
//   the striped and the blocked accesses are free of bank conflicts.
//   `reverse` is index arithmetic: the tile's physical words are loaded in
//   order and read back to front, never copied.
//
//   Tickets.  Tiles are numbered by an atomic ticket, not by blockIdx, so
//   a tile's predecessors always hold lower tickets and are already
//   running (csrc/tile_dp.cuh makes the same argument); no deadlock at any
//   residency, also beside other launches.  Without the reduction the
//   tickets run tile-major across channels (ticket = tile * M + channel).
//
//   Look-back.  A tile publishes its aggregate, then its inclusive prefix,
//   each as one 64-bit word (status in the high half, value in the low)
//   with a release store.  Warp 0 reads the descriptors of the 32 tiles
//   before its own with acquire loads, one a lane, waits until all of
//   them hold something, folds everything up to the nearest inclusive
//   prefix, and moves back 32 tiles if none of them had one.  The operator is idempotent, so any mix of aggregates
//   and prefixes gives the same carry.  Descriptors and the ticket are
//   zeroed by one cudaMemsetAsync in the C entry.
//
//   Operators.  The scan is a template on max or min with its identity, so
//   multi_cummin launches the kernel directly, without negation.  With the
//   reduction over channels (min over max scans, max over min scans) a
//   block owns one tile across all channels: it scans the channels in
//   turn, each with its own look-back chain, keeps the running reduction
//   in registers, and writes the (N,) result once, with no atomics.
//
// Positions past N are loaded as the identity: they follow every real
// position in scan order, change no aggregate, and are never stored.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096 elements a block
constexpr int kUnits = kTile / 4;         // 16-byte units a tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

struct MaxOp {
  static constexpr int32_t kIdentity = INT32_MIN;
  __device__ __forceinline__ static int32_t f(int32_t a, int32_t b) {
    return max(a, b);
  }
};

struct MinOp {
  static constexpr int32_t kIdentity = INT32_MAX;
  __device__ __forceinline__ static int32_t f(int32_t a, int32_t b) {
    return min(a, b);
  }
};

template <class Op> struct Dual;
template <> struct Dual<MaxOp> { using type = MinOp; };
template <> struct Dual<MinOp> { using type = MaxOp; };

__device__ __forceinline__ unsigned long long ld_acquire64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release64(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Shared word of tile word w: 16-byte unit u = w / 4 sits in its row of
// 8 units at column (u mod 8) xor (row mod 8).
__device__ __forceinline__ int swz(int w) {
  const int u = w >> 2;
  return (((u & ~7) | ((u & 7) ^ ((u >> 3) & 7))) << 2) | (w & 3);
}

// The tile's physical words [base, base + kTile) of row `row` (those
// inside [0, n); the others take `fill`) as thread t's share of them:
// words t + 256 r, or with `vec` the 16-byte units t + 256 r.
struct Fetch {
  int32_t v[kItems];
};

__device__ __forceinline__ void fetch_tile(const int32_t* __restrict__ row,
                                           long long base, long long n,
                                           bool vec, int32_t fill,
                                           Fetch& f) {
  if (vec) {  // base and n are multiples of 4, row 16-byte aligned
#pragma unroll
    for (int r = 0; r < kUnits / kThreads; ++r) {
      const long long p = base + 4 * (threadIdx.x + r * kThreads);
      int4 x = make_int4(fill, fill, fill, fill);
      if (p >= 0 && p < n) x = *reinterpret_cast<const int4*>(row + p);
      f.v[4 * r] = x.x; f.v[4 * r + 1] = x.y; f.v[4 * r + 2] = x.z;
      f.v[4 * r + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const long long p = base + threadIdx.x + r * kThreads;
      f.v[r] = (p >= 0 && p < n) ? row[p] : fill;
    }
  }
}

// Thread t's share of the tile into the swizzled shared tile.
__device__ __forceinline__ void put_tile(const Fetch& f, bool vec,
                                         int32_t* sh) {
  if (vec) {
#pragma unroll
    for (int r = 0; r < kUnits / kThreads; ++r)
      *reinterpret_cast<int4*>(sh + swz(4 * (threadIdx.x + r * kThreads))) =
          make_int4(f.v[4 * r], f.v[4 * r + 1], f.v[4 * r + 2],
                    f.v[4 * r + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < kItems; ++r)
      sh[swz(threadIdx.x + r * kThreads)] = f.v[r];
  }
}

__device__ __forceinline__ void store_tile(int32_t* __restrict__ row,
                                           long long base, long long n,
                                           bool vec, const int32_t* sh) {
  if (vec) {
#pragma unroll
    for (int r = 0; r < kUnits / kThreads; ++r) {
      const int u = threadIdx.x + r * kThreads;
      const long long p = base + 4 * u;
      if (p >= 0 && p < n)
        *reinterpret_cast<int4*>(row + p) =
            *reinterpret_cast<const int4*>(sh + swz(4 * u));
    }
  } else {
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const long long p = base + threadIdx.x + r * kThreads;
      if (p >= 0 && p < n) row[p] = sh[swz(threadIdx.x + r * kThreads)];
    }
  }
}

// Thread t's items are the tile's logical positions 16 t .. 16 t + 15;
// logical q lives at shared word q, or kTile - 1 - q when reversed.
__device__ __forceinline__ void read_items(const int32_t* sh, bool rev,
                                           int32_t (&v)[kItems]) {
#pragma unroll
  for (int k = 0; k < kItems / 4; ++k) {
    const int u = threadIdx.x * (kItems / 4) + k;
    if (rev) {
      const int4 x = *reinterpret_cast<const int4*>(
          sh + swz(4 * (kUnits - 1 - u)));
      v[4 * k] = x.w; v[4 * k + 1] = x.z; v[4 * k + 2] = x.y;
      v[4 * k + 3] = x.x;
    } else {
      const int4 x = *reinterpret_cast<const int4*>(sh + swz(4 * u));
      v[4 * k] = x.x; v[4 * k + 1] = x.y; v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
  }
}

__device__ __forceinline__ void write_items(int32_t* sh, bool rev,
                                            const int32_t (&v)[kItems]) {
#pragma unroll
  for (int k = 0; k < kItems / 4; ++k) {
    const int u = threadIdx.x * (kItems / 4) + k;
    if (rev) {
      *reinterpret_cast<int4*>(sh + swz(4 * (kUnits - 1 - u))) =
          make_int4(v[4 * k + 3], v[4 * k + 2], v[4 * k + 1], v[4 * k]);
    } else {
      *reinterpret_cast<int4*>(sh + swz(4 * u)) =
          make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  }
}

// The exclusive carry of tile `tile` of one channel's chain `desc`, after
// publishing the tile's aggregate; then its inclusive prefix.  Called by
// warp 0; every lane returns the carry.
template <class Op>
__device__ __forceinline__ int32_t look_back(unsigned long long* desc,
                                             int tile, int32_t agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) st_release64(desc, kPrefix | (uint32_t)agg);
    return Op::kIdentity;
  }
  if (lane == 0) st_release64(desc + tile, kAggregate | (uint32_t)agg);
  int32_t carry = Op::kIdentity;
  for (int pos = tile - 1;; pos -= 32) {
    const int idx = pos - lane;  // lane 0 is the nearest predecessor
    unsigned long long d = kPrefix | (uint32_t)Op::kIdentity;
    if (idx >= 0) {
      d = ld_acquire64(desc + idx);
      while ((d >> 32) == 0) {
        __nanosleep(32);
        d = ld_acquire64(desc + idx);
      }
    }
    const unsigned prefixes = __ballot_sync(kFull, (d >> 32) == 2);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    int32_t v = lane <= stop ? (int32_t)(uint32_t)d : Op::kIdentity;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = Op::f(v, __shfl_xor_sync(kFull, v, off));
    carry = Op::f(carry, v);
    if (prefixes) break;
  }
  if (lane == 0)
    st_release64(desc + tile, kPrefix | (uint32_t)Op::f(carry, agg));
  return carry;
}

// One channel's tile in `v`: scan it and apply the carry of the tiles
// before it.  `chain` is the channel's descriptors.
template <class Op>
__device__ __forceinline__ void scan_tile(int32_t (&v)[kItems],
                                          unsigned long long* chain,
                                          int tile, int32_t* warp_tot,
                                          int32_t* carry_sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 1; i < kItems; ++i) v[i] = Op::f(v[i], v[i - 1]);
  int32_t tot = v[kItems - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, tot, off);
    if (lane >= off) tot = Op::f(tot, y);
  }
  int32_t excl = __shfl_up_sync(kFull, tot, 1);
  if (lane == 0) excl = Op::kIdentity;
  if (lane == 31) warp_tot[warp] = tot;
  __syncthreads();
  int32_t pre = excl, agg = Op::kIdentity;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) pre = Op::f(pre, warp_tot[w]);
    agg = Op::f(agg, warp_tot[w]);
  }
  if (warp == 0) {
    const int32_t carry = look_back<Op>(chain, tile, agg);
    if (lane == 0) *carry_sh = carry;
  }
  __syncthreads();  // the carry is in; warp_tot may be rewritten
  pre = Op::f(pre, *carry_sh);
#pragma unroll
  for (int i = 0; i < kItems; ++i) v[i] = Op::f(v[i], pre);
}

template <class Op, bool kReduce>
__global__ void __launch_bounds__(kThreads)
mscan_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
             unsigned long long* __restrict__ desc, int* __restrict__ ticket,
             int M, long long n, int ntiles, int rev, int vec) {
  __shared__ __align__(16) int32_t sh[kTile];
  __shared__ int32_t warp_tot[kWarps];
  __shared__ int32_t carry_sh;
  __shared__ int tk_sh;
  if (threadIdx.x == 0) tk_sh = atomicAdd(ticket, 1);
  __syncthreads();
  const int tk = tk_sh;
  const int tile = kReduce ? tk : tk / M;
  const long long p0 = (long long)tile * kTile;  // logical start
  const long long base = rev ? n - p0 - kTile : p0;  // physical start
  using Red = typename Dual<Op>::type;

  if constexpr (kReduce) {
    int32_t acc[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) acc[i] = Red::kIdentity;
    for (int m = 0; m < M; ++m) {
      Fetch f;
      fetch_tile(x + (long long)m * n, base, n, vec, Op::kIdentity, f);
      put_tile(f, vec, sh);
      __syncthreads();
      int32_t v[kItems];
      read_items(sh, rev, v);
      scan_tile<Op>(v, desc + (long long)m * ntiles, tile, warp_tot,
                    &carry_sh);
#pragma unroll
      for (int i = 0; i < kItems; ++i) acc[i] = Red::f(acc[i], v[i]);
    }
    write_items(sh, rev, acc);  // each thread rewrites only its own words
    __syncthreads();
    store_tile(out, base, n, vec, sh);
  } else {
    const int m = tk - tile * M;
    Fetch f;
    fetch_tile(x + (long long)m * n, base, n, vec, Op::kIdentity, f);
    put_tile(f, vec, sh);
    __syncthreads();
    int32_t v[kItems];
    read_items(sh, rev, v);
    scan_tile<Op>(v, desc + (long long)m * ntiles, tile, warp_tot,
                  &carry_sh);
    write_items(sh, rev, v);
    __syncthreads();
    store_tile(out + (long long)m * n, base, n, vec, sh);
  }
}

template <class Op>
cudaError_t launch(const int32_t* x, int32_t* out, unsigned long long* desc,
                   int* ticket, int M, long long n, int ntiles, int rev,
                   int reduce, int vec, cudaStream_t s) {
  if (reduce) {
    mscan_kernel<Op, true><<<ntiles, kThreads, 0, s>>>(
        x, out, desc, ticket, M, n, ntiles, rev, vec);
  } else {
    mscan_kernel<Op, false><<<(unsigned)ntiles * M, kThreads, 0, s>>>(
        x, out, desc, ticket, M, n, ntiles, rev, vec);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (M, n) int32 row-major; out: (M, n) int32, or (n,) with reduce;
// scratch: 8 * (1 + M * ceil(n / 4096)) bytes, 8-byte aligned (the
// ticket, then the tiles' descriptors, channel-major), zeroed here.
// is_min: running min (reduce: max over channels) instead of running max
// (reduce: min over channels).  Returns cudaGetLastError().
extern "C" int csa_mscan(const void* x, void* out, void* scratch, int M,
                         long long n, int rev, int reduce, int is_min,
                         void* stream) {
  if (M <= 0 || n <= 0) return cudaSuccess;
  const long long ntiles_ll = (n + kTile - 1) / kTile;
  if (ntiles_ll * M > 2147483647LL) return cudaErrorInvalidValue;
  const int ntiles = static_cast<int>(ntiles_ll);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<unsigned long long*>(scratch);
  cudaError_t e = cudaMemsetAsync(
      words, 0, sizeof(unsigned long long) * (1 + (size_t)M * ntiles), s);
  if (e != cudaSuccess) return e;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  int* ticket = reinterpret_cast<int*>(words);
  unsigned long long* desc = words + 1;
  return is_min ? launch<MinOp>(xi, o, desc, ticket, M, n, ntiles, rev,
                                reduce, vec, s)
                : launch<MaxOp>(xi, o, desc, ticket, M, n, ntiles, rev,
                                reduce, vec, s);
}
