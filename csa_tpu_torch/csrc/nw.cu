// Batched global Needleman-Wunsch scores: +1 match, -1 mismatch, -1 gap.
//
// Replaces: csa_tpu/dp/pallas_nw.py:_nw_kernel (Pallas, TPU), reached
// through pairwise_nw_scores from the rotation-verification oracle
// (csa_tpu/rotation/verification.py, `--verify-rotations`).
//
// Function: for each pair p of the batch, H[la][lb] of
//   H[i][j] = max(H[i-1][j-1] + (a[i-1] == b[j-1] ? 1 : -1),
//                 H[i-1][j] - 1, H[i][j-1] - 1),  H[0][j] = -j, H[i][0] = -i.
// Codes are compared for equality only; the caller's pad codes differ
// between a and b, so a pad never matches.
//
// The kernel carries W[i][j] = H[i][j] + i + j instead, for which the
// recurrence is W = max(W[i-1][j-1] + (match ? 3 : 1), W[i-1][j],
// W[i][j-1]) with W = 0 on row 0 and column 0: the boundaries are
// explicit zeros and a cell is four int32 operations (equality test,
// select, add, three-way max, the last one Hopper's DPX __vimax3_s32).
// W stays in [0, 2 (la + lb)], so int32 holds it; H = W - la - lb.
//
// Bound on this card: int32 operations.  A pair of 17,408 x 17,408 (the
// Primates oracle) is 303 M cells and reads 139 KB, so the bytes are
// nothing and the work is 4 operations a cell over 132 SMs x 64 int32
// lanes.  Design, for that: every SM busy from start to end, whatever the
// number of pairs.
//
// Bands on a ticket queue.  A pair's la rows are cut into nb bands of
// nearly equal height h (a multiple of S = kStrip = 16, at most 32 S;
// csa_tpu_torch/dp/nw.py:plan).  One warp computes one band: lane t owns
// S consecutive rows, holds their a codes and their current column of W
// in registers, and at step s computes column j = s - t + 1 of its strip
// top to bottom, so a step is S dependent cells.  The strip's bottom value
// and the b code pass to lane t + 1 by one shuffle each; there is no block
// barrier.  Each (pair, band) is a ticket, band-major across pairs
// (ticket = band * B + pair); a persistent grid of warps, as many as the
// card holds at once, takes tickets from an atomic counter.  A band's
// producer, the band above it, holds a lower ticket and so is running or
// done: no deadlock at any residency, also beside other launches.
//
// Hand-off between bands.  The lane that holds a band's bottom row writes
// W of that row, column by column, into the carry row of its (pair, band
// boundary) in global memory, and after every chunk of kChunk columns
// publishes the number of columns written with a release store.  The band
// below, before each chunk, polls that counter with acquire loads (every
// lane), then the warp copies the chunk's top values (ld.global.cg, L2)
// and b codes into its shared buffer, from which lane 0 reads them a step
// ahead.  Carry rows are per boundary, so a producer never overwrites what
// its consumer has not read.  The counters and the ticket are zeroed by
// the wrapper.
//
// Not carried over from the TPU kernel: the rolled b window, the
// "garbage outside the cone" boundaries that relied on NEG = -(2**24),
// and the lane padding to 128.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 4;     // workers (warps) a block
constexpr int kChunk = 256;   // columns a hand-off chunk
constexpr int kStrip = 16;    // rows a lane (S)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t max3(int32_t x, int32_t y, int32_t z) {
#if defined(__CUDACC_VER_MAJOR__) && __CUDACC_VER_MAJOR__ >= 12
  return __vimax3_s32(x, y, z);
#else
  return max(max(x, y), z);
#endif
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int32_t ld_cg(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// One band of one pair, as one warp sees it.
struct Band {
  const int32_t* b;     // the pair's b codes
  const int32_t* top;   // carry row above (null for the first band)
  const int* top_done;  // its published column count
  int32_t* bot;         // carry row below (null for the last band)
  int* bot_done;
  int lb;
  int producer;         // lane holding the bottom row, or -1
};

// Chunk c of the band's top values and b codes into the warp's buffers.
__device__ __forceinline__ void load_chunk(const Band& bd, int c, int lane,
                                           int32_t* sb, int32_t* stop) {
  const int c0 = c * kChunk;
  const int n = min(kChunk, bd.lb - c0);
  __syncwarp();  // lane 0 has read the previous chunk
  if (bd.top_done) {
    while (ld_acquire(bd.top_done) < c0 + n) __nanosleep(64);
  }
  int32_t vb[kChunk / 32], vt[kChunk / 32];
#pragma unroll
  for (int u = 0; u < kChunk / 32; ++u) {
    const int i = u * 32 + lane;
    vb[u] = i < n ? __ldg(bd.b + c0 + i) : 0;
    vt[u] = (i < n && bd.top) ? ld_cg(bd.top + c0 + i) : 0;
  }
#pragma unroll
  for (int u = 0; u < kChunk / 32; ++u) {
    sb[u * 32 + lane] = vb[u];
    stop[u * 32 + lane] = vt[u];
  }
  __syncwarp();
}

// The state a lane carries from step to step of a band.
struct Strip {
  int32_t av[kStrip];  // a codes of the strip's rows
  int32_t h[kStrip];   // W of the strip's rows at the last column computed
  int32_t dtop;   // W of the row above the strip at the previous column
  int32_t upc;    // W of the row above the strip at this step's column
  int32_t bc;     // b code of this step's column
};

// Steps [from, to) of a band.  kAll: every lane that owns a row computes
// at every one of these steps (the steady part), so the body is
// straight-line code; a lane that owns no row then computes garbage that
// nothing reads.  Otherwise a lane computes only at columns 1..lb.
template <bool kAll>
__device__ __forceinline__ void steps(int from, int to, Strip& st,
                                      const Band& bd, int lane, int32_t* sb,
                                      int32_t* stop) {
  const int lb = bd.lb;
  for (int s = from; s < to; ++s) {
    const int sn = s + 1;
    if (sn < lb && (sn & (kChunk - 1)) == 0)
      load_chunk(bd, sn / kChunk, lane, sb, stop);
    int32_t bn = 0, tn = 0;
    if (sn < lb) {
      bn = sb[sn & (kChunk - 1)];
      tn = stop[sn & (kChunk - 1)];
    }
    const int j = s - lane + 1;
    if (kAll || (j >= 1 && j <= lb)) {
      int32_t up = st.upc, dg = st.dtop;
#pragma unroll
      for (int k = 0; k < kStrip; ++k) {
        const int32_t old = st.h[k];
        const int32_t v = max3(dg + (st.av[k] == st.bc ? 3 : 1), up, old);
        dg = old;
        up = v;
        st.h[k] = v;
      }
      st.dtop = st.upc;
      if (lane == bd.producer) {
        bd.bot[j - 1] = up;
        if ((j & (kChunk - 1)) == 0 || j == lb) st_release(bd.bot_done, j);
      }
    }
    const int32_t un = __shfl_up_sync(kFull, st.h[kStrip - 1], 1);
    const int32_t bs = __shfl_up_sync(kFull, st.bc, 1);
    st.upc = lane == 0 ? tn : un;
    st.bc = lane == 0 ? bn : bs;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
nw_band_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int la, int lb, int B, int h, int nb,
               int32_t* __restrict__ out, int32_t* __restrict__ carry,
               int* __restrict__ done, int* __restrict__ ticket) {
  __shared__ int32_t s_b[kWarps][kChunk];
  __shared__ int32_t s_top[kWarps][kChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* sb = s_b[warp];
  int32_t* stop = s_top[warp];
  const int total = B * nb;
  for (;;) {
    int tk = 0;
    if (lane == 0) tk = atomicAdd(ticket, 1);
    tk = __shfl_sync(kFull, tk, 0);
    if (tk >= total) return;
    const int band = tk / B, p = tk - band * B;
    const int r0 = band * h;
    const int rows = min(h, la - r0);
    const int L = (rows + kStrip - 1) / kStrip;  // lanes that own rows
    const bool last = band == nb - 1;
    const long long bnd = (long long)p * (nb - 1) + band;  // boundary below
    Band bd;
    bd.b = b + (long long)p * lb;
    bd.top = band > 0 ? carry + (bnd - 1) * lb : nullptr;
    bd.top_done = band > 0 ? done + bnd - 1 : nullptr;
    bd.bot = last ? nullptr : carry + bnd * lb;
    bd.bot_done = last ? nullptr : done + bnd;
    bd.lb = lb;
    bd.producer = last ? -1 : L - 1;

    Strip st;
    const int32_t* ap = a + (long long)p * la + r0;
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      const int r = lane * kStrip + k;
      st.av[k] = r < rows ? ap[r] : 0;  // rows past the band: unread
      st.h[k] = 0;                      // column 0
    }
    st.dtop = 0;
    load_chunk(bd, 0, lane, sb, stop);
    st.bc = sb[0];
    st.upc = stop[0];
    // ramp up, steady part, ramp down
    const int nsteps = lb + L - 1;
    const int lo = min(L - 1, lb), hi = max(lo, lb);
    steps<false>(0, lo, st, bd, lane, sb, stop);
    steps<true>(lo, hi, st, bd, lane, sb, stop);
    steps<false>(hi, nsteps, st, bd, lane, sb, stop);
    if (last) {
      const int q = (rows - 1) / kStrip, kq = (rows - 1) % kStrip;
      int32_t w = st.h[0];
#pragma unroll
      for (int k = 1; k < kStrip; ++k) w = (k == kq) ? st.h[k] : w;
      if (lane == q) out[p] = w - la - lb;
    }
  }
}

cudaError_t launch(const int32_t* a, const int32_t* b, int la, int lb, int B,
                   int h, int nb, int32_t* out, int32_t* carry, int* done,
                   int* ticket, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, nw_band_kernel, kWarps * 32, 0);
  if (e != cudaSuccess) return e;
  const long long need = ((long long)B * nb + kWarps - 1) / kWarps;
  const long long grid = std::min<long long>(need, (long long)sms * per_sm);
  nw_band_kernel<<<(unsigned)std::max<long long>(grid, 1), kWarps * 32, 0,
                   s>>>(a, b, la, lb, B, h, nb, out, carry, done, ticket);
  return cudaGetLastError();
}

}  // namespace

// B pairs: a (B, la) and b (B, lb) int32 codes, out (B,) int32 scores.
// Bands of `band_rows` rows (a multiple of kStrip = 16, at most 32 x 16),
// nb of them: (nb - 1) * band_rows < la <= nb * band_rows
// (csa_tpu_torch/dp/nw.py:plan).  carry: (B, nb - 1, lb) int32 (null when
// nb == 1); counters: 1 + B * (nb - 1) int32, zeroed by the caller (the
// ticket, then one published column count per band boundary).
// Returns cudaGetLastError() after the launch.
extern "C" int csa_nw_scores(const void* a, const void* b, int la, int lb,
                             int B, int band_rows, int nb, void* out,
                             void* carry, void* counters, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (la < 1 || lb < 1 || nb < 1 || band_rows < kStrip ||
      band_rows % kStrip != 0 || band_rows > 32 * kStrip ||
      (long long)(nb - 1) * band_rows >= la ||
      (long long)nb * band_rows < la || (long long)B * nb > 2147483647LL ||
      (nb > 1 && carry == nullptr) || counters == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int32_t* ai = static_cast<const int32_t*>(a);
  const int32_t* bi = static_cast<const int32_t*>(b);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* cr = static_cast<int32_t*>(carry);
  int* ticket = static_cast<int*>(counters);
  int* done = ticket + 1;
  return launch(ai, bi, la, lb, B, band_rows, nb, o, cr, done, ticket,
                static_cast<cudaStream_t>(stream));
}
