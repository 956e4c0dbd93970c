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
// lanes.  Design, for that: one block per pair (the pairs are
// independent; 135-162 of them fill the 132 SMs about once), and inside
// it a skewed wavefront over strips of rows.  Thread t owns S consecutive
// rows, holds their a codes and their current column of W in registers,
// and at step s computes column j = s - t + 1 of its strip top to bottom,
// so a step is S dependent cells with no memory traffic but one b code.
// The strip's bottom value passes to thread t + 1 through a double-buffered
// slot in shared memory, read after the one __syncthreads of the step.
// When la exceeds S x threads, the block sweeps the rows in bands and
// carries each band's bottom row to the next through global scratch
// (one row of lb + 1 int32 per pair), written in place just behind the
// reads of the next band's first thread.
//
// Not carried over from the TPU kernel: the rolled b window, the
// "garbage outside the cone" boundaries that relied on NEG = -(2**24),
// and the lane padding to 128.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ int32_t max3(int32_t x, int32_t y, int32_t z) {
#if defined(__CUDACC_VER_MAJOR__) && __CUDACC_VER_MAJOR__ >= 12
  return __vimax3_s32(x, y, z);
#else
  return max(max(x, y), z);
#endif
}

template <int S>
__global__ void __launch_bounds__(S <= 16 ? 1024 : 640)
nw_score_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int la, int lb, int32_t* __restrict__ out,
                int32_t* __restrict__ scratch) {
  __shared__ int32_t edge[2][kMaxThreads];
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int band_rows = S * blockDim.x;
  const int32_t* ap = a + (long long)p * la;
  const int32_t* bp = b + (long long)p * lb;
  int32_t* row = scratch ? scratch + (long long)p * (lb + 1) : nullptr;

  for (int band = 0; band < la; band += band_rows) {
    const int rows = min(band_rows, la - band);
    const int active = (rows + S - 1) / S;
    const int r0 = band + t * S;  // a index of this thread's first row
    int32_t av[S];
    int32_t h[S];  // W of this strip's rows at the last column computed
#pragma unroll
    for (int k = 0; k < S; ++k) {
      av[k] = (r0 + k < la) ? ap[r0 + k] : 0;  // rows past la: unread
      h[k] = 0;                                 // column 0
    }
    int32_t top_prev = 0;  // W of the row above the strip, previous column
    int32_t bcur = (t == 0) ? bp[0] : 0;
    const int steps = lb + active - 1;
    for (int s = 0; s < steps; ++s) {
      const int j = s - t + 1;  // column of this step (1-based)
      const int jn = j + 1;
      const int32_t bnext = (jn >= 1 && jn <= lb) ? __ldg(bp + jn - 1) : 0;
      if (t < active && j >= 1 && j <= lb) {
        int32_t top;
        if (t > 0) {
          top = edge[(s - 1) & 1][t - 1];
        } else {
          top = (band == 0) ? 0 : row[j];
        }
        int32_t up = top;
        int32_t dg = top_prev;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const int32_t old = h[k];
          const int32_t v = max3(dg + (av[k] == bcur ? 3 : 1), up, old);
          dg = old;
          up = v;
          h[k] = v;
        }
        top_prev = top;
        edge[s & 1][t] = up;
        if (row != nullptr && t == active - 1) row[j] = up;
      }
      bcur = bnext;
      __syncthreads();
    }
    if (band + rows == la) {
      const int last = la - 1 - band;  // band row of DP row la
      if (t == last / S) {
        int32_t w = 0;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          if (k == last - t * S) w = h[k];
        }
        out[p] = w - la - lb;
      }
    }
  }
}

template <int S>
cudaError_t launch(const int32_t* a, const int32_t* b, int la, int lb, int B,
                   int threads, int32_t* out, int32_t* scratch,
                   cudaStream_t s) {
  nw_score_kernel<S><<<B, threads, 0, s>>>(a, b, la, lb, out, scratch);
  return cudaGetLastError();
}

}  // namespace

// B pairs: a (B, la) and b (B, lb) int32 codes, out (B,) int32 scores.
// S rows per thread (4, 8, 16 or 32) and `threads` a block, as planned by
// csa_tpu_torch/dp/nw.py:plan; scratch (B, lb + 1) int32 when la needs
// more than one band of S x threads rows, else null.  la, lb, B >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int csa_nw_scores(const void* a, const void* b, int la, int lb,
                             int B, int S, int threads, void* out,
                             void* scratch, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (threads < 1 || threads > kMaxThreads || (S > 16 && threads > 640) ||
      la < 1 || lb < 1) {
    return cudaErrorInvalidValue;
  }
  if ((long long)S * threads < la && scratch == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int32_t* ai = static_cast<const int32_t*>(a);
  const int32_t* bi = static_cast<const int32_t*>(b);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* sc = static_cast<int32_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 4: return launch<4>(ai, bi, la, lb, B, threads, o, sc, st);
    case 8: return launch<8>(ai, bi, la, lb, B, threads, o, sc, st);
    case 16: return launch<16>(ai, bi, la, lb, B, threads, o, sc, st);
    case 32: return launch<32>(ai, bi, la, lb, B, threads, o, sc, st);
    default: return cudaErrorInvalidValue;
  }
}
