// Batched progressive profile Needleman-Wunsch: fill + backtrack.
//
// Replaces: csa_tpu/dp/pallas_profile.py:_profile_kernel (Pallas, TPU) and
// its XLA backtrack _backtrack, reached through profile_paths_pallas /
// profile_path_pallas from the batched gap DP
// (csa_tpu/align/progressive.py:progressive_dp_batched).
//
// Recurrence (reference dynamicprogramming.c:993-1026), cell (j, c) with
// j = 1..R rows of the sequence, c = 1..C profile columns:
//   diag = dp[j-1][c-1] + colsub[c-1][code[j-1]]
//   up   = dp[j-1][c]   + rowgap
//   left = dp[j][c-1]   + cg[c-1]
// ties diag >= left >= up.  colsub/cg/rowgap fold the scoring and the
// column counts (built by the wrapper, dp/profile.py).  The boundaries are
// injected, not derived: dp[0][c] = top[c] (possibly stale) and
// dp[j][0] = j * edge_rowgap, with row 0 winning at (0, 0).
//
// Bound on this card: the serial dependence along anti-diagonals, not
// bytes or operations.  A cell needs ~10 integer operations and the whole
// fill writes R*C/4 direction bytes (scaled by (R+C)/R for the diagonal
// layout below); what limits it is that diagonal t can start only when
// t-1 is done.  Design: one thread block per gap of the batch (the gaps are
// independent, alignment.c:179-208), threads stride over groups of 4
// columns and the block loops over diagonals t = 0..R+C with one
// __syncthreads() between diagonals.  A cell reads only diagonals t-1 and
// t-2, so the DP state is three rotating rows of C+1 int32 indexed by
// column, in shared memory when 3*(C+1)*4 bytes fit the block's opt-in
// limit and in global scratch (L2-resident) when they do not (Set3's
// ~28k-column merges need ~340 KB).  A gap uses one SM, so a batch of few
// gaps leaves most of the 132 SMs idle and a single giant gap is slow;
// a multi-block wavefront is later work.
//
// Directions: codes D_DIAG=0, D_LEFT=1, D_UP=2, 2 bits a cell, packed by
// diagonal: byte (t, q) of a gap holds cells (t-c, c) for c = 4q..4q+3,
// so the writes of one diagonal are contiguous.  A gap's block is
// (R+C+1) x ceil((C+1)/4) bytes at dirs_off[g].
//
// Backtrack: one thread per gap walks from (R, C) to (0, 0), following the
// stored code in the main region and going UP while j > 0, else LEFT, on
// the edges; it writes walk-order codes and the step count, so only those
// O(R+C) bytes go back to the host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDiag = 0;
constexpr int kLeft = 1;
constexpr int kUp = 2;

__global__ void profile_fill_kernel(
    const int8_t* __restrict__ codes, int Rmax,
    const int32_t* __restrict__ colsub, const int32_t* __restrict__ cg,
    const int32_t* __restrict__ top, int Cmax,
    const int32_t* __restrict__ rowgap, const int32_t* __restrict__ erg,
    const int32_t* __restrict__ Rv, const int32_t* __restrict__ Cv,
    const long long* __restrict__ dirs_off, uint8_t* __restrict__ dirs,
    int32_t* __restrict__ scratch, int use_smem) {
  extern __shared__ int32_t smem[];
  const int g = blockIdx.x;
  const int R = Rv[g];
  const int C = Cv[g];
  const int W = Cmax + 1;
  int32_t* buf = use_smem ? smem : scratch + (long long)g * 3 * W;
  const int8_t* code = codes + (long long)g * Rmax;
  const int32_t* sub = colsub + (long long)g * Cmax * 5;
  const int32_t* cgg = cg + (long long)g * Cmax;
  const int32_t* topg = top + (long long)g * W;
  const int32_t rg = rowgap[g];
  const int32_t eg = erg[g];
  const int Q = (C + 4) / 4;  // ceil((C + 1) / 4) column groups
  uint8_t* d = dirs + dirs_off[g];

  for (int t = 0; t <= R + C; ++t) {
    int32_t* cur = buf + (t % 3) * W;
    const int32_t* p1 = buf + ((t + 2) % 3) * W;  // diagonal t-1
    const int32_t* p2 = buf + ((t + 1) % 3) * W;  // diagonal t-2
    uint8_t* drow = d + (long long)t * Q;
    for (int q = threadIdx.x; q < Q; q += blockDim.x) {
      unsigned byte = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * q + u;
        const int j = t - c;
        if (c > C || j < 0 || j > R) continue;
        int32_t val;
        if (j == 0) {
          val = topg[c];
        } else if (c == 0) {
          val = j * eg;
        } else {
          int b = code[j - 1];
          b = (b < 0 || b > 4) ? 4 : b;
          const int32_t diag = p2[c - 1] + sub[(c - 1) * 5 + b];
          const int32_t up = p1[c] + rg;
          const int32_t left = p1[c - 1] + cgg[c - 1];
          int dcode;
          if (diag >= up && diag >= left) {
            val = diag;
            dcode = kDiag;
          } else if (left >= up) {
            val = left;
            dcode = kLeft;
          } else {
            val = up;
            dcode = kUp;
          }
          byte |= static_cast<unsigned>(dcode) << (2 * u);
        }
        cur[c] = val;
      }
      drow[q] = static_cast<uint8_t>(byte);
    }
    __syncthreads();
  }
}

__global__ void profile_backtrack_kernel(
    const uint8_t* __restrict__ dirs, const long long* __restrict__ dirs_off,
    const int32_t* __restrict__ Rv, const int32_t* __restrict__ Cv, int G,
    int L, int8_t* __restrict__ paths, int32_t* __restrict__ nsteps) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  int j = Rv[g];
  int c = Cv[g];
  const int Q = (c + 4) / 4;
  const uint8_t* d = dirs + dirs_off[g];
  int8_t* out = paths + (long long)g * L;
  int s = 0;
  while (j > 0 || c > 0) {
    int dcode;
    if (j > 0 && c > 0) {
      const unsigned byte = d[(long long)(j + c) * Q + (c >> 2)];
      dcode = (byte >> (2 * (c & 3))) & 3;
    } else {
      dcode = j > 0 ? kUp : kLeft;
    }
    out[s++] = static_cast<int8_t>(dcode);
    if (dcode != kLeft) --j;
    if (dcode != kUp) --c;
  }
  nsteps[g] = s;
}

}  // namespace

// One batch of G gaps.  Per-gap arrays are padded to Rmax rows / Cmax
// columns: codes (G, Rmax) int8; colsub (G, Cmax, 5) int32; cg (G, Cmax);
// top (G, Cmax+1); rowgap, erg, R, C (G,) int32; dirs_off (G,) int64.
// scratch: (G, 3, Cmax+1) int32, unused (may be null) when use_smem.
// paths: (G, L) int8 with L >= Rmax + Cmax; nsteps (G,) int32.
// Returns cudaGetLastError() after the two launches.
extern "C" int csa_profile_paths(
    const void* codes, int Rmax, const void* colsub, const void* cg,
    const void* top, int Cmax, const void* rowgap, const void* erg,
    const void* R, const void* C, const void* dirs_off, void* dirs,
    void* scratch, int use_smem, int threads, int G, void* paths,
    void* nsteps, void* stream) {
  if (G <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  if (use_smem) {
    smem = (size_t)3 * (Cmax + 1) * sizeof(int32_t);
    cudaError_t e = cudaFuncSetAttribute(
        profile_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  profile_fill_kernel<<<G, threads, smem, s>>>(
      static_cast<const int8_t*>(codes), Rmax,
      static_cast<const int32_t*>(colsub), static_cast<const int32_t*>(cg),
      static_cast<const int32_t*>(top), Cmax,
      static_cast<const int32_t*>(rowgap), static_cast<const int32_t*>(erg),
      static_cast<const int32_t*>(R), static_cast<const int32_t*>(C),
      static_cast<const long long*>(dirs_off), static_cast<uint8_t*>(dirs),
      static_cast<int32_t*>(scratch), use_smem);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int bt = 64;
  profile_backtrack_kernel<<<(G + bt - 1) / bt, bt, 0, s>>>(
      static_cast<const uint8_t*>(dirs),
      static_cast<const long long*>(dirs_off),
      static_cast<const int32_t*>(R), static_cast<const int32_t*>(C), G,
      Rmax + Cmax, static_cast<int8_t*>(paths),
      static_cast<int32_t*>(nsteps));
  return cudaGetLastError();
}
