// One band of the column-sharded profile DP, and the walk over the bands.
//
// Replaces: csa_tpu/dp/pallas_band.py:_band_kernel (Pallas, TPU), launched
// once per (rank, band) by _band_fill_program through _band_call, and the
// XLA walk of _band_path_program; reached from csa_tpu/dp/seqpar.py:
// dp_path_seqpar for the giant merges of the sharded gap DP.
//
// A giant gap's DP (R rows x C columns) is split by columns over D ranks:
// rank d owns global columns d*Cloc+1 .. (d+1)*Cloc.  Rows go in bands of
// Rb; in superstep s rank d fills band s-d (dp/seqpar.py drives it).  One
// launch fills one band of one rank: Rb x Cloc cells of the recurrence of
// profile_dp.cu,
//   diag = dp[j-1][c-1] + colsub[c-1][code[j-1]]
//   up   = dp[j-1][c]   + rowgap
//   left = dp[j][c-1]   + cg[c-1]
// ties diag >= left >= up, in band-local coordinates (j = 0..Rb,
// c = 0..Cloc).  Boundaries are given explicitly: dp[0][c] = top[c] (band
// 0: the rank's slice of the global top row, possibly stale; later bands:
// the rank's own previous bottom row), dp[j][0] = left[j-1] (rank 0:
// j * edge_rowgap at the global row; other ranks: the left neighbour's
// right-edge column), row 0 winning at (0, 0).  Outputs: the directions,
// the bottom row dp[Rb][0..Cloc] (index 0 is the left boundary, so the
// carried row keeps the left-halo element as seqpar does) and the right
// edge dp[1..Rb][Cloc] (the halo for rank d+1).
//
// Bound on this card: int32 operations, ~10 a cell (three moves, three
// compares, four selects, as PERF.md counts them), and inside a band the
// serial dependence between anti-diagonals: diagonal t starts only when
// t-1 is done.  Design: one block fills one band by anti-diagonals, its
// threads striding over the groups of 4 columns that hold the diagonal's
// cells (at most min(Rb, Cloc) + 1 of them), one __syncthreads() per
// diagonal, with three rotating diagonals of Cloc+1 int32 indexed by
// column, in shared memory when they fit the opt-in limit and in global
// scratch (L2-resident) when they do not.  The parallelism across the
// serial dependence comes from the mesh: each rank launches on its own
// stream, so the D bands of one superstep run at the same time on
// separate SMs, and a giant gap's serial diagonals per rank shrink from
// R + C to about (nb + D - 1) * (Rb + Cloc).
//
// Directions: D_DIAG=0, D_LEFT=1, D_UP=2, 2 bits a cell, packed by
// diagonal: byte (t, q) holds cells (t-c, c) for
// c = 4q..4q+3, so a band's block is (Rb+Cloc+1) x Q bytes with
// Q = ceil((Cloc+1)/4); boundary cells hold 0.
//
// Walk: one thread walks from (R, C) to (0, 0) over the per-(rank, band)
// blocks, gathered on one device: cell (j, c) lives at rank (c-1)/Cloc,
// band (j-1)/Rb, local (jl, cl), byte (jl+cl)*Q + cl/4; on the edges it
// goes UP while j > 0, then LEFT.  Only the walk-order codes and the step
// count leave the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDiag = 0;
constexpr int kLeft = 1;
constexpr int kUp = 2;

__global__ void band_fill_kernel(
    const int8_t* __restrict__ codes, int Rb,
    const int32_t* __restrict__ colsub, const int32_t* __restrict__ cg,
    int Cloc, int32_t rowgap, const int32_t* __restrict__ top,
    const int32_t* __restrict__ left, uint8_t* __restrict__ dirs,
    int32_t* __restrict__ bottom, int32_t* __restrict__ edge,
    int32_t* __restrict__ scratch, int use_smem) {
  extern __shared__ int32_t smem[];
  const int W = Cloc + 1;
  int32_t* buf = use_smem ? smem : scratch;
  const int Q = (Cloc + 4) / 4;  // ceil((Cloc + 1) / 4) column groups

  for (int t = 0; t <= Rb + Cloc; ++t) {
    int32_t* cur = buf + (t % 3) * W;
    const int32_t* p1 = buf + ((t + 2) % 3) * W;  // diagonal t-1
    const int32_t* p2 = buf + ((t + 1) % 3) * W;  // diagonal t-2
    uint8_t* drow = dirs + (long long)t * Q;
    // only the groups holding cells of this diagonal (t-Rb <= c <= t);
    // the other bytes of the row stay as the entry zeroed them
    const int q_lo = max(0, t - Rb) >> 2;
    const int q_hi = min(Cloc, t) >> 2;
    for (int q = q_lo + threadIdx.x; q <= q_hi; q += blockDim.x) {
      unsigned byte = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * q + u;
        const int j = t - c;
        if (c > Cloc || j < 0 || j > Rb) continue;
        int32_t val;
        if (j == 0) {
          val = top[c];
        } else if (c == 0) {
          val = left[j - 1];
        } else {
          int b = codes[j - 1];
          b = (b < 0 || b > 4) ? 4 : b;
          const int32_t diag = p2[c - 1] + colsub[(c - 1) * 5 + b];
          const int32_t up = p1[c] + rowgap;
          const int32_t lft = p1[c - 1] + cg[c - 1];
          int dcode;
          if (diag >= up && diag >= lft) {
            val = diag;
            dcode = kDiag;
          } else if (lft >= up) {
            val = lft;
            dcode = kLeft;
          } else {
            val = up;
            dcode = kUp;
          }
          byte |= static_cast<unsigned>(dcode) << (2 * u);
        }
        cur[c] = val;
        if (j == Rb) bottom[c] = val;
        if (c == Cloc && j > 0) edge[j - 1] = val;
      }
      drow[q] = static_cast<uint8_t>(byte);
    }
    __syncthreads();
  }
}

__global__ void band_walk_kernel(const uint8_t* __restrict__ blocks,
                                 long long block_bytes, int nb, int Rb,
                                 int Cloc, int R, int C,
                                 int8_t* __restrict__ path,
                                 int32_t* __restrict__ nsteps) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const int Q = (Cloc + 4) / 4;
  int j = R;
  int c = C;
  int s = 0;
  while (j > 0 || c > 0) {
    int dcode;
    if (j > 0 && c > 0) {
      const int d = (c - 1) / Cloc;
      const int b = (j - 1) / Rb;
      const int cl = c - d * Cloc;
      const int jl = j - b * Rb;
      const uint8_t* blk = blocks + (long long)(d * nb + b) * block_bytes;
      const unsigned byte = blk[(long long)(jl + cl) * Q + (cl >> 2)];
      dcode = (byte >> (2 * (cl & 3))) & 3;
    } else {
      dcode = j > 0 ? kUp : kLeft;
    }
    path[s++] = static_cast<int8_t>(dcode);
    if (dcode != kLeft) --j;
    if (dcode != kUp) --c;
  }
  *nsteps = s;
}

}  // namespace

// One band: codes (Rb,) int8; colsub (Cloc, 5), cg (Cloc,) int32; top
// (Cloc+1,), left (Rb,) int32.  Out: dirs (Rb+Cloc+1) x ceil((Cloc+1)/4)
// bytes (zeroed here first), bottom (Cloc+1,), edge (Rb,) int32.  scratch:
// (3, Cloc+1) int32, unused (may be null) when use_smem.  Returns the first
// CUDA error (memset, attribute or launch), else 0.
extern "C" int csa_band_fill(const void* codes, int Rb, const void* colsub,
                             const void* cg, int Cloc, int rowgap,
                             const void* top, const void* left, void* dirs,
                             void* bottom, void* edge, void* scratch,
                             int use_smem, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t nbytes =
      (size_t)(Rb + Cloc + 1) * (size_t)((Cloc + 4) / 4);
  cudaError_t z = cudaMemsetAsync(dirs, 0, nbytes, s);
  if (z != cudaSuccess) return z;
  size_t smem = 0;
  if (use_smem) {
    smem = (size_t)3 * (Cloc + 1) * sizeof(int32_t);
    cudaError_t e = cudaFuncSetAttribute(
        band_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  band_fill_kernel<<<1, threads, smem, s>>>(
      static_cast<const int8_t*>(codes), Rb,
      static_cast<const int32_t*>(colsub), static_cast<const int32_t*>(cg),
      Cloc, rowgap, static_cast<const int32_t*>(top),
      static_cast<const int32_t*>(left), static_cast<uint8_t*>(dirs),
      static_cast<int32_t*>(bottom), static_cast<int32_t*>(edge),
      static_cast<int32_t*>(scratch), use_smem);
  return cudaGetLastError();
}

// Walk over D*nb band blocks of block_bytes each (block d*nb + b is rank
// d's band b), from (R, C) to (0, 0).  path: (R + C,) int8 walk-order
// codes; nsteps: (1,) int32.  Returns cudaGetLastError().
extern "C" int csa_band_walk(const void* blocks, long long block_bytes,
                             int nb, int Rb, int Cloc, int R, int C,
                             void* path, void* nsteps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  band_walk_kernel<<<1, 1, 0, s>>>(
      static_cast<const uint8_t*>(blocks), block_bytes, nb, Rb, Cloc, R, C,
      static_cast<int8_t*>(path), static_cast<int32_t*>(nsteps));
  return cudaGetLastError();
}
