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
// launch fills one band of one rank: Rb x Cloc cells of the profile-DP
// recurrence, ties diag >= left >= up, in band-local coordinates
// (j = 0..Rb, c = 0..Cloc).  Boundaries are given explicitly: dp[0][c] =
// top[c] (band 0: the rank's slice of the global top row, possibly stale;
// later bands: the rank's own previous bottom row), dp[j][0] = left[j-1]
// (rank 0: j * edge_rowgap at the global row; other ranks: the left
// neighbour's right-edge column), row 0 winning at (0, 0).  Outputs: the
// directions, the bottom row dp[Rb][0..Cloc] (index 0 is the left
// boundary, so the carried row keeps the left-halo element as seqpar
// does) and the right edge dp[1..Rb][Cloc] (the halo for rank d+1).
//
// Bound on this card, and design: those of the profile DP, whose tile
// engine (csrc/tile_dp.cuh) fills the band as a gap of its own with an
// explicit left column and both outputs (the JAX band kernel is likewise
// the profile kernel with these three generalizations).  A band is cut
// into tiles of 32 * S rows by Tc columns, one warp fills a tile from
// registers, and workers take tiles from a ticket queue and hand the
// boundaries on through ready flags: one launch a (rank, band), its
// critical path the band's tile anti-diagonals.  The entry zeroes the
// ticket counter and flags (T + 1 ints) on the stream before the launch,
// so the bands of a rank reuse one scratch on the rank's stream; nothing
// else is zeroed: the directions a ragged tile does not hold are never
// read.
//
// Directions: each (rank, band) block holds its band in the profile DP's
// tiled layout for an Rb x Cloc gap (dp/profile.py:dirs_address).
//
// Walk: one warp walks from (R, C) to (0, 0) over the per-(rank, band)
// blocks, gathered on one device, as the profile DP's walk walks a gap: it
// copies the tile it stands in to shared memory, walks inside it, and
// loads the next tile, which may lie in another band or rank block, when
// it crosses an edge; cell (j, c) lives at rank (c-1)/Cloc, band (j-1)/Rb.
// On the matrix edges it goes UP while j > 0, then LEFT.  Only the
// walk-order codes and the step count leave the kernel.
#include "tile_dp.cuh"

namespace {

// The tile of global cell (j, c) among the (rank, band) blocks.
template <int S>
struct BandTiles {
  const uint8_t* blocks;
  long long block_bytes;
  int nb, Rb, Cloc, nTc, tc_shift;
  __device__ const uint4* operator()(int j, int c, int& j0, int& c0) const {
    constexpr int Tr = S * kLanes;
    const int d = (c - 1) / Cloc;
    const int b = (j - 1) / Rb;
    const int tr = ((j - 1) - b * Rb) / Tr;
    const int tc = ((c - 1) - d * Cloc) >> tc_shift;
    j0 = b * Rb + tr * Tr;
    c0 = d * Cloc + (tc << tc_shift);
    return reinterpret_cast<const uint4*>(
        blocks + (d * nb + b) * block_bytes +
        (tr * nTc + tc) * tile_bytes<S>(1 << tc_shift));
  }
};

template <int S>
__global__ void __launch_bounds__(kLanes)
band_walk_kernel(const uint8_t* __restrict__ blocks, long long block_bytes,
                 int nb, int Rb, int Cloc, int R, int C, int Tc,
                 int tc_shift, int8_t* __restrict__ path,
                 int32_t* __restrict__ nsteps) {
  extern __shared__ uint4 tile_smem[];
  const BandTiles<S> loc{blocks, block_bytes, nb, Rb, Cloc,
                         (Cloc + Tc - 1) >> tc_shift, tc_shift};
  walk_path<S>(loc, R, C, Tc, tile_smem, path, nsteps);
}

template <int S>
int launch_walk(const void* blocks, long long block_bytes, int nb, int Rb,
                int Cloc, int R, int C, int Tc, void* path, void* nsteps,
                cudaStream_t st) {
  static size_t smem_set[64] = {};
  const size_t smem = (size_t)tile_bytes<S>(Tc);  // one tile
  cudaError_t e = allow_smem(band_walk_kernel<S>, smem, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  band_walk_kernel<S><<<1, kLanes, smem, st>>>(
      static_cast<const uint8_t*>(blocks), block_bytes, nb, Rb, Cloc, R, C,
      Tc, log2_of(Tc), static_cast<int8_t*>(path),
      static_cast<int32_t*>(nsteps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One band as one gap of the tile engine.  codes (Rb,) int8; colsub
// (Cloc, 5), cg (Cloc,), top (Cloc + 1,), left (Rb,) int32.  meta (1, 10)
// int64 and order (T, 3) int32 as csa_profile_fill takes them, for one
// Rb x Cloc gap; ctrl (1 + T) int32, zeroed here; bnd: the gap's
// boundary store.  Out: dirs (the gap's tiled direction
// bytes), bottom (Cloc + 1,), edge (Rb,) int32.  Rb (the rows again)
// picks the instantiation: a multiple of the tile height takes the one
// without the ragged last tile row.  `workers` blocks of one warp.
// Returns the memset's error or cudaGetLastError().
extern "C" int csa_band_fill(const void* codes, const void* colsub,
                             const void* cg, const void* top,
                             const void* left, const void* meta,
                             const void* order, int T, void* ctrl, void* bnd,
                             void* dirs, void* bottom, void* edge, int Rb,
                             int S, int Tc, int workers, void* stream) {
  if (T <= 0) return cudaSuccess;
  if (bad_tile(S, Tc) || workers < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the ticket counter and the flags: T + 1 ints, not the directions
  const cudaError_t z =
      cudaMemsetAsync(ctrl, 0, (size_t)(T + 1) * sizeof(int), st);
  if (z != cudaSuccess) return static_cast<int>(z);
  const bool ragged = Rb % (S * kLanes) != 0;
  if (S == 8) {
    return ragged ? launch_tile_fill<8, true, true>(
                        codes, colsub, cg, top, meta, order, T, ctrl, bnd,
                        dirs, Tc, workers, left, bottom, edge, st)
                  : launch_tile_fill<8, true>(
                        codes, colsub, cg, top, meta, order, T, ctrl, bnd,
                        dirs, Tc, workers, left, bottom, edge, st);
  }
  return ragged ? launch_tile_fill<16, true, true>(
                      codes, colsub, cg, top, meta, order, T, ctrl, bnd,
                      dirs, Tc, workers, left, bottom, edge, st)
                : launch_tile_fill<16, true>(
                      codes, colsub, cg, top, meta, order, T, ctrl, bnd,
                      dirs, Tc, workers, left, bottom, edge, st);
}

// Walk over D * nb band blocks of block_bytes each (block d * nb + b is
// rank d's band b, each in the tiled layout of S and Tc), from (R, C) to
// (0, 0).  path: (R + C,) int8 walk-order codes; nsteps: (1,) int32.
// Returns cudaGetLastError().
extern "C" int csa_band_walk(const void* blocks, long long block_bytes,
                             int nb, int Rb, int Cloc, int R, int C, int S,
                             int Tc, void* path, void* nsteps, void* stream) {
  if (bad_tile(S, Tc)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return S == 8 ? launch_walk<8>(blocks, block_bytes, nb, Rb, Cloc, R, C, Tc,
                                 path, nsteps, st)
                : launch_walk<16>(blocks, block_bytes, nb, Rb, Cloc, R, C, Tc,
                                  path, nsteps, st);
}
