// Batched progressive profile Needleman-Wunsch: fill + backtrack.
//
// Replaces: csa_tpu/dp/pallas_profile.py:_profile_kernel (Pallas, TPU) and
// its XLA backtrack _backtrack, reached through profile_paths_pallas /
// profile_path_pallas from the batched gap DP
// (csa_tpu/align/progressive.py:progressive_dp_batched).
//
// The recurrence, the boundaries and the design (tiles of 32 * S rows by
// Tc columns, one warp a tile with its strip in registers, a ticket queue
// with ready flags, one launch for the whole batch; a one-warp walk a gap,
// a tile at a time through shared memory) are the tile engine's:
// csrc/tile_dp.cuh.  Here every gap takes dp[j][0] = j * edge_rowgap and
// has no bottom-row or right-edge output; its tiles lie row-major at its
// dirs_off.
#include "tile_dp.cuh"

namespace {

// The tile of cell (j, c) inside one gap's direction store.
template <int S>
struct GapTiles {
  const uint8_t* dirs;
  int nTc;
  int tc_shift;
  __device__ const uint4* operator()(int j, int c, int& j0, int& c0) const {
    constexpr int Tr = S * kLanes;
    const int tr = (j - 1) / Tr;
    const int tc = (c - 1) >> tc_shift;
    j0 = tr * Tr;
    c0 = tc << tc_shift;
    return reinterpret_cast<const uint4*>(
        dirs + (tr * nTc + tc) * tile_bytes<S>(1 << tc_shift));
  }
};

// One warp a gap.
template <int S>
__global__ void __launch_bounds__(kLanes)
profile_walk_kernel(const uint8_t* __restrict__ dirs,
                    const long long* __restrict__ meta, int Tc, int tc_shift,
                    int L, int8_t* __restrict__ paths,
                    int32_t* __restrict__ nsteps) {
  extern __shared__ uint4 tile_smem[];
  const int g = blockIdx.x;
  const long long* m = meta + (long long)g * kFields;
  const int R = static_cast<int>(m[kR]);
  const int C = static_cast<int>(m[kC]);
  const GapTiles<S> loc{dirs + m[kDirsOff], (C + Tc - 1) >> tc_shift,
                        tc_shift};
  walk_path<S>(loc, R, C, Tc, tile_smem, paths + (long long)g * L,
               nsteps + g);
}

template <int S>
int launch_walk(const void* dirs, const void* meta, int Tc, int G, int L,
                void* paths, void* nsteps, cudaStream_t st) {
  static size_t smem_set[64] = {};
  const size_t smem = (size_t)tile_bytes<S>(Tc);  // one tile
  cudaError_t e = allow_smem(profile_walk_kernel<S>, smem, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  profile_walk_kernel<S><<<G, kLanes, smem, st>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const long long*>(meta),
      Tc, log2_of(Tc), L, static_cast<int8_t*>(paths),
      static_cast<int32_t*>(nsteps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fill of one batch of G gaps, cut into T tiles of (32 * S) x Tc cells
// (S 8 or 16; Tc a power of two, 32..1024).  Per-gap arrays are
// concatenated, with each gap's offsets in meta (G, 10) int64: R, C,
// rowgap, edge rowgap, and the offsets of its codes (int8, R), its columns
// (colsub (C, 5) and cg (C) int32), its top row (C + 1 int32), its
// direction bytes, its boundary store (int32 elements) and its flags.
// order (T, 3) int32: gap, tile row, tile column by ticket.  ctrl
// (1 + T) int32, zeroed: the ticket counter, then one flag a tile.
// bnd: the boundary store, nTr * (C + 1) + nTc * (R + 1) int32 a gap.
// dirs: nTr * nTc * 8 * S * Tc bytes a gap.  `workers` blocks of one warp
// are launched.  Returns cudaGetLastError().
extern "C" int csa_profile_fill(const void* codes, const void* colsub,
                                const void* cg, const void* top,
                                const void* meta, const void* order, int T,
                                void* ctrl, void* bnd, void* dirs, int S,
                                int Tc, int workers, void* stream) {
  if (T <= 0) return cudaSuccess;
  if (bad_tile(S, Tc) || workers < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return S == 8 ? launch_tile_fill<8, false>(codes, colsub, cg, top, meta,
                                             order, T, ctrl, bnd, dirs, Tc,
                                             workers, nullptr, nullptr,
                                             nullptr, st)
                : launch_tile_fill<16, false>(codes, colsub, cg, top, meta,
                                              order, T, ctrl, bnd, dirs, Tc,
                                              workers, nullptr, nullptr,
                                              nullptr, st);
}

// The walk over the directions of csa_profile_fill, same S, Tc, meta and
// dirs.  paths: (G, L) int8 with L >= max R + C; nsteps (G,) int32.
// Returns cudaGetLastError().
extern "C" int csa_profile_walk(const void* dirs, const void* meta, int S,
                                int Tc, int G, int L, void* paths,
                                void* nsteps, void* stream) {
  if (G <= 0) return cudaSuccess;
  if (bad_tile(S, Tc)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return S == 8 ? launch_walk<8>(dirs, meta, Tc, G, L, paths, nsteps, st)
                : launch_walk<16>(dirs, meta, Tc, G, L, paths, nsteps, st);
}
