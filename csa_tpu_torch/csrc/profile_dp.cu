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
// Bound on this card: the serial dependence of the wavefront, not bytes or
// operations.  A cell is about ten int32 operations and the fill writes
// R*C/4 direction bytes; what limits it is that a cell waits for its three
// neighbours.  Design, for that: tiles, many workers, one launch.
//
// Tiles.  Every gap's R x C matrix is cut into tiles of Tr = 32 * S rows
// by Tc columns.  A tile reads the bottom row of the tile above and the
// right column of the tile to its left (corner included) from a global
// boundary store (per gap nTr x (C + 1) + nTc x (R + 1) int32, L2-resident)
// and writes its own bottom row and right column there.  Row 0 of the
// store is never used: tile row 0 takes `top` verbatim, tile column 0 takes
// j * edge_rowgap.  The state of a fill is bounded by the tile, whatever
// C is.
//
// Inside a tile, one warp and registers.  Lane t owns S consecutive rows
// (csrc/nw.cu's layout): their codes and their running DP values stay in
// registers, the lanes form a skewed wavefront (at step s lane t computes
// tile column s - t, top to bottom), and the strip's bottom value passes
// to lane t + 1 by one shuffle a step.  There is no block barrier.  The
// tile's column scores are staged into shared memory once, already
// shifted: with W[j][x] = dp[j][c0 + x] - (j - j0) * rowgap - P[x], where
// P is the running sum of cg inside the tile, an up move and a left move
// cost nothing and a diagonal move costs colsub - rowgap - cg, so a cell
// is one shared load, one add, two maxima and two funnel shifts that keep
// the signs of (diag - left) and (max(diag, left) - up) as its direction.
// The boundary store holds plain dp values, so the shift is private to a
// tile.  A lone warp starts about one instruction in three cycles on this
// card, so a step's instructions and exposed latencies are the tile's
// time: the scores are loaded one step ahead; the directions are sign
// bits, because a compare and select per cell queued on the few predicate
// registers; the bottom row is one predicated store, because a divergent
// branch cost a quarter of the step; and the steady part of a tile, where
// every lane computes, is straight-line code.
//
// Across tiles, a ticket queue with ready flags.  The wrapper numbers the
// tiles of the whole batch so that both predecessors of a tile have lower
// numbers (dp/profile.py:tile_order: by tile anti-diagonal, gaps
// interleaved).  A worker (one warp, one block) takes the next ticket from
// an atomic counter, waits for the flags of the tile above and the tile to
// the left (acquire loads), fills its tile, fences, sets its own flag
// (release store) and takes the next ticket.  All that a tile needs from
// no other tile (P, the scores, the codes) is staged before the wait, with
// the global loads sent in rounds, so a worker that took its ticket
// early has only the two boundaries left to read.  A ticket is only ever
// held by a running worker and a worker waits only on lower tickets, so
// it always waits on a worker that is already running: no deadlock,
// however many workers are resident, and also when several such launches
// share the card on different streams.  Nothing depends on blockIdx
// order.  Boundary values written during the launch are read with
// ld.global.cg (L2), never through L1 or the read-only path.  Counter and
// flags are zeroed by the wrapper on the launch's stream.
//
// Directions: 2 bits a cell.  A tile is Tc * 32 words of 2 * S bits: word
// ((x + t) mod Tc) * 32 + t holds column x of lane t's strip in two planes
// of S bits, row k at bit S - 1 - k of each: the low plane says "left
// beats diag", the high plane "up beats both"; the walk reads UP if the
// high bit is set, else LEFT if the low bit is, else DIAG (D_DIAG=0,
// D_LEFT=1, D_UP=2 in the paths).  (x + t) is the step at which the
// word is produced, so the 32 lanes store one contiguous line a step.
// Tiles of a gap lie row-major at dirs_off; a ragged edge tile takes a
// whole tile's bytes and leaves the rest unwritten and unread.
//
// Backtrack: one warp per gap walks from (R, C) to (0, 0).  It copies the
// tile it stands in to shared memory (all lanes), walks inside it, and
// loads the next tile when it crosses an edge; on the matrix edges it goes
// UP while j > 0, else LEFT.  It writes walk-order codes and the step
// count, so only those O(R + C) bytes go back to the host.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLeft = 1;
constexpr int kUp = 2;
constexpr int kLanes = 32;
constexpr int kRound = 8;  // global loads a lane keeps in flight when staging
constexpr unsigned kFull = 0xffffffffu;

// Columns of the per-gap int64 table `meta` (dp/profile.py:_upload).
enum Meta {
  kR, kC, kRowgap, kEdgeRowgap, kCodeOff, kColOff, kTopOff, kDirsOff,
  kBndOff, kFlagOff, kFields
};

template <int S> struct DirWord;
template <> struct DirWord<8> { using type = uint16_t; };
template <> struct DirWord<16> { using type = uint32_t; };

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

__device__ __forceinline__ void wait_flag(const int* p) {
  while (ld_acquire(p) == 0) __nanosleep(40);
}

// Ints of shared memory one worker needs: P, top and bottom rows (Tc + 1
// each), then sub (5 x Tc, by code then column) with kLanes + 1 ints of
// slack behind it: a lane's prefetch runs up to kLanes columns off either
// end of a row of sub.
__host__ __device__ constexpr int fill_smem_ints(int Tc) {
  return 3 * (Tc + 1) + 5 * Tc + kLanes + 1;
}

// The state a lane carries from step to step of one tile.
template <int S>
struct Strip {
  int32_t h[S];    // W of the strip's rows at the last column computed
  int32_t sv[S];   // the rows' shifted scores at this step's column
  int32_t dtop;    // W of the row above the strip at the previous column
  int32_t topc;    // lane 0: the top boundary at this step's column
};

// Steps [from, to) of a tile.  kAll: every lane that owns a row computes
// at every one of these steps (the steady part of a tile), so the body is
// straight-line code for the whole warp; a lane that owns no row then
// computes garbage that nothing reads.  Otherwise lane t computes at steps
// [s_lo, s_hi).  `keeps_bottom` is set on the one lane that holds the
// tile's last row, and only where a tile below will read it: such a tile
// has full height, so the row is the last of lane 31's strip.
// The scores and lane 0's top value are loaded one step ahead, so no
// shared-memory latency lies between a step's shuffle and its cells.
// A cell is m = max(diag, left) off the serial chain, then max(m, up) on
// it; the direction is kept as two sign bits, "left beats diag" (diag <
// left) and "up beats both" (m < up), which hold the ties diag >= left
// >= up and are shifted into two bit planes without a compare.
template <int S, bool kAll>
__device__ __forceinline__ void fill_steps(
    int from, int to, Strip<S>& st, const int32_t* (&pk)[S],
    const int32_t* s_top, int w, int t, int s_lo, int s_hi,
    typename DirWord<S>::type* dt, int col_mask, bool keeps_bottom,
    int32_t* botp) {
  using Word = typename DirWord<S>::type;
#pragma unroll 2
  for (int s = from; s < to; ++s) {
    int32_t nv[S];
#pragma unroll
    for (int k = 0; k < S; ++k) nv[k] = pk[k][s + 1];
    const int32_t topn = s_top[min(s + 2, w)];
    int32_t upin = __shfl_up_sync(kFull, st.h[S - 1], 1);
    if (t == 0) upin = st.topc;
    if (kAll || (s >= s_lo && s < s_hi)) {
      int32_t dg = st.dtop;
      int32_t up = upin;
      uint32_t left_wins = 0;  // one bit a row, row 0 highest
      uint32_t up_wins = 0;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int32_t old = st.h[k];
        const int32_t cand = dg + st.sv[k];
        const int32_t m = max(cand, old);
        const int32_t v = max(m, up);
        // the sign bit of a difference, shifted in: no predicate registers
        left_wins = __funnelshift_l(cand - old, left_wins, 1);
        up_wins = __funnelshift_l(m - up, up_wins, 1);
        dg = old;
        up = v;
        st.h[k] = v;
      }
      const uint32_t bits = left_wins | (up_wins << S);
      st.dtop = upin;
      dt[(s & col_mask) * kLanes] = static_cast<Word>(bits);
      if (keeps_bottom) botp[s] = st.h[S - 1];
    }
#pragma unroll
    for (int k = 0; k < S; ++k) st.sv[k] = nv[k];
    st.topc = topn;
  }
}

// One worker (warp) per block.
template <int S>
__global__ void __launch_bounds__(kLanes)
profile_fill_kernel(const int8_t* __restrict__ codes,
                    const int32_t* __restrict__ colsub,
                    const int32_t* __restrict__ cg,
                    const int32_t* __restrict__ top,
                    const long long* __restrict__ meta,
                    const int32_t* __restrict__ order, int T, int* ctrl,
                    int32_t* bnd, uint8_t* __restrict__ dirs, int Tc) {
  using Word = typename DirWord<S>::type;
  constexpr int Tr = S * kLanes;
  extern __shared__ int32_t smem[];
  int32_t* s_P = smem;
  int32_t* s_top = s_P + Tc + 1;
  int32_t* s_bot = s_top + Tc + 1;
  int32_t* s_sub = s_bot + Tc + 1;
  const int t = threadIdx.x;
  int* flags = ctrl + 1;

  for (;;) {
    int n = 0;
    if (t == 0) n = atomicAdd(ctrl, 1);
    n = __shfl_sync(kFull, n, 0);
    if (n >= T) break;
    const int g = order[3 * n];
    const int tr = order[3 * n + 1];
    const int tc = order[3 * n + 2];
    const long long* m = meta + (long long)g * kFields;
    const int R = static_cast<int>(m[kR]);
    const int C = static_cast<int>(m[kC]);
    const int32_t rg = static_cast<int32_t>(m[kRowgap]);
    const int32_t eg = static_cast<int32_t>(m[kEdgeRowgap]);
    const int nTr = (R + Tr - 1) / Tr;
    const int nTc = (C + Tc - 1) / Tc;
    const int tile = tr * nTc + tc;
    int* flag = flags + m[kFlagOff] + tile;
    const int j0 = tr * Tr;
    const int c0 = tc * Tc;
    const int h = min(Tr, R - j0);
    const int w = min(Tc, C - c0);
    int32_t* H = bnd + m[kBndOff];                 // nTr x (C + 1)
    int32_t* V = H + (long long)nTr * (C + 1);     // nTc x (R + 1)
    const int32_t* subg = colsub + (m[kColOff] + c0) * 5;
    const int32_t* cgg = cg + m[kColOff] + c0;

    // Staged before the wait: all that does not depend on other tiles.
    // Global loads go in rounds of kRound a lane, all started before the
    // first is used.
    // P[x] = sum of cg over the tile's first x columns, x = 0..w: cg
    // itself first, then each lane sums its run of columns in place
    for (int base = 0; base < w; base += kRound * kLanes) {
      int32_t v[kRound];
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int x = base + u * kLanes + t;
        v[u] = (x < w) ? cgg[x] : 0;
      }
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int x = base + u * kLanes + t;
        if (x < w) s_P[x + 1] = v[u];
      }
    }
    __syncwarp();
    {
      const int per = Tc / kLanes;
      const int x0 = t * per;
      int32_t acc = 0;
      for (int q = 0; q < per; ++q) {
        if (x0 + q < w) acc += s_P[x0 + q + 1];
      }
      int32_t incl = acc;
#pragma unroll
      for (int d = 1; d < kLanes; d <<= 1) {
        const int32_t o = __shfl_up_sync(kFull, incl, d);
        if (t >= d) incl += o;
      }
      int32_t run = incl - acc;
      if (t == 0) s_P[0] = 0;
      for (int q = 0; q < per; ++q) {
        if (x0 + q < w) {
          run += s_P[x0 + q + 1];
          s_P[x0 + q + 1] = run;
        }
      }
    }
    __syncwarp();
    // shifted diagonal scores, by code then column (conflict-free reads)
    for (int base = 0; base < w * 5; base += kRound * kLanes) {
      int32_t v[kRound];
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int idx = base + u * kLanes + t;
        v[u] = (idx < w * 5) ? subg[idx] : 0;
      }
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int idx = base + u * kLanes + t;
        if (idx < w * 5) {
          const int x = idx / 5;
          const int b = idx - x * 5;
          s_sub[b * Tc + x] = v[u] - rg - (s_P[x + 1] - s_P[x]);
        }
      }
    }
    // this lane's strip: rows j0 + 1 + t * S + k; pk[k][s] is the shifted
    // score of row k at the lane's column of step s (column s - t)
    const int32_t* pk[S];
    {
      const int8_t* codeg = codes + m[kCodeOff] + j0;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int r = t * S + k;
        int b = (r < h) ? codeg[r] : 4;
        b = (b < 0 || b > 4) ? 4 : b;
        pk[k] = s_sub + b * Tc - t;
      }
    }

    // every lane polls (one broadcast load), so every lane has acquired
    if (tr > 0) wait_flag(flag - nTc);
    if (tc > 0) wait_flag(flag - 1);
    __syncwarp();

    // top boundary row, corner at index 0
    {
      const int32_t* topg = top + m[kTopOff];
      const int32_t* Hrow = H + (long long)tr * (C + 1);
      for (int base = 0; base <= w; base += kRound * kLanes) {
        int32_t v[kRound];
#pragma unroll
        for (int u = 0; u < kRound; ++u) {
          const int xx = base + u * kLanes + t;
          const int c = c0 + xx;
          v[u] = 0;
          if (xx <= w) {
            if (tr == 0) {
              v[u] = topg[c];
            } else if (c == 0) {
              v[u] = j0 * eg;
            } else {
              v[u] = __ldcg(Hrow + c);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kRound; ++u) {
          const int xx = base + u * kLanes + t;
          if (xx <= w) s_top[xx] = v[u] - s_P[xx];
        }
      }
    }
    Strip<S> st;
    {
      const int32_t* Vcol = V + (long long)tc * (R + 1) + j0 + 1;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int r = t * S + k;
        int32_t left = 0;
        if (r < h) {
          const int32_t dpv = (tc == 0) ? (j0 + 1 + r) * eg : __ldcg(Vcol + r);
          left = dpv - (r + 1) * rg;
        }
        st.h[k] = left;
      }
    }
    __syncwarp();
    st.dtop = __shfl_up_sync(kFull, st.h[S - 1], 1);
    if (t == 0) st.dtop = s_top[0];
#pragma unroll
    for (int k = 0; k < S; ++k) st.sv[k] = pk[k][0];
    st.topc = s_top[1];

    const int nact = (h + S - 1) / S;  // lanes that own a row
    const int steps = w + nact - 1;
    const int s_lo = (t < nact) ? t : steps;  // the lane's steps: [s_lo, s_hi)
    const int s_hi = t + w;
    Word* dt = reinterpret_cast<Word*>(dirs + m[kDirsOff]) +
               (long long)tile * Tc * kLanes + t;
    int32_t* botp = s_bot + 1 - t;
    const bool keeps_bottom = t == kLanes - 1 && tr + 1 < nTr;
    // the lanes ramp up, all compute, the lanes drain
    const int ramp = min(nact - 1, steps);
    const int steady = max(ramp, w);
    fill_steps<S, false>(0, ramp, st, pk, s_top, w, t, s_lo, s_hi, dt,
                         Tc - 1, keeps_bottom, botp);
    fill_steps<S, true>(ramp, steady, st, pk, s_top, w, t, s_lo, s_hi, dt,
                        Tc - 1, keeps_bottom, botp);
    fill_steps<S, false>(steady, steps, st, pk, s_top, w, t, s_lo, s_hi, dt,
                         Tc - 1, keeps_bottom, botp);
    __syncwarp();
    // hand the bottom row and the right column on, as plain dp values
    if (tr + 1 < nTr) {
      int32_t* Hnext = H + (long long)(tr + 1) * (C + 1) + c0;
      for (int xx = 1 + t; xx <= w; xx += kLanes) {
        Hnext[xx] = s_bot[xx] + h * rg + s_P[xx];
      }
    }
    if (tc + 1 < nTc) {
      int32_t* Vnext = V + (long long)(tc + 1) * (R + 1) + j0 + 1;
      const int32_t pw = s_P[w];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int r = t * S + k;
        if (r < h) Vnext[r] = st.h[k] + (r + 1) * rg + pw;
      }
    }
    __threadfence();
    __syncwarp();
    if (t == 0) st_release(flag, 1);
  }
}

template <int S>
__global__ void __launch_bounds__(kLanes)
profile_backtrack_kernel(const uint8_t* __restrict__ dirs,
                         const long long* __restrict__ meta, int Tc,
                         int tc_shift, int L, int8_t* __restrict__ paths,
                         int32_t* __restrict__ nsteps) {
  using Word = typename DirWord<S>::type;
  constexpr int Tr = S * kLanes;
  extern __shared__ uint4 tile_smem[];
  const Word* sw = reinterpret_cast<const Word*>(tile_smem);
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const long long* m = meta + (long long)g * kFields;
  int j = static_cast<int>(m[kR]);
  int c = static_cast<int>(m[kC]);
  const int nTc = (c + Tc - 1) >> tc_shift;
  const uint8_t* d = dirs + m[kDirsOff];
  const long long tile_bytes = (long long)Tc * kLanes * sizeof(Word);
  const int vecs = static_cast<int>(tile_bytes / sizeof(uint4));
  int8_t* out = paths + (long long)g * L;
  int s = 0;
  // every lane walks the same path; lane 0 writes it
  while (j > 0 && c > 0) {
    // enter the tile of (j, c): copy it, then walk until an edge is crossed
    const int tr = (j - 1) / Tr;
    const int tc = (c - 1) >> tc_shift;
    __syncwarp();
    const uint4* src = reinterpret_cast<const uint4*>(
        d + (tr * nTc + tc) * tile_bytes);
    // asynchronous 16-byte copies: all in flight at once, one wait
    for (int q = t; q < vecs; q += kLanes) {
      __pipeline_memcpy_async(&tile_smem[q], &src[q], sizeof(uint4));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    // tile-local row and column, the row's lane and slot, the word's row
    int rl = (j - 1) - tr * Tr;
    int xl = (c - 1) - (tc << tc_shift);
    int lane = rl / S;
    int k = rl - lane * S;
    int sm = (xl + lane) & (Tc - 1);
    while (rl >= 0 && xl >= 0) {
      const unsigned word = sw[sm * kLanes + lane] >> (S - 1 - k);
      const int dcode = ((word >> S) & 1) ? kUp : (word & 1) ? kLeft : 0;
      if (t == 0) out[s] = static_cast<int8_t>(dcode);
      ++s;
      const int dj = dcode != kLeft;  // the move goes up a row
      const int dc = dcode != kUp;    // the move goes left a column
      rl -= dj;
      xl -= dc;
      k -= dj;
      const int prev_lane = k < 0;    // into the strip of the lane above
      k += prev_lane * S;
      lane -= prev_lane;
      sm = (sm - dc - prev_lane) & (Tc - 1);
    }
    j = tr * Tr + rl + 1;
    c = (tc << tc_shift) + xl + 1;
  }
  for (int q = t; q < j; q += kLanes) out[s + q] = static_cast<int8_t>(kUp);
  s += j;
  for (int q = t; q < c; q += kLanes) out[s + q] = static_cast<int8_t>(kLeft);
  s += c;
  if (t == 0) nsteps[g] = s;
}

bool bad_tile(int S, int Tc) {
  return (S != 8 && S != 16) || Tc < kLanes || Tc > 1024 ||
         (Tc & (Tc - 1)) != 0;
}

template <int S>
int launch_fill(const void* codes, const void* colsub, const void* cg,
                const void* top, const void* meta, const void* order, int T,
                void* ctrl, void* bnd, void* dirs, int Tc, int workers,
                cudaStream_t st) {
  const size_t smem = (size_t)fill_smem_ints(Tc) * sizeof(int32_t);
  profile_fill_kernel<S><<<workers, kLanes, smem, st>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(colsub),
      static_cast<const int32_t*>(cg), static_cast<const int32_t*>(top),
      static_cast<const long long*>(meta), static_cast<const int32_t*>(order),
      T, static_cast<int*>(ctrl), static_cast<int32_t*>(bnd),
      static_cast<uint8_t*>(dirs), Tc);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_walk(const void* dirs, const void* meta, int Tc, int G, int L,
                void* paths, void* nsteps, cudaStream_t st) {
  int tc_shift = 0;
  while ((1 << tc_shift) < Tc) ++tc_shift;
  const size_t smem = (size_t)Tc * kLanes * (S / 4);  // one tile
  cudaError_t e = cudaFuncSetAttribute(
      profile_backtrack_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  profile_backtrack_kernel<S><<<G, kLanes, smem, st>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const long long*>(meta),
      Tc, tc_shift, L, static_cast<int8_t*>(paths),
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
  return S == 8 ? launch_fill<8>(codes, colsub, cg, top, meta, order, T, ctrl,
                                 bnd, dirs, Tc, workers, st)
                : launch_fill<16>(codes, colsub, cg, top, meta, order, T,
                                  ctrl, bnd, dirs, Tc, workers, st);
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
