// The tile engine of the profile-DP recurrence: a tiled multi-block fill
// and a one-warp walk, shared by csrc/profile_dp.cu (a batch of gaps) and
// csrc/band.cu (one band of one rank of the column-sharded DP).
//
// Recurrence (reference dynamicprogramming.c:993-1026), cell (j, c) with
// j = 1..R rows of the sequence, c = 1..C profile columns:
//   diag = dp[j-1][c-1] + colsub[c-1][code[j-1]]
//   up   = dp[j-1][c]   + rowgap
//   left = dp[j][c-1]   + cg[c-1]
// ties diag >= left >= up.  colsub/cg/rowgap fold the scoring and the
// column counts (built by the wrappers, dp/profile.py:_channels).  The
// boundaries are injected, not derived: dp[0][c] = top[c] (possibly
// stale), and dp[j][0] = j * edge_rowgap in a batch, left[j-1] in a band's
// launch (one gap, its left column given); row 0 wins at (0, 0).  A band
// also hands out its bottom row dp[R][0..C] (index 0 the left boundary)
// and its right edge dp[1..R][C].
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
// the left boundary.  In a band, the last tile row writes its bottom row
// and the last tile column its right column to the band's outputs too.
// The state of a fill is bounded by the tile, whatever C is.
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
// tiles of the whole launch so that both predecessors of a tile have lower
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
// flags are zeroed on the launch's stream before it starts.
//
// Directions: 2 bits a cell.  A tile is Tc * 32 words of 2 * S bits: word
// ((x + t) mod Tc) * 32 + t holds column x of lane t's strip in two planes
// of S bits, row k at bit S - 1 - k of each: the low plane says "left
// beats diag", the high plane "up beats both"; the walk reads UP if the
// high bit is set, else LEFT if the low bit is, else DIAG (D_DIAG=0,
// D_LEFT=1, D_UP=2 in the paths).  (x + t) is the step at which the
// word is produced, so the 32 lanes store one contiguous line a step.
// Tiles of a gap lie row-major at dirs_off; a ragged edge tile takes a
// whole tile's bytes and leaves the rest unwritten or undefined, and
// nothing reads it (dp/profile.py:dirs_address).
//
// Walk: one warp walks one path from (R, C) to (0, 0).  It copies the tile
// it stands in to shared memory (all lanes, 16-byte asynchronous copies),
// walks inside it, and loads the next tile when it crosses an edge; on the
// matrix edges it goes UP while j > 0, else LEFT.  It writes walk-order
// codes and the step count, so only those O(R + C) bytes go back to the
// host.  Where a tile lies is the caller's (a locator).
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLeft = 1;
constexpr int kUp = 2;
constexpr int kLanes = 32;
constexpr int kRound = 8;  // global loads a lane keeps in flight when staging
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a block may take without opting in
constexpr size_t kDefaultSmem = 48 * 1024;

// Columns of the per-gap int64 table `meta` (dp/profile.py:batch_layout).
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

// The value a lane keeps of the tile's last row: row S - 1 of its strip,
// or with kPick row k, known only at run time (without local memory).
template <int S, bool kPick>
__device__ __forceinline__ int32_t strip_row(const Strip<S>& st, int k) {
  if constexpr (kPick) {
    int32_t v = st.h[0];
#pragma unroll
    for (int q = 1; q < S; ++q) v = (q == k) ? st.h[q] : v;
    return v;
  } else {
    return st.h[S - 1];
  }
}

// dp[j][0]: the band's explicit left column, else j * edge_rowgap.
template <bool kBand>
__device__ __forceinline__ int32_t left_dp(const int32_t* left_col, int j,
                                           int32_t eg) {
  if constexpr (kBand) {
    return left_col[j - 1];
  } else {
    return j * eg;
  }
}

// Steps [from, to) of a tile.  kAll: every lane that owns a row computes
// at every one of these steps (the steady part of a tile), so the body is
// straight-line code for the whole warp; a lane that owns no row then
// computes garbage that nothing reads.  Otherwise lane t computes at steps
// [s_lo, s_hi).  `keeps_bottom` is set on the one lane that holds the
// tile's last row, and only where something reads that row: row S - 1 of
// the lane's strip, or with kPick row `keep_k` (a band's ragged last tile
// row).
// The scores and lane 0's top value are loaded one step ahead, so no
// shared-memory latency lies between a step's shuffle and its cells.
// A cell is m = max(diag, left) off the serial chain, then max(m, up) on
// it; the direction is kept as two sign bits, "left beats diag" (diag <
// left) and "up beats both" (m < up), which hold the ties diag >= left
// >= up and are shifted into two bit planes without a compare.
template <int S, bool kAll, bool kPick = false>
__device__ __forceinline__ void fill_steps(
    int from, int to, Strip<S>& st, const int32_t* (&pk)[S],
    const int32_t* s_top, int w, int t, int s_lo, int s_hi,
    typename DirWord<S>::type* dt, int col_mask, bool keeps_bottom,
    int32_t* botp, int keep_k = 0) {
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
      if (keeps_bottom) botp[s] = strip_row<S, kPick>(st, keep_k);
    }
#pragma unroll
    for (int k = 0; k < S; ++k) st.sv[k] = nv[k];
    st.topc = topn;
  }
}

// One worker (warp) per block.  kBand switches on, at compile time, what
// only a band's launch (one gap) does, so the batch fill (kBand false)
// compiles from the code it had before the band shared it: the gap's left
// column dp[1..R][0] from `left_col`, its bottom row dp[R][0..C] written to
// `bottom` and its right edge dp[1..R][C] to `edge`.  kRagged (a band
// whose R is not a multiple of the tile height; none on the main path)
// adds the general step for the last tile row, whose last row need not
// end a strip.  Code that a kernel carries outside its step loop changes
// how the compiler schedules the loop (an in-kernel reset of the tickets
// made the band's step markedly slower on the H100, PERF.md), so each of
// these is a separate instantiation rather than a run-time branch, and
// the band's entry zeroes the tickets with a memset.
template <int S, bool kBand, bool kRagged = false>
__global__ void __launch_bounds__(kLanes)
tile_fill_kernel(const int8_t* __restrict__ codes,
                 const int32_t* __restrict__ colsub,
                 const int32_t* __restrict__ cg,
                 const int32_t* __restrict__ top,
                 const long long* __restrict__ meta,
                 const int32_t* __restrict__ order, int T, int* ctrl,
                 int32_t* bnd, uint8_t* __restrict__ dirs, int Tc,
                 const int32_t* __restrict__ left_col,
                 int32_t* __restrict__ bottom, int32_t* __restrict__ edge) {
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
              v[u] = left_dp<kBand>(left_col, j0, eg);
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
          const int32_t dpv =
              (tc == 0) ? left_dp<kBand>(left_col, j0 + 1 + r, eg)
                        : __ldcg(Vcol + r);
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
    // a band hands every tile's bottom row on, the last tile row's out; the
    // tile's last row is row keep_k of lane nact - 1's strip, and in a
    // band that is not kRagged, row S - 1 of lane 31's
    const int keep_k = h - 1 - (nact - 1) * S;
    const bool keeps_bottom =
        kRagged ? t == nact - 1
                : t == kLanes - 1 && (kBand || tr + 1 < nTr);
    bool picked = false;
    if constexpr (kRagged) {
      if (keep_k != S - 1) {
        // a ragged last tile row (not on the main path, whose bands are
        // whole tiles): the general step, the row picked at run time
        fill_steps<S, false, true>(0, steps, st, pk, s_top, w, t, s_lo, s_hi,
                                   dt, Tc - 1, keeps_bottom, botp, keep_k);
        picked = true;
      }
    }
    if (!picked) {
      // the lanes ramp up, all compute, the lanes drain
      const int ramp = min(nact - 1, steps);
      const int steady = max(ramp, w);
      fill_steps<S, false>(0, ramp, st, pk, s_top, w, t, s_lo, s_hi, dt,
                           Tc - 1, keeps_bottom, botp);
      fill_steps<S, true>(ramp, steady, st, pk, s_top, w, t, s_lo, s_hi, dt,
                          Tc - 1, keeps_bottom, botp);
      fill_steps<S, false>(steady, steps, st, pk, s_top, w, t, s_lo, s_hi,
                           dt, Tc - 1, keeps_bottom, botp);
    }
    __syncwarp();
    if constexpr (kBand) {
      // hand the bottom row and the right column on, as plain dp values:
      // the last tile row's and column's are the band's outputs
      int32_t* Hn = tr + 1 < nTr ? H + (long long)(tr + 1) * (C + 1) + c0
                                 : bottom + c0;
      for (int xx = 1 + t; xx <= w; xx += kLanes) {
        Hn[xx] = s_bot[xx] + h * rg + s_P[xx];
      }
      if (tr + 1 == nTr && tc == 0 && t == 0) bottom[0] = left_col[R - 1];
      int32_t* Vn = tc + 1 < nTc ? V + (long long)(tc + 1) * (R + 1) + j0 + 1
                                 : edge + j0;
      const int32_t pw = s_P[w];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int r = t * S + k;
        if (r < h) Vn[r] = st.h[k] + (r + 1) * rg + pw;
      }
    } else {
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
    }
    __threadfence();
    __syncwarp();
    if (t == 0) st_release(flag, 1);
  }
}

// Walks one path from (j, c) to (0, 0); the whole warp takes part and lane
// 0 writes.  loc(j, c, j0, c0) returns the first byte of the tile that
// holds cell (j, c) (16-byte aligned) and sets the tile's first row and
// column less one, so the tile's cells are (j0 + 1.., c0 + 1..).
template <int S, class Locate>
__device__ __forceinline__ void walk_path(const Locate& loc, int j, int c,
                                          int Tc, uint4* tile_smem,
                                          int8_t* __restrict__ out,
                                          int32_t* __restrict__ nsteps) {
  using Word = typename DirWord<S>::type;
  const Word* sw = reinterpret_cast<const Word*>(tile_smem);
  const int t = threadIdx.x;
  const int vecs =
      static_cast<int>(Tc * kLanes * sizeof(Word) / sizeof(uint4));
  int s = 0;
  while (j > 0 && c > 0) {
    // enter the tile of (j, c): copy it, then walk until an edge is crossed
    int j0, c0;
    const uint4* src = loc(j, c, j0, c0);
    __syncwarp();
    // asynchronous 16-byte copies: all in flight at once, one wait
    for (int q = t; q < vecs; q += kLanes) {
      __pipeline_memcpy_async(&tile_smem[q], &src[q], sizeof(uint4));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    // tile-local row and column, the row's lane and slot, the word's row
    int rl = (j - 1) - j0;
    int xl = (c - 1) - c0;
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
    j = j0 + rl + 1;
    c = c0 + xl + 1;
  }
  for (int q = t; q < j; q += kLanes) out[s + q] = static_cast<int8_t>(kUp);
  s += j;
  for (int q = t; q < c; q += kLanes) out[s + q] = static_cast<int8_t>(kLeft);
  s += c;
  if (t == 0) *nsteps = s;
}

// Bytes of one tile's directions.
template <int S>
__host__ __device__ constexpr long long tile_bytes(int Tc) {
  return (long long)Tc * kLanes * (S / 4);
}

inline int log2_of(int Tc) {
  int shift = 0;
  while ((1 << shift) < Tc) ++shift;
  return shift;
}

bool bad_tile(int S, int Tc) {
  return (S != 8 && S != 16) || Tc < kLanes || Tc > 1024 ||
         (Tc & (Tc - 1)) != 0;
}

// Lets `kernel` take `bytes` of dynamic shared memory.  Only sizes above
// the default need the attribute, and it is set once a device: `done`
// holds the largest size set so far on each of the first 64 devices.
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes, size_t (&done)[64]) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && dev < 64) done[dev] = bytes;
  return e;
}

template <int S, bool kBand, bool kRagged = false>
int launch_tile_fill(const void* codes, const void* colsub, const void* cg,
                     const void* top, const void* meta, const void* order,
                     int T, void* ctrl, void* bnd, void* dirs, int Tc,
                     int workers, const void* left, void* bottom, void* edge,
                     cudaStream_t st) {
  // at most 33 KB (Tc = 1024): below the default, no attribute
  const size_t smem = (size_t)fill_smem_ints(Tc) * sizeof(int32_t);
  tile_fill_kernel<S, kBand, kRagged><<<workers, kLanes, smem, st>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(colsub),
      static_cast<const int32_t*>(cg), static_cast<const int32_t*>(top),
      static_cast<const long long*>(meta),
      static_cast<const int32_t*>(order), T, static_cast<int*>(ctrl),
      static_cast<int32_t*>(bnd), static_cast<uint8_t*>(dirs), Tc,
      static_cast<const int32_t*>(left), static_cast<int32_t*>(bottom),
      static_cast<int32_t*>(edge));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
