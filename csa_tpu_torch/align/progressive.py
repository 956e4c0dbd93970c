"""Progressive profile DP over inter-anchor gaps (the port's copy of
:mod:`csa_tpu.align.progressive`).

Exact-semantics re-implementation of the reference's per-gap MSA engine
(``source/dynamicprogramming.c``): sequences ordered shortest-first
(``SortSequencesForDP`` :276-308), each aligned by Needleman-Wunsch
against the expanding column-count profile (recurrence :993-998 with
tie-break diag >= left >= up :1014-1026), consensus grown during
backtrack (:1032-1138), followed by the gap-block shift compaction pass
(``DeleteGappedColumns`` :643-899).

The host state machine (shortest-first order, emulated DP allocation
with its stale boundaries, merge, DeleteGappedColumns) is
:class:`GapProgressiveState`.  Two routes drive it, as in ``csa_tpu``:

* the host routes (``native``, ``numpy``): :func:`progressive_dp`, one
  gap at a time, every fill on the native host library (its numpy twin
  :func:`dp_fill` when the library is missing);
* the ``device`` route: :func:`progressive_dp_batched`, which sends a
  round's fills to :func:`..dp.profile.profile_paths` as one launch,
  or, with a rank mesh, to :func:`..dp.profile.profile_paths_sharded`
  and the column-sharded :func:`..dp.seqpar.dp_path_seqpar`.  Two gates
  of the installed :class:`..config.RunConfig` keep small work on the
  host: a round's batch below ``batch_min_cells`` cells (no mesh only),
  and a merge below ``device_min_cells`` cells where merges go one by
  one.  Their defaults are the crossovers measured on the H100.
  Degenerate fills (no rows or no columns) always stay on the host.

The host merge and the kernels' wrappers score with the installed
RunConfig's ``scoring``, read once a call.

Char codes: A=0 C=1 G=2 T=3 gap=4.
"""

from __future__ import annotations

from dataclasses import asdict
from typing import List, Optional

import numpy as np

from .. import config, native
from ..dp import profile, seqpar
from ..parallel.sharded import relabel
from ..utils import PROFILER, sync

__all__ = ["progressive_dp", "progressive_dp_batched", "BATCH_DIRS_BYTES",
           "BATCH_DIRS_CAP", "MIN_BATCH"]

GAP = 4

# direction codes
D_DIAG = 0
D_LEFT = 1
D_UP = 2

def sort_sequences_for_dp(gaplens: np.ndarray):
    """Selection sort, shortest gap first (dynamicprogramming.c:276-308).

    Returns (orderedseqs, seqlengths) exactly as the reference computes
    them (first minimum wins; swap placement).
    """
    k = len(gaplens)
    ordered = list(range(k))
    lens = [int(x) for x in gaplens]
    for i in range(k - 1):
        minv = lens[i]
        minpos = i
        for j in range(i + 1, k):
            if lens[j] < minv:
                minv = lens[j]
                minpos = j
        if minpos != i:
            ordered[i], ordered[minpos] = ordered[minpos], ordered[i]
            lens[i], lens[minpos] = lens[minpos], lens[i]
    return ordered, lens


def default_top_row(scorevector: np.ndarray, i: int) -> np.ndarray:
    """Fresh dp[0][*] boundary: cumulative horizontal gap costs
    (dynamicprogramming.c:969-973)."""
    sc = config.run_config().scoring
    return profile.default_top_row(scorevector, i, indel=sc.indel,
                                   doublegap=sc.doublegap)


def dp_fill(
    row_codes: np.ndarray,
    scorevector: np.ndarray,
    i: int,
    top_row: Optional[np.ndarray] = None,
    edge_rowgap: Optional[int] = None,
):
    """Fill the DP matrix for one sequence against the current profile.

    row_codes: (nrows,) char codes of the sequence's gap substring.
    scorevector: (ncols, 5) counts of each char code per profile column
    (0-indexed here; the reference's column c is scorevector[c-1]).
    i: number of previously aligned sequences.
    top_row / edge_rowgap: dp boundary values (dp[0][*] and the per-row
    scale of dp[j][0]).  The reference re-initializes these only when it
    reallocates its DP matrix (dynamicprogramming.c:957-987), so between
    same-shape merges they are STALE values from the allocating merge;
    progressive_dp threads the emulated allocation state through here.
    Defaults reproduce a fresh allocation.

    Returns (score, dirs) where dirs is (nrows+1, ncols+1) int8.
    Dispatches to the native host kernel when built (bit-identical);
    falls back to the anti-diagonal numpy sweep.
    """
    match, mismatch, indel, doublegap = config.run_config().scoring.as_tuple()
    if top_row is None:
        top_row = default_top_row(scorevector, i)
    if edge_rowgap is None:
        edge_rowgap = indel * i
    if len(row_codes) and len(scorevector):
        res = native.dp_fill_dirs(row_codes, scorevector, i, top_row, edge_rowgap)
        if res is not None:
            return res
    nrows = len(row_codes)
    ncols = len(scorevector)
    sv_gap = scorevector[:, GAP]  # (ncols,)

    # per-(row j, col c) substitution score and move costs
    # score(j,c) = match*cnt[char_j] + indel*cnt[gap] + mismatch*(i - cnt[char_j] - cnt[gap])
    # code 4 (IUPAC N, R, Y, ...) takes a column of zero counts, as the
    # kernels score it (dp/profile.py:_channels)
    counts = np.concatenate(
        [scorevector[:, :4], np.zeros((ncols, 1), scorevector.dtype)], axis=1)
    cnt_char = counts.take(row_codes, axis=1).T  # (nrows, ncols)
    sub = (
        match * cnt_char
        + indel * sv_gap[None, :]
        + mismatch * (i - cnt_char - sv_gap[None, :])
    )
    rowgap = indel * i  # scalar, vertical move
    colgap = doublegap * sv_gap + indel * (i - sv_gap)  # (ncols,), horizontal

    dp = np.zeros((nrows + 1, ncols + 1), dtype=np.int64)
    dirs = np.zeros((nrows + 1, ncols + 1), dtype=np.int8)
    dp[:, 0] = np.arange(nrows + 1) * edge_rowgap
    dp[0, :] = top_row[: ncols + 1]
    dirs[:, 0] = D_UP
    dirs[0, 1:] = D_LEFT
    dirs[0, 0] = D_DIAG

    # anti-diagonal sweep: cells (j, c) with j + c = d
    for d in range(2, nrows + ncols + 1):
        j_lo = max(1, d - ncols)
        j_hi = min(nrows, d - 1)
        if j_lo > j_hi:
            continue
        j = np.arange(j_lo, j_hi + 1)
        c = d - j
        diag = dp[j - 1, c - 1] + sub[j - 1, c - 1]
        up = dp[j - 1, c] + rowgap
        left = dp[j, c - 1] + colgap[c - 1]
        take_diag = (diag >= up) & (diag >= left)
        take_left = ~take_diag & (left >= up)
        val = np.where(take_diag, diag, np.where(take_left, left, up))
        dp[j, c] = val
        dirs[j, c] = np.where(
            take_diag, D_DIAG, np.where(take_left, D_LEFT, D_UP)
        ).astype(np.int8)
    return int(dp[nrows, ncols]), dirs


def _dirs_to_maps(dirs: np.ndarray, nrows: int, ncols: int):
    """Walk the direction matrix from (nrows, ncols) back to (0, 0),
    recording per new column the source old column (-1 for a fresh
    all-gap column) and the current-sequence row (-1 for a gap in the
    current sequence); returned in forward (left-to-right) order."""
    j, c = nrows, ncols
    old_cols_r: List[int] = []
    row_r: List[int] = []
    while j > 0 and c > 0:
        dcode = dirs[j, c]
        if dcode == D_DIAG:
            old_cols_r.append(c - 1)
            row_r.append(j - 1)
            j -= 1
            c -= 1
        elif dcode == D_LEFT:
            old_cols_r.append(c - 1)
            row_r.append(-1)
            c -= 1
        else:  # D_UP
            old_cols_r.append(-1)
            row_r.append(j - 1)
            j -= 1
    while j > 0:
        old_cols_r.append(-1)
        row_r.append(j - 1)
        j -= 1
    while c > 0:
        old_cols_r.append(c - 1)
        row_r.append(-1)
        c -= 1
    old_cols = np.asarray(old_cols_r[::-1], dtype=np.int64)
    rows = np.asarray(row_r[::-1], dtype=np.int64)
    return old_cols, rows


def _path_to_maps(path_codes: np.ndarray):
    """Same maps from a walk-order direction-code path (device backtrack,
    :func:`csa_tpu_torch.dp.profile.profile_paths`), vectorized: in forward
    order, the t-th row-consuming step consumes row (count-1), ditto
    columns."""
    codes_f = np.asarray(path_codes[::-1], dtype=np.int64)
    adv_row = codes_f != D_LEFT
    adv_col = codes_f != D_UP
    rows = np.where(adv_row, np.cumsum(adv_row) - 1, -1)
    old_cols = np.where(adv_col, np.cumsum(adv_col) - 1, -1)
    return old_cols, rows


def _merge_from_maps(
    old_cols: np.ndarray,
    rows: np.ndarray,
    row_codes: np.ndarray,
    strings: List[Optional[np.ndarray]],
    scorevector: np.ndarray,
    ordered: List[int],
    i: int,
    n: int,
):
    consensussize = len(old_cols)

    has_old = old_cols >= 0
    has_row = rows >= 0
    old_idx = old_cols[has_old]

    new_sv = np.zeros((consensussize, 5), dtype=np.int64)
    new_sv[has_old] = scorevector[old_idx]
    new_sv[~has_old, GAP] = i
    cur = np.full(consensussize, GAP, dtype=np.int8)
    cur[has_row] = row_codes[rows[has_row]].astype(np.int8)
    np.add.at(new_sv, (np.arange(consensussize), cur.astype(np.int64)), 1)

    new_strings: List[Optional[np.ndarray]] = [None] * len(strings)
    for t in range(i):
        p = ordered[t]
        ns = np.full(consensussize, GAP, dtype=np.int8)
        ns[has_old] = strings[p][old_idx]
        new_strings[p] = ns
    new_strings[n] = cur
    return new_strings, new_sv, consensussize


def _run_scan(window: np.ndarray, start: int, limit: int, value: int,
              find_value: bool) -> int:
    """First index >= start where window == value (find_value) or
    != value (not find_value); returns limit if none.  Doubling chunks
    keep short runs cheap inside huge windows."""
    chunk = 64
    pos = start
    while pos < limit:
        end = min(pos + chunk, limit)
        seg = window[pos:end]
        hits = np.nonzero((seg == value) if find_value else (seg != value))[0]
        if len(hits):
            return pos + int(hits[0])
        pos = end
        chunk *= 4
    return limit


def delete_gapped_columns(
    usableseqs: List[int],
    strings: List[Optional[np.ndarray]],
    numseqs: int,
    scorevector: np.ndarray,
    consize: int,
    maxnongaps: int,
):
    """Gap-block shift compaction (dynamicprogramming.c:643-899), exact.

    strings are code arrays of logical length >= consize (codes 0-4);
    scorevector is (cap, 5) with logical length consize.  Returns the new
    consize; strings and scorevector are modified in place.

    Dispatches to the native host kernel (csa_host.cpp::csa_dgc,
    bit-identical) when it is built; the numpy path below is the
    exactness twin and fallback.
    """
    if consize:
        res = native.dgc(
            usableseqs, strings, numseqs, scorevector, consize, maxnongaps
        )
        if res is not None:
            return res
    match, mismatch, indel, doublegap = config.run_config().scoring.as_tuple()
    mingaps = numseqs - maxnongaps
    col = 1
    while col <= consize:
        if scorevector[col - 1, GAP] < mingaps:
            col += 1
            continue
        seqstoshift = [
            ii for ii in usableseqs[:numseqs] if strings[ii][col - 1] != GAP
        ]
        ntoshift = len(seqstoshift)
        if ntoshift == 0:
            col += 1
            continue
        bestscore = 0
        bestshift = 0
        bestdir = 0
        best_nposaffected = None
        best_maxposaffected = 0
        best_workingsv = None
        looplimit = consize + 1
        dirsignal = 1
        while True:
            # find, per shifting sequence, the non-gap run from col and the
            # gap run after it, in direction dirsignal (vectorized scans)
            postonextgap = []
            nnextgaps = []
            hit_end = False
            postofarthestgap = 0
            minnextgaps = consize
            for ii in seqstoshift:
                s = strings[ii]
                if dirsignal > 0:
                    window = s[col - 1 : looplimit - 1]
                else:
                    window = s[col - 1 :: -1]  # looplimit is 0 going left
                wlen = len(window)
                cnt = _run_scan(window, 0, wlen, GAP, find_value=True)
                if cnt >= wlen:
                    hit_end = True
                    break
                postonextgap.append(cnt)
                if cnt > postofarthestgap:
                    postofarthestgap = cnt
                gend = _run_scan(window, cnt, wlen, GAP, find_value=False)
                g = gend - cnt
                nnextgaps.append(g)
                if g < minnextgaps:
                    minnextgaps = g
            if hit_end:
                if dirsignal == -1:
                    break
                looplimit = 0
                dirsignal = -1
                continue
            nposaffected = [p + minnextgaps for p in postonextgap]
            maxposaffected = postofarthestgap + minnextgaps

            # static / moving count vectors over the affected window
            cols_idx = col + dirsignal * np.arange(maxposaffected) - 1
            staticsv = scorevector[cols_idx].copy()  # (maxpos, 5)
            movingsv = np.zeros((maxposaffected, 5), dtype=np.int64)
            window_codes = np.stack(
                [strings[ii][cols_idx] for ii in seqstoshift]
            ).astype(np.int64)  # (ntoshift, maxpos)
            inblock = (
                np.arange(maxposaffected)[None, :]
                < np.asarray(nposaffected)[:, None]
            )
            for kk in range(ntoshift):
                idxs = np.nonzero(inblock[kk])[0]
                np.add.at(movingsv, (idxs, window_codes[kk][idxs]), 1)
            staticsv = staticsv - movingsv

            # current (unshifted) score of the moving chars
            sv_win = scorevector[cols_idx]
            mc = movingsv[:, :4]
            sc = sv_win[:, :4]
            colscore = np.where(
                mc != 0,
                mc
                * (
                    match * (sc - 1)
                    + mismatch
                    * (numseqs - (sc + sv_win[:, GAP][:, None]))
                    + indel * sv_win[:, GAP][:, None]
                ),
                0,
            ).sum()
            mg = movingsv[:, GAP]
            colscore += np.where(
                mg != 0,
                mg
                * (
                    doublegap * (sv_win[:, GAP] - 1)
                    + indel * (numseqs - sv_win[:, GAP])
                ),
                0,
            ).sum()
            currentscore = int(colscore)

            # simulate shifts 1..minnextgaps; the reference peels one
            # trailing gap off each moving block per iteration
            moving_i = movingsv.copy()
            nposaff_i = list(nposaffected)
            found_dir_best = False
            for sh in range(1, minnextgaps + 1):
                for kk in range(ntoshift):
                    nposaff_i[kk] -= 1
                    moving_i[nposaff_i[kk], GAP] -= 1
                working = np.empty_like(staticsv)
                jarr = np.arange(maxposaffected)
                lead = jarr < sh
                working[lead] = 0
                working[lead, GAP] = staticsv[lead, GAP] + ntoshift
                src = np.clip(jarr - sh, 0, maxposaffected - 1)
                working[~lead] = staticsv[~lead] + moving_i[src[~lead]]
                full_gap = working[:, GAP] == numseqs
                wsc = working[:, :4]
                wg = working[:, GAP]
                sc_lead = np.where(
                    lead & ~full_gap,
                    ntoshift
                    * (doublegap * (wg - 1) + indel * (numseqs - wg)),
                    0,
                )
                msrc = moving_i[src]
                sc_body_c = np.where(
                    (~lead & ~full_gap)[:, None] & (msrc[:, :4] != 0),
                    msrc[:, :4]
                    * (
                        match * (wsc - 1)
                        + mismatch * (numseqs - (wsc + wg[:, None]))
                        + indel * wg[:, None]
                    ),
                    0,
                ).sum(axis=1)
                sc_body_g = np.where(
                    (~lead & ~full_gap) & (msrc[:, GAP] != 0),
                    msrc[:, GAP]
                    * (doublegap * (wg - 1) + indel * (numseqs - wg)),
                    0,
                )
                shifted = int(
                    sc_lead.sum() + sc_body_c.sum() + sc_body_g.sum()
                ) - currentscore
                if shifted >= bestscore:
                    bestshift = dirsignal * sh
                    bestscore = shifted
                    found_dir_best = True
            if bestshift != 0 and bestshift * dirsignal > 0:
                best_maxposaffected = maxposaffected
                sh = bestshift * dirsignal
                nrem = minnextgaps - sh
                # moving_i has all minnextgaps trailing gaps peeled; the
                # reference re-adds the nrem still-remaining ones (:800-807)
                moving_best = moving_i.copy()
                for kk in range(ntoshift):
                    mpos = postonextgap[kk]
                    for t in range(nrem):
                        moving_best[mpos + t, GAP] += 1
                best_nposaffected = [postonextgap[kk] + sh for kk in range(ntoshift)]
                jarr = np.arange(maxposaffected)
                lead = jarr < sh
                bw = np.empty_like(staticsv)
                bw[lead] = staticsv[lead]
                bw[lead, GAP] += ntoshift
                src = np.clip(jarr - sh, 0, maxposaffected - 1)
                bw[~lead] = staticsv[~lead] + moving_best[src[~lead]]
                best_workingsv = bw
                bestdir = dirsignal
            if dirsignal == -1:
                break
            looplimit = 0
            dirsignal = -1
        if bestshift == 0:
            col += 1
            continue
        dirsignal = 1
        if bestshift < 0:
            dirsignal = -1
            bestshift = -bestshift
        # apply: counts
        cols_idx = col + dirsignal * np.arange(best_maxposaffected) - 1
        scorevector[cols_idx] = best_workingsv
        # apply: shift string chars (vectorized block move + gap fill)
        for kk, ii in enumerate(seqstoshift):
            s = strings[ii]
            np_aff = best_nposaffected[kk]
            if dirsignal > 0:
                src = s[col - 1 : col - 1 + np_aff - bestshift].copy()
                s[col - 1 + bestshift : col - 1 + np_aff] = src
                s[col - 1 : col - 1 + bestshift] = GAP
            else:
                src = s[col - np_aff + bestshift : col].copy()
                s[col - np_aff : col - bestshift] = src
                s[col - bestshift : col] = GAP
        # remove all-gap columns around col
        n_ = consize
        mrun = 0
        j = col
        while j <= n_ and scorevector[j - 1, GAP] == numseqs:
            mrun += 1
            j += 1
        krun = 0
        j = col - 1
        while j >= 1 and scorevector[j - 1, GAP] == numseqs:
            krun += 1
            j -= 1
        mtot = mrun + krun
        start = col - krun  # leftmost empty column (1-based)
        if mtot > 0:
            # shift left by mtot from start..n-mtot
            src_lo = start + mtot - 1  # 0-based source start
            dst_lo = start - 1
            length = n_ - mtot - start + 1
            if length > 0:
                scorevector[dst_lo : dst_lo + length] = scorevector[
                    src_lo : src_lo + length
                ]
                for ii in usableseqs[:numseqs]:
                    strings[ii][dst_lo : dst_lo + length] = strings[ii][
                        src_lo : src_lo + length
                    ]
            scorevector[n_ - mtot : n_] = 0
            consize = consize - mtot
        col = col - (krun + 1)
        col += 1  # reference: for-loop increment after `col=(col-(k+1))`
    return consize


class GapProgressiveState:
    """Step-wise host state of ONE gap's progressive merge sequence.

    Factors the ProgressiveDP loop (dynamicprogramming.c:906-1171) into
    ``prepare() -> fill inputs`` / ``apply(maps) -> merge + DGC`` steps
    so independent gaps can run their i-th merges as one batched device
    launch (:func:`progressive_dp_batched`) while the single-gap path
    (:func:`progressive_dp`) drives the exact same transitions.
    """

    def __init__(self, gap_codes: List[np.ndarray]):
        k = len(gap_codes)
        self.k = k
        self.gap_codes = gap_codes
        gaplens = np.array([len(g) for g in gap_codes], dtype=np.int64)
        self.ordered, self.lens = sort_sequences_for_dp(gaplens)
        self.strings: List[Optional[np.ndarray]] = [None] * k
        self.consensussize = self.lens[0]
        n0 = self.ordered[0]
        self.scorevector = np.zeros((self.consensussize, 5), dtype=np.int64)
        cur = np.asarray(gap_codes[n0], dtype=np.int8)
        self.strings[n0] = cur.copy()
        if self.consensussize:
            np.add.at(
                self.scorevector,
                (np.arange(self.consensussize), cur.astype(np.int64)),
                1,
            )
        # emulated DP-matrix allocation state: the reference reallocates
        # (and re-initializes the dp boundaries) only when the column
        # count changed or the row count grew
        # (dynamicprogramming.c:957-987); otherwise the boundary
        # row/column keep the allocating merge's values
        self.prev_consensussize = 0
        self.prev_nrows = 0
        self.alloc_top: Optional[np.ndarray] = None
        self.alloc_rowgap = 0
        self.i = 1

    def _skip_trivial(self):
        while self.i < self.k and self.lens[self.i] == 0:
            n = self.ordered[self.i]
            self.strings[n] = np.full(self.consensussize, GAP, dtype=np.int8)
            self.i += 1

    def prepare(self):
        """Fill inputs of the next merge, or None when all merges done.

        Returns (row_codes, scorevector view, i, top_row view,
        edge_rowgap); mutates the emulated allocation state, so call it
        exactly once per merge.
        """
        self._skip_trivial()
        if self.i >= self.k:
            return None
        i = self.i
        ncols = self.consensussize
        nrows = self.lens[i]
        if ncols != self.prev_consensussize or nrows > self.prev_nrows:
            self.alloc_rowgap = config.run_config().scoring.indel * i
            self.alloc_top = default_top_row(self.scorevector[:ncols], i)
            self.prev_nrows = nrows
        row_codes = np.asarray(self.gap_codes[self.ordered[i]], dtype=np.int64)
        return (
            row_codes,
            self.scorevector[:ncols],
            i,
            self.alloc_top[: ncols + 1],
            self.alloc_rowgap,
        )

    def apply(self, old_cols: np.ndarray, rows: np.ndarray):
        """Merge the prepared sequence via alignment maps, then DGC."""
        i = self.i
        ncols = self.consensussize
        n = self.ordered[i]
        row_codes = np.asarray(self.gap_codes[n], dtype=np.int64)
        strings_l = [None if s is None else s[:ncols] for s in self.strings]
        with PROFILER.phase("align.dp_merge"):
            new_strings, new_sv, consensussize = _merge_from_maps(
                old_cols, rows, row_codes, strings_l,
                self.scorevector[:ncols], self.ordered, i, n,
            )
        self.prev_consensussize = ncols
        self.strings = new_strings
        self.scorevector = new_sv
        self.consensussize = consensussize
        if i > 1:
            with PROFILER.phase("align.dgc"):
                self.consensussize = delete_gapped_columns(
                    self.ordered, self.strings, i + 1, self.scorevector,
                    self.consensussize, (i + 1) // 2,
                )
        self.i += 1

    def results(self) -> List[np.ndarray]:
        self._skip_trivial()
        cs = self.consensussize
        return [
            (s[:cs] if s is not None else np.full(cs, GAP, dtype=np.int8))
            for s in self.strings
        ]

# packed direction bytes one batched launch may hold (80 GB card; a
# Set3 ~17k x 28k merge needs ~0.12 GB in the kernel's tiled layout)
BATCH_DIRS_BYTES = 8 << 30
# with a mesh: the JAX package's cap on a padded batch (Gp x (R + 512) x
# (C + 512) direction bytes, csa_tpu/align/progressive.py:583), which
# peels off the giants that go to the column-sharded seqpar path
BATCH_DIRS_CAP = 1 << 30
# a round's batch smaller than this runs merge by merge, each merge
# through the per-merge gate (csa_tpu/align/progressive.py:752, :834)
MIN_BATCH = 2


def _fill_to_maps(prep, device=None, sc=None):
    """Run one prepared fill; returns (old_cols, rows) maps.  With a
    ``device`` (the card may take it) a merge of the installed
    ``device_min_cells`` or more is one launch there, scored by ``sc``;
    every other fill takes the native host fill, or the numpy twin when
    the library is missing (csa_tpu/align/progressive.py:692-716)."""
    row_codes, sv, i, top, erg = prep
    nrows, ncols = len(row_codes), len(sv)
    PROFILER.add("dp_cells", nrows * ncols)
    if (device is not None and nrows and ncols
            and nrows * ncols >= config.run_config().device_min_cells):
        PROFILER.add("dp_device_dispatches", 1)
        PROFILER.add("dp_device_cells", nrows * ncols)
        with PROFILER.phase("align.dp_fill"):
            path = profile.profile_path(row_codes, sv, i, top_row=top,
                                        edge_rowgap=erg, device=device, **sc)
        return _path_to_maps(path)
    if nrows and ncols:
        with PROFILER.phase("align.dp_fill"):
            res = native.dp_fill_path(row_codes, sv, i, top, erg)
        if res is not None:
            return _path_to_maps(res[1])
    with PROFILER.phase("align.dp_fill"):
        _, dirs = dp_fill(row_codes, sv, i, top_row=top, edge_rowgap=erg)
    return _dirs_to_maps(dirs, nrows, ncols)


def progressive_dp(gap_codes: List[np.ndarray]) -> List[np.ndarray]:
    """Align one gap's substrings on the host (the ``native`` and
    ``numpy`` routes); returns code strings.  Mirrors ProgressiveDP
    (dynamicprogramming.c:906-1171): shortest-first ordering, NW against
    the profile, backtrack merge, DeleteGappedColumns after each merge
    from the third sequence on.  The output is the batched device
    route's."""
    st = GapProgressiveState(gap_codes)
    while True:
        prep = st.prepare()  # once per merge: it advances the state
        if prep is None:
            break
        st.apply(*_fill_to_maps(prep))
    return st.results()


def _partition(dev: list):
    """Smallest-first batch under BATCH_DIRS_BYTES; the rest are giants
    that run as single launches."""
    dev.sort(key=lambda ip: len(ip[1][0]) * len(ip[1][1]))
    batch = []
    used = 0
    for item in dev:
        need = profile.dirs_bytes(len(item[1][0]), len(item[1][1]))
        if used + need > BATCH_DIRS_BYTES and batch:
            break
        batch.append(item)
        used += need
    return batch, dev[len(batch):]


def _partition_mesh(dev: list):
    """The JAX package's partition under a mesh
    (csa_tpu/align/progressive.py:783-796): grow the batch smallest-first
    while its padded size stays under BATCH_DIRS_CAP; the rest are
    giants."""
    dev.sort(key=lambda ip: len(ip[1][0]) * len(ip[1][1]))
    batch = []
    rmax = cmax = 0
    for item in dev:
        r = max(rmax, len(item[1][0]))
        c = max(cmax, len(item[1][1]))
        gp = max(8, 1 << len(batch).bit_length())
        if gp * (r + 512) * (c + 512) > BATCH_DIRS_CAP and batch:
            break
        batch.append(item)
        rmax, cmax = r, c
    return batch, dev[len(batch):]


def _giant_to_maps(p, mesh, sc: dict):
    """One giant merge, column-sharded over the ranks that this process
    drives of the mesh (every process runs it and finds the same
    path)."""
    PROFILER.add("dp_cells", len(p[0]) * len(p[1]))
    PROFILER.add("dp_device_dispatches", 1)
    PROFILER.add("dp_device_cells", len(p[0]) * len(p[1]))
    with PROFILER.phase("align.dp_fill"):
        path = seqpar.dp_path_seqpar(p[0], p[1], p[2], mesh,
                                     top_row=p[3], edge_rowgap=p[4], **sc)
    return _path_to_maps(path)


def progressive_dp_batched(gaps: List[List[np.ndarray]], *, device,
                           mesh=None, min_batch: int = MIN_BATCH
                           ) -> List[List[np.ndarray]]:
    """Align many independent gaps, batching the i-th merge of every gap
    into one launch (alignment.c:179-208).  Output is identical to the
    per-gap progressive DP.

    Without a mesh a round's batch is one launch on ``device`` (giants
    above BATCH_DIRS_BYTES go alone, through the per-merge gate), unless
    its cells stay below the installed ``batch_min_cells``: then the
    whole round runs on the host.  With a mesh
    (:mod:`csa_tpu_torch.parallel.sharded`) the round is split as the
    JAX package splits it: giants go column-sharded to
    :func:`..dp.seqpar.dp_path_seqpar` and a batch is split over the
    ranks (:func:`..dp.profile.profile_paths_sharded`).  Either way a
    batch of fewer than ``min_batch`` merges runs merge by merge through
    the per-merge gate (``device_min_cells``), on ``device`` or the home
    rank's.  On a mesh across processes every process runs every round:
    each giant over its own ranks, each batch split over the ranks of
    every process and gathered whole to every process, the rest on its
    own first rank or its host, so the host states stay equal and every
    process issues the same exchanges.  Every fill scores with the
    installed RunConfig's scoring."""
    cfg = config.run_config()
    sc = asdict(cfg.scoring)
    if mesh is not None:
        device = mesh.home
    states = [GapProgressiveState(g) for g in gaps]
    while True:
        preps = []
        for idx, st in enumerate(states):
            p = st.prepare()  # once per merge: it advances the state
            if p is not None:
                preps.append((idx, p))
        if not preps:
            break
        dev = [(idx, p) for idx, p in preps if len(p[0]) and len(p[1])]
        host = [(idx, p) for idx, p in preps
                if not (len(p[0]) and len(p[1]))]
        if mesh is None:
            batch, giants = _partition(dev)
            for idx, p in giants:
                states[idx].apply(*_fill_to_maps(p, device, sc))
            cells = sum(len(p[0]) * len(p[1]) for _, p in batch)
            if batch and cells < cfg.batch_min_cells:
                host = batch + host
                batch = []
        else:
            batch, giants = _partition_mesh(dev)
            for idx, p in giants:
                states[idx].apply(*_giant_to_maps(p, mesh, sc))
        if len(batch) >= min_batch:
            for (idx, _), path in zip(batch, _batch_paths(batch, device,
                                                          mesh, sc)):
                states[idx].apply(*_path_to_maps(path))
        else:
            for idx, p in batch:
                states[idx].apply(*_fill_to_maps(p, device, sc))
        for idx, p in host:
            states[idx].apply(*_fill_to_maps(p))
    return [st.results() for st in states]


def _batch_paths(batch, device, mesh, sc: dict):
    """One round's batch as one launch on ``device``, or split over the
    ranks of ``mesh`` (csa_tpu/align/progressive.py:824-832)."""
    cells = sum(len(p[0]) * len(p[1]) for _, p in batch)
    PROFILER.add("dp_cells", cells)
    PROFILER.add("dp_device_dispatches", 1)
    PROFILER.add("dp_device_cells", cells)
    items = [p for _, p in batch]
    with PROFILER.phase("align.dp_fill"):
        if mesh is None:
            paths = profile.profile_paths(items, device, **sc)
            sync(device)
        else:
            paths = profile.profile_paths_sharded(items, relabel(mesh, "gap"),
                                                  **sc)
            for r in mesh.local:
                sync(mesh.devices[r])
    return paths
