"""Progressive profile DP over inter-anchor gaps, frozen from the port's
host code (shortest-first order, emulated DP allocation with its stale
boundaries, merge, DeleteGappedColumns), with the fill as the row-by-row
closed form of the port's plain version (``dp/profile.py``
``profile_paths_plain``) written in numpy for one gap, and its walk.

The reference's rules (``source/dynamicprogramming.c``): recurrence
:993-998 with tie-break diag >= left >= up :1014-1026, backtrack
:1032-1138, DeleteGappedColumns :643-899.  ``tie_up=True`` is the
benchmark's control: up wins a tie with diag, which breaks the tie-break
the configuration states.

Char codes: A=0 C=1 G=2 T=3 gap=4.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

MATCH = 1
DOUBLEGAP = 0
MISMATCH = -1
INDEL = -1
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
    sv_gap = scorevector[:, GAP]
    colgap = DOUBLEGAP * sv_gap + INDEL * (i - sv_gap)
    return np.concatenate([[np.int64(0)], np.cumsum(colgap)])


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

    """
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
                    MATCH * (sc - 1)
                    + MISMATCH
                    * (numseqs - (sc + sv_win[:, GAP][:, None]))
                    + INDEL * sv_win[:, GAP][:, None]
                ),
                0,
            ).sum()
            mg = movingsv[:, GAP]
            colscore += np.where(
                mg != 0,
                mg
                * (
                    DOUBLEGAP * (sv_win[:, GAP] - 1)
                    + INDEL * (numseqs - sv_win[:, GAP])
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
                    * (DOUBLEGAP * (wg - 1) + INDEL * (numseqs - wg)),
                    0,
                )
                msrc = moving_i[src]
                sc_body_c = np.where(
                    (~lead & ~full_gap)[:, None] & (msrc[:, :4] != 0),
                    msrc[:, :4]
                    * (
                        MATCH * (wsc - 1)
                        + MISMATCH * (numseqs - (wsc + wg[:, None]))
                        + INDEL * wg[:, None]
                    ),
                    0,
                ).sum(axis=1)
                sc_body_g = np.where(
                    (~lead & ~full_gap) & (msrc[:, GAP] != 0),
                    msrc[:, GAP]
                    * (DOUBLEGAP * (wg - 1) + INDEL * (numseqs - wg)),
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
    (:func:`progressive_dp` drives it one merge at a time).
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
            self.alloc_rowgap = INDEL * i
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
        new_strings, new_sv, consensussize = _merge_from_maps(
            old_cols, rows, row_codes, strings_l,
            self.scorevector[:ncols], self.ordered, i, n,
        )
        self.prev_consensussize = ncols
        self.strings = new_strings
        self.scorevector = new_sv
        self.consensussize = consensussize
        if i > 1:
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


def fill_path(row_codes: np.ndarray, scorevector: np.ndarray, i: int,
              top_row: np.ndarray, edge_rowgap: int, *,
              tie_up: bool = False) -> np.ndarray:
    """Fill one gap row by row and walk it back; returns the walk-order
    path codes (D_DIAG 0, D_LEFT 1, D_UP 2) from (R, C) to (0, 0).

    A row's left-gap chain is a running max: with S the prefix sums of
    the left-move costs, dp[j][c] = S[c] + max(dp[j][0], max over c' <= c
    of (best of diag and up at c') - S[c'])."""
    R, C = len(row_codes), len(scorevector)
    sv = np.asarray(scorevector, dtype=np.int64)
    svg = sv[:, GAP]
    rest = (INDEL - MISMATCH) * svg + MISMATCH * i
    # score of row code b at each column; code 4 counts nothing
    colsub = np.concatenate(
        [(MATCH - MISMATCH) * sv[:, :4] + rest[:, None], rest[:, None]],
        axis=1).T.copy()  # (5, C)
    cg = DOUBLEGAP * svg + INDEL * (i - svg)
    rowgap = INDEL * i
    S = np.concatenate([[0], np.cumsum(cg)]).astype(np.int64)
    codes = np.clip(np.asarray(row_codes, dtype=np.int64), 0, 4)
    prev = np.asarray(top_row, dtype=np.int64)[: C + 1].copy()
    dirs = np.empty((R, C + 1), dtype=np.int8)
    dirs[:, 0] = D_UP
    head = np.empty(C + 1, dtype=np.int64)
    for j in range(1, R + 1):
        diag = prev[:-1] + colsub[codes[j - 1]]
        up = prev[1:] + rowgap
        dwin = diag > up if tie_up else diag >= up
        m1 = np.where(dwin, diag, up)
        head[0] = j * edge_rowgap
        np.subtract(m1, S[1:], out=head[1:])
        cur = np.maximum.accumulate(head) + S
        left = cur[:-1] + cg
        take_left = (left > m1) | ((left == m1) & ~dwin)
        dirs[j - 1, 1:] = np.where(take_left, D_LEFT,
                                   np.where(dwin, D_DIAG, D_UP))
        prev = cur
    out = []
    j, c = R, C
    while j > 0 and c > 0:
        d = int(dirs[j - 1, c])
        out.append(d)
        if d != D_LEFT:
            j -= 1
        if d != D_UP:
            c -= 1
    out.extend([D_UP] * j)
    out.extend([D_LEFT] * c)
    return np.asarray(out, dtype=np.int8)


def progressive_dp(gap_codes: List[np.ndarray], *,
                   tie_up: bool = False) -> List[np.ndarray]:
    """Align one gap's substrings (ProgressiveDP,
    dynamicprogramming.c:906-1171); returns code strings."""
    st = GapProgressiveState(gap_codes)
    while True:
        prep = st.prepare()  # once per merge: it advances the state
        if prep is None:
            break
        row_codes, sv, i, top, erg = prep
        if len(row_codes) and len(sv):
            maps = _path_to_maps(fill_path(row_codes, sv, i, top, erg,
                                           tie_up=tie_up))
        else:
            maps = _path_to_maps(np.asarray(
                [D_UP] * len(row_codes) + [D_LEFT] * len(sv), np.int8))
        st.apply(*maps)
    return st.results()
