#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (csa_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each on stdout:
  1. toolchain: torch, CUDA, nvcc, triton, the card (nvidia-smi), and the
                port's native host library, which must build;
  2. build:     every kernel from csa_tpu_torch/csrc with nvcc (sm_90a),
                one nvcc per source, all started together;
  3. mscan:     kernel against its plain version, every option of the
                max and the min scan, at the collect cascade's shapes
                (Primates, 8 x 1 Mbp, 4 x 5 Mbp: 12 x 20,000,768 and
                the 4 coverage channels), on i.i.d. values, the cascade's
                own channels and drifting walks, with torch.cummax /
                torch.cummin timed beside it; then the kernel alone,
                with and without the reduction over channels, at 1 to
                12 channels of 8,003,584;
  4. profile:   the profile-DP kernel's paths against the plain version's,
                exact (ragged stale batch, non-default scoring, i = 64, R
                or C = 1, tile multiples and +-1, a gap below one tile, a
                giant among tiny gaps, stale + scoring (2, -3, -2, -1) +
                i = 64, C = 30,000, two launches on two streams); 8 x
                8192^2 and Set3's largest giant timed on the device (fill
                and walk apart, other tile shapes beside) with the tiles,
                the grid and the serial floor;
  5. nw:        the NW kernel's scores against the plain version's, exact:
                the Primates and Set3 oracle batches (135 x 17,408^2 and
                162 x 20,480^2, both timed beside their bounds), ragged
                and edge shapes, 1 to 88 row bands, more tickets than
                the card holds workers; and 4 pairs against the native
                host library;
  6. pipeline:  the port's CLI, full pipeline, on Primates and Set3, with
                rotated and aligned output against the fixtures, the
                integrity check and the kernels' launch counts (zeroed
                just before, read just after); the native host engine's
                CLI on the same sets, as a separate process;
  7. verify:    the port's CLI, R --verify-rotations, on Primates and
                Set3: rotated output against the fixtures, the printed
                oracle lines and the margins against the plain version's
                on the card from the same batch, and the NW kernel's
                launch count (zeroed just before, read just after);
  8. mbp:       rotation mode on 8 x 1 Mbp (seed 7): the port's CLI
                against the native host engine's CLI on the same machine;
  9. mbp_full:  the full pipeline on 8 x 1 Mbp (seed 7) through the port's
                CLI on the default route with --profile: -Rotated.fasta and
                -Aligned.fasta against csa_tpu's sha256 (MBP_FULL_SHA256),
                the integrity check, mscan's launches (zeroed just before,
                read just after), the stage table, the gap-DP counters and
                the card's peak memory;
 10. mbp5:      rotation mode on 4 x 5 Mbp (seed 13) through the port's CLI
                on the default route, then analyze once warm: rotations,
                cascade counts and -Rotated.fasta against csa_tpu's
                (MBP5_*), mscan's launches, both walls and the card's peak
                memory;
 11. routing:   the crossovers behind the port's routing defaults: a
                merge that goes alone (the native host fill and walk
                against one profile_path launch with its upload and the
                path's download; squares 64^2 to 8192^2, skewed shapes,
                and every merge of Primates' and Set3's rounds, each
                pair of paths equal), a round (the host fills in turn
                against one batched launch; Primates' and Set3's rounds
                and synthetic rounds below them) and the rotation route
                of `auto` (fresh-process R walls, --backend native
                against device, one run each, on
                4 x 16 kbp, 8 x 50 kbp, Primates, Set3 and 8 x 500 kbp,
                with phase mbp's 8 x 1 Mbp walls); each crossover the
                measured size that minimises the summed time, the
                defaults beside them; then the CLI in mode N on Primates
                and Set3 with --backend native (no kernel launched) and
                auto (no profile-DP launch), against the fixtures with
                the integrity check, auto on Primates with its threshold
                at 0 (mscan launched, no profile DP), and --backend numpy
                on one tiny fixture;
 12. band:      the band kernel (one band of the column-sharded DP, on
                the profile DP's tile engine) against its plain version,
                exact in both direction bits of every cell, the bottom
                row and the right edge: rank-0 edge and halo bands, stale
                tops, Rb = 1 / Cloc = 1, Rb not a multiple of 4,
                non-default scoring, i = 64, Set3's band shapes at 8 and
                2 ranks and Cloc = 30,000; each timed beside its bound,
                the design's floor (its tile anti-diagonals at the
                profile phase's step time) and the batch fill of the
                same tile graph;
 13. seqpar:    dp_path_seqpar on the largest giants of Set3 (16,979 x
                20,852) and Primates (5,307 x 5,945), stale top rows, at
                2, 4 and 8 ranks on the one card, against the profile
                kernel's path and the native host library's, and the walk
                kernel against its host walk; the fill host-timed and its
                supersteps' device span (CUDA events around every band);
 14. sharded:   the port's CLI with --backend sharded --mesh 8x1 on
                Primates and Set3: output against the fixtures, the
                rotation sharded too (its profile holds
                rot.block_stage[sharded] and idx.replicate), the seqpar
                dispatches, the walls of the giants and of the rank-split
                batches inside align.dp_fill, and the band and profile
                kernels' launch counts (zeroed just before, read just
                after);
 15. sharded_rotation: the 8 x 1 Mbp set in mode R over ranks of the one
                card: analyze(mesh=...) at 1, 2, 4 and 8 ranks and the
                CLI at --backend sharded --mesh 8x1, each twice, their
                rotations against the native engine's and the
                single-device port's, the two runs of a mesh against each
                other, and mscan's launches (at least three a rank, zeroed
                just before each run, read just after); then
                parallel.scaling.measure on the same set (walls and stage
                walls at each rank count, the exchange bytes, the sharded
                argsort, the sharded alignment, Set3's giant at 8 ranks);
                and Primates at --mesh 3x1 (the single-device stage on the
                mesh's first rank), twice, against the fixture.
 16. distributed: the multi-process launch.  The dryrun (2 processes x
                4 ranks on the card, over gloo: the ladder, the final
                blocks and the rank-split gap DP against one process);
                the CLI in mode N on Primates and Set3 at --mesh 8x1 as
                2 processes sharing the card (gloo) and as one process,
                each process in a directory of its own: every process's
                output against the fixtures, its launches of mscan,
                profile_dp and band (zeroed just before its cli.main,
                read just after) and its wall.  With 2 or more cards the
                same over NCCL, a card a process (2 and, with 4 cards, 4
                processes); on one card a line says that leg was not run.
                The one-card legs run on card 0 on any machine.  Then the
                teardown loop: 12 two-process worlds on card 0 over gloo,
                3 to a pair of processes, each running every Ranks
                exchange on CUDA ranks against one process and ending
                with shutdown(); every process must exit 0 and no world
                may abort (with 2 or more cards, 4 worlds over NCCL too);
 17. fused:     the fused routes (the block stage and the anchors'
                linear sort, one CUDA graph replay and one download a
                call, below FUSED_MAX_CHARS): Primates and Set3 through
                the CLI in mode N with the gate forced open (twice: the
                second run must replay only, 3 mscan launches) and shut,
                every file against the fixtures; the staged and fused
                walls of rotation_final and linear_suffix_order on
                4 x 16 kbp, Primates, Set3 and 8 x 50 / 200 / 500 kbp,
                each pair equal: a key's first call (no graph, no cached
                guess: what a CLI job pays) and warm calls (replays);
                the gate the first calls give (crossover) and the one
                the warm calls would; the graphs' memory; a
                torch.profiler trace of each block stage on Primates and
                Set3 (launches, idle share, gaps, the heaviest kernels).
Then the card's name and power limit, one short summary line a kernel
shape, one of the sharded rotation's walls, one of the distributed
phase, one of the routing phase (its crossovers and the card) and one
of the fused phase (its gate, walls, memory and traces), two of the
Mbp phases (stage table, walls, card memory), so
that the end of the output keeps every row, a JSON line with one entry
per kernel (its time, the plain version's, the bound, the library
call's), and the last line
{"ok": true, "device": {...}}.  Any failed phase
raises: the exit code is non-zero and the last line is not printed.
Without a CUDA device it exits 2 before printing anything.

This script imports neither JAX nor the JAX package; the native host
engine (``python -m csa_tpu.cli --backend native``) runs in its own
process, so its walls include the interpreter's start-up, printed once.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIX = ROOT / "tests" / "fixtures"

# H100 SXM peaks for the bounds (NVIDIA data sheet, 700 W): HBM bytes/s,
# and int32 operations/s as 132 SMs x 64 INT32 lanes x 1.98 GHz
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations a cell: the profile DP's three moves, three compares
# and four selects (value and direction code); NW's equality test,
# select, add and three-way max (csrc/nw.cu)
PROFILE_OPS_PER_CELL = 10
NW_OPS_PER_CELL = 4
# the largest giant merges of Set3 and Primates under the JAX package's
# mesh partition rule
SET3_GIANT = (16_979, 20_852)
PRIMATES_GIANT = (5_307, 5_945)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    int32 operations over the int32 rate."""
    tb, to = nbytes / MEM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    by CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernel: str):
    """Mean device milliseconds a call of the kernels whose name holds
    ``kernel``, from a torch.profiler trace of ``reps`` calls after one
    warm-up; None where the trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [getattr(ev, "device_time_total", None) or ev.cuda_time_total
          for ev in prof.key_averages() if kernel in ev.key]
    return sum(us) / reps / 1e3 if us else None


def wall_ms(fn):
    """(result, host milliseconds) of one call ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def in_dir(path):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def run_port_cli(cli, tmp: Path, argv):
    """(stdout text, wall seconds) of the port's CLI run in ``tmp``."""
    log = io.StringIO()
    with in_dir(tmp):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli.main(list(argv))
        wall = time.perf_counter() - t0
    check(rc == 0, f"port CLI {argv} returned {rc}")
    return log.getvalue(), wall


def run_python(tmp: Path, argv, timeout=900) -> float:
    """Wall seconds of ``python <argv>`` in ``tmp`` (the repo on its
    path); raises if it fails."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"python {' '.join(argv)} returned {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return wall


def native_cli(tmp: Path, argv) -> float:
    """Wall seconds of the native host engine's CLI (the JAX package's
    ``--backend native``, which imports no JAX) in its own process."""
    return run_python(tmp, ["-m", "csa_tpu.cli", *argv, "--backend",
                            "native"])


def copy_fixture(tmp: Path, name: str) -> None:
    (tmp / f"{name}.txt").write_bytes((FIX / f"{name}.txt").read_bytes())


def rotations_of(fio, path: Path):
    return [fio.parse_rotated_header(l[1:].strip())[1]
            for l in path.read_text().splitlines() if l.startswith(">")]


def phase_toolchain(kernels, native):
    import torch

    nvcc = kernels._find_nvcc()
    check(nvcc is not None, "nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    try:
        import triton

        triton_ver = triton.__version__
    except ImportError:
        triton_ver = None
    t0 = time.perf_counter()
    have_native = native.available()
    native_s = time.perf_counter() - t0
    emit({"phase": "toolchain", "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": ver[-1], "triton": triton_ver,
          "nvidia_smi": smi_line(),
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "native_host_library": have_native,
          "native_build_s": native_s})
    check(have_native, "the port's native host library did not build")


def phase_build(kernels):
    t0 = time.perf_counter()
    lib = kernels.build(force=True)
    kernels.load()
    emit({"phase": "build", "library": str(lib.relative_to(ROOT)),
          "sources": [str(p.relative_to(ROOT)) for p in kernels.sources()],
          "seconds": time.perf_counter() - t0})


def _mscan_input(torch, gen, kind, M, N, is_min, reverse):
    """An (M, N) int32 input on the card, made there, of the forms of
    tests/torch_mscan_inputs.py: the collect cascade's channels
    (where(mask, arange(N), -1) for the max scan, N for the min scan) and
    walks drifting in the scan's direction set records in every tile,
    where i.i.d. values leave almost every output equal to the carry."""
    if kind == "cascade":
        density = 0.5 ** (1 + torch.arange(M, device="cuda") % 10)
        mask = torch.rand((M, N), generator=gen, device="cuda") < density[
            :, None]
        idx = torch.arange(N, dtype=torch.int32, device="cuda")
        return torch.where(mask, idx, N if is_min else -1).to(torch.int32)
    sign = (-1 if is_min else 1) * (-1 if reverse else 1)
    steps = torch.randint(-2, 4, (M, N), generator=gen, device="cuda",
                          dtype=torch.int32) * sign
    start = torch.randint(-4096, 4096, (M, 1), generator=gen, device="cuda",
                          dtype=torch.int32)
    return (start + steps.cumsum(1, dtype=torch.int32)).to(torch.int32)


def phase_mscan(mscan, stats):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for n in (278_528, 8_003_584, MBP5_PADDED):
        for cummin in (False, True):
            for reverse in (False, True):
                for reduce in (False, True):
                    cases.append((12, n, cummin, reverse, reduce))
    # the coverage scans (k channels, the min over them) of both Mbp sets
    cases.append((8, 8_003_584, False, False, True))
    cases.append((MBP5_SET[1], MBP5_PADDED, False, False, True))
    worst = 0
    for M, N, cummin, reverse, reduce in cases:
        x = torch.randint(-(2**30), 2**30, (M, N), generator=gen,
                          device="cuda", dtype=torch.int32)
        if cummin:
            kern = lambda: mscan.multi_cummin(  # noqa: E731
                x, reverse=reverse, max_over_channels=reduce)
            plain = lambda: mscan.multi_cummin_plain(  # noqa: E731
                x, reverse=reverse, max_over_channels=reduce)
            lib = lambda: torch.cummin(x, 1).values  # noqa: E731
        else:
            kern = lambda: mscan.multi_cummax(  # noqa: E731
                x, reverse=reverse, min_over_channels=reduce)
            plain = lambda: mscan.multi_cummax_plain(  # noqa: E731
                x, reverse=reverse, min_over_channels=reduce)
            lib = lambda: torch.cummax(x, 1).values  # noqa: E731
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, want),
              f"mscan differs M={M} N={N} cummin={cummin} "
              f"reverse={reverse} reduce={reduce}")
        ms, pms = cuda_ms(kern, 5), cuda_ms(plain, 5)
        # one library call computes the function only for a forward scan
        # that keeps every channel
        lms = None if reverse or reduce else cuda_ms(lib, 5)
        out_elems = N if reduce else M * N
        bms, by = bound(4 * (M * N + out_elems), M * N)
        line = {"phase": "mscan", "M": M, "N": N, "cummin": cummin,
                "reverse": reverse, "reduce": reduce,
                "equal_on": ["uniform", "cascade", "walk"],
                "ms": ms, "plain_ms": pms, "library_ms": lms,
                "bound_ms": bms, "bound_by": by}
        if (M, cummin, reverse, reduce) == (12, False, False, False):
            # the kernel alone on the card, without the wrapper's host time
            rec = dict(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                       bound_by=by,
                       device_ms=device_ms(kern, 20, "mscan_kernel"))
            if N == 278_528:
                stats["mscan"].update(rec)
            else:
                stats["mscan"][f"at_12x{N}"] = rec
        if (M, N, cummin, reverse, reduce) == (12, 8_003_584, True, False,
                                                False):
            stats["mscan"]["at_12x8003584"]["cummin"] = dict(
                ms=ms, plain_ms=pms, library_ms=lms)
        # the kernel and the plain version read x when called
        for kind in ("cascade", "walk"):  # records in every tile
            x = _mscan_input(torch, gen, kind, M, N, cummin, reverse)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err)
            check(torch.equal(got, want),
                  f"mscan differs on {kind} input M={M} N={N} "
                  f"cummin={cummin} reverse={reverse} reduce={reduce}")
        emit(line)
    stats["mscan"]["max_abs_err"] = worst
    # the reduction over channels against the channel count, on one N:
    # the kernel alone (torch.profiler), reduced and not
    N = 8_003_584
    sweep = []
    for M in (1, 2, 4, 8, 12):
        x = torch.randint(-(2**30), 2**30, (M, N), generator=gen,
                          device="cuda", dtype=torch.int32)
        red = device_ms(lambda: mscan.multi_cummax(  # noqa: E731
            x, min_over_channels=True), 20, "mscan_kernel")
        full = device_ms(lambda: mscan.multi_cummax(x), 20,  # noqa: E731
                         "mscan_kernel")
        sweep.append({"M": M, "reduce_device_ms": red,
                      "reduce_bound_ms": bound(4 * (M + 1) * N, M * N)[0],
                      "scan_device_ms": full,
                      "scan_bound_ms": bound(8 * M * N, M * N)[0]})
    emit({"phase": "mscan_reduce_sweep", "N": N, "rows": sweep})


def _profile_items(np, rng, shapes, i_of, stale, sc):
    from csa_tpu_torch.dp import profile

    items = []
    for R, C in shapes:
        i = i_of(rng)
        codes = rng.integers(0, 4, size=R).astype(np.int64)
        sv = rng.integers(0, min(i, 64) + 1, size=(C, 5)).astype(np.int64)
        if stale:
            top = rng.integers(-60, 10, size=C + 1).astype(np.int64)
            erg = int(rng.integers(-20, 0))
        else:
            top = profile.default_top_row(sv, i, indel=sc.get("indel", -1),
                                          doublegap=sc.get("doublegap", 0))
            erg = sc.get("indel", -1) * i
        items.append((codes, sv, i, top, erg))
    return items


def _profile_timed(np, profile, items, sc):
    """Device milliseconds (CUDA events) of one uploaded batch: fill and
    walk apart, and the two together as a launch makes them."""
    b = profile._upload(items, "cuda", **sc)
    rr = np.array([len(it[0]) for it in items])
    cc = np.array([len(it[1]) for it in items])
    grids = [profile.tile_grid(int(r), int(c)) for r, c in zip(rr, cc)]
    return {"strip": b["strip"], "tile_rows": 32 * b["strip"],
            "tile_cols": b["tile_cols"], "tiles": b["T"],
            "grid_blocks": b["workers"], "block_threads": 32,
            "tile_diagonals": max(a + c - 1 for a, c in grids),
            "fill_ms": cuda_ms(lambda: profile._launch_fill(b), 5),
            "walk_ms": cuda_ms(lambda: profile._launch_walk(b), 5),
            "ms": cuda_ms(lambda: profile._launch(b), 5)}


def _profile_variants(np, profile, items, sc):
    """The same batch under other tile shapes and worker counts."""
    keep = (profile.STRIP, profile.TILE_COLS, profile.WORKERS_PER_SM)
    out = []
    try:
        for strip, cols, per_sm in [(8, 256, 4), (16, 256, 4), (8, 512, 4),
                                    (16, 512, 4), (8, 128, 4), (8, 256, 2),
                                    (8, 256, 8), (8, 256, 4)]:
            profile.STRIP, profile.TILE_COLS = strip, cols
            profile.WORKERS_PER_SM = per_sm
            t = _profile_timed(np, profile, items, sc)
            out.append({"workers_per_sm": per_sm, **{k: t[k] for k in (
                "tile_rows", "tile_cols", "tiles", "grid_blocks", "fill_ms",
                "walk_ms")}})
    finally:
        profile.STRIP, profile.TILE_COLS, profile.WORKERS_PER_SM = keep
    return out


def phase_profile(profile, kernels, stats):
    import numpy as np

    from csa_tpu_torch.parallel.sharded import make_mesh

    rng = np.random.default_rng(5)
    rand = lambda lo, hi, g: [  # noqa: E731
        (int(rng.integers(lo, hi)), int(rng.integers(lo, hi)))
        for _ in range(g)]
    i16 = lambda r: int(r.integers(1, 17))  # noqa: E731
    i64 = lambda r: 64  # noqa: E731
    nd = dict(match=3, mismatch=-2, indel=-4, doublegap=-1)
    nd2 = dict(match=2, mismatch=-3, indel=-2, doublegap=-1)
    Tr, Tc = profile.tile_rows(), profile.TILE_COLS
    # (name, shapes, i, stale boundaries, scoring, timed on the device)
    cases = [
        ("ragged_stale", rand(1, 3000, 16), i16, True, {}, False),
        ("non_default_scoring", rand(500, 2500, 4), i16, False, nd, False),
        ("i64", rand(500, 2000, 4), i64, False, {}, False),
        ("thin", [(1, 5000), (5000, 1), (1, 1)], i16, False, {}, False),
        ("tile_edges", [(Tr, Tc), (Tr + 1, Tc + 1), (Tr - 1, Tc - 1),
                        (2 * Tr, 3 * Tc), (2 * Tr + 1, 3 * Tc - 1),
                        (2 * Tr - 1, 3 * Tc + 1)], i16, True, {}, False),
        ("below_one_tile", [(Tr // 7, Tc // 3)], i16, True, {}, False),
        ("giant_among_tiny", rand(1, 20, 20) + [(6000, 9000)]
         + rand(1, 20, 20), i16, True, {}, False),
        ("stale_scoring_i64", rand(500, 2500, 4), i64, True, nd2, False),
        ("wide_30000", [(2000, 30_000)], i16, True, {}, False),
        ("serial_tile_row", [(Tr, 32_768)], i16, False, {}, True),
        ("batch_8x8192", [(8192, 8192)] * 8, i16, False, {}, True),
        ("set3_giant", [SET3_GIANT], i16, True, {}, True),
    ]
    worst = 0
    step_us = None
    for name, shapes, i_of, stale, sc, timed in cases:
        items = _profile_items(np, rng, shapes, i_of, stale, sc)
        cells = sum(R * C for R, C in shapes)
        profile.profile_paths(items, "cuda", **sc)  # warm-up
        want, pms = wall_ms(lambda: profile.profile_paths_plain(
            items, "cuda", **sc))
        got, wall = wall_ms(lambda: profile.profile_paths(
            items, "cuda", **sc))
        for a, b in zip(got, want):
            check(len(a) == len(b) and np.array_equal(a, b),
                  f"profile paths differ in case {name}")
            worst = max(worst, int(np.abs(a.astype(int) - b).max(initial=0)))
        # codes (1 B), score vector (5 x 4 B), top row (4 B) in, path out
        nbytes = sum(R + 24 * C + 4 + (R + C) for R, C in shapes)
        bms, by = bound(nbytes, PROFILE_OPS_PER_CELL * cells)
        rec = {"phase": "profile", "case": name, "gaps": len(items),
               "cells": cells, "equal": True, "wall_ms": wall,
               "plain_ms": pms, "bound_ms": bms, "bound_by": by}
        if timed:
            rec.update(_profile_timed(np, profile, items, sc))
            rec["fill_gcell_per_s"] = cells / rec["fill_ms"] / 1e6
            if name == "serial_tile_row":
                # one tile row: the tiles run one after the other, so the
                # fill's time over its steps is the time of one step
                step_us = rec["fill_ms"] * 1e3 / (
                    rec["tiles"] * (Tc + 31))
                rec["step_us"] = step_us
                stats["profile_dp"]["step_us"] = step_us
            else:
                rec["variants"] = _profile_variants(np, profile, items, sc)
            # the serial floor of this design: the tile anti-diagonals
            # one after the other, Tc + 31 steps each
            rec["serial_floor_ms"] = (rec["tile_diagonals"] * (Tc + 31)
                                      * step_us / 1e3)
        emit(rec)
        if name == "batch_8x8192":
            stats["profile_dp"].update(
                ms=rec["ms"], plain_ms=pms, library_ms=None, bound_ms=bms,
                bound_by=by, wall_ms=wall, fill_ms=rec["fill_ms"],
                walk_ms=rec["walk_ms"],
                serial_floor_ms=rec["serial_floor_ms"])
    # two launches at once on two streams of the one card (the sharded
    # path's shape), each exact
    items = _profile_items(np, rng, [(4096, 4096)] * 6 + rand(1, 3000, 6),
                           i16, True, {})
    mesh = make_mesh(2, devices=["cuda"])
    before = kernels.COUNTS["profile_dp"]
    got, wall = wall_ms(lambda: profile.profile_paths_sharded(items, mesh))
    check(kernels.COUNTS["profile_dp"] == before + 2,
          "profile_paths_sharded on 2 ranks did not launch twice")
    want = profile.profile_paths_plain(items, "cuda")
    for a, b in zip(got, want):
        check(len(a) == len(b) and np.array_equal(a, b),
              "profile paths differ in case two_streams")
    emit({"phase": "profile", "case": "two_streams", "gaps": len(items),
          "launches": 2, "equal": True, "wall_ms": wall})
    stats["profile_dp"]["max_abs_err"] = worst


def _oracle_batch(fio, verification, name):
    seqs = fio.load_fasta(str(FIX / f"{name}.txt"), log=io.StringIO())
    rotations = rotations_of(fio, FIX / f"{name}-Rotated.fasta")
    return verification.oracle_batch(seqs.encoded_all(), rotations)


def phase_nw(nw, fio, verification, stats):
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    rand = lambda B, la, lb: (  # noqa: E731
        rng.integers(0, 4, size=(B, la)), rng.integers(0, 4, size=(B, lb)))
    cases = [("primates_oracle", _oracle_batch(fio, verification,
                                               "Primates")),
             ("set3_oracle", _oracle_batch(fio, verification, "Set3"))]
    for name, shape in [("la_ne_lb", (3, 40, 55)), ("la_1", (2, 1, 7)),
                        ("lb_1", (2, 7, 1)), ("odd_lengths", (4, 131, 62)),
                        ("b_1", (1, 1000, 999)),
                        ("two_bands", (2, 600, 3001)),
                        ("ragged_bands", (2, 4097, 1777)),
                        ("bands_41", (2, 20_481, 300)),
                        ("bands_88", (1, 45_000, 64)),
                        ("tickets_above_grid", (4500, 600, 50))]:
        cases.append((name, rand(*shape)))
    worst = 0
    for name, (a_np, b_np) in cases:
        a = torch.from_numpy(np.ascontiguousarray(a_np)).to("cuda")
        b = torch.from_numpy(np.ascontiguousarray(b_np)).to("cuda")
        B, la = a.shape
        lb = b.shape[1]
        kern = lambda: nw.pairwise_nw_scores(a, b, "cuda")  # noqa: E731
        got = kern()
        want, pms = wall_ms(lambda: nw.pairwise_nw_scores_plain(
            a.to(torch.int32), b.to(torch.int32)))
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, want), f"nw scores differ in case {name}")
        ms = cuda_ms(kern, 3)
        cells = B * la * lb
        bms, by = bound(4 * (B * la + B * lb + B), NW_OPS_PER_CELL * cells)
        rec = {"phase": "nw", "case": name, "B": B, "la": la, "lb": lb,
               "S_h_nb": list(nw.plan(la)), "equal": True, "ms": ms,
               "plain_ms": pms, "gcell_per_s": cells / ms / 1e6,
               "bound_ms": bms, "bound_by": by}
        if name == "primates_oracle":
            host = nw.nw_scores_host(a_np[:4], b_np[:4])
            check(np.array_equal(host, got[:4].cpu().numpy()),
                  "nw scores differ from the native host library")
            rec["native_host_equal_first_4"] = True
            stats["nw"].update(ms=ms, plain_ms=pms, library_ms=None,
                               bound_ms=bms, bound_by=by)
        if name == "set3_oracle":
            stats["nw"]["set3_oracle"] = dict(
                B=B, la=la, lb=lb, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by)
        emit(rec)
    stats["nw"]["max_abs_err"] = worst


def _content_rows(path):
    return [l for l in Path(path).read_text().splitlines()
            if not l.startswith(">")]


def phase_pipeline(cli, kernels, tools_files):
    walls = {}
    kernels.reset_counts()
    for name in ("Primates", "Set3"):
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            copy_fixture(tmp, name)
            _, walls[name] = run_port_cli(cli, tmp, [f"{name}.txt"])
            rot = tmp / f"{name}-Rotated.fasta"
            aln = tmp / f"{name}-Aligned.fasta"
            check(rot.read_bytes() == (FIX / f"{name}-Rotated.fasta")
                  .read_bytes(), f"{name}: -Rotated.fasta differs")
            check(_content_rows(aln) == _content_rows(
                FIX / f"{name}-Rotated-Aligned.fasta"),
                f"{name}: aligned rows differ from the fixture")
            check(tools_files.test_alignment_output(
                str(rot), str(aln), log=io.StringIO()),
                f"{name}: integrity check failed")
    launches = dict(kernels.COUNTS)
    check(launches["mscan"] > 0 and launches["profile_dp"] > 0,
          f"a kernel of the main path was not launched: {launches}")
    native_walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # build the native host engine's library before timing it
        run_python(tmp, ["-c", "from csa_tpu import native\n"
                               "assert native.available()"])
        startup = run_python(tmp, ["-c", "pass"])
        for name in ("Primates", "Set3"):
            copy_fixture(tmp, name)
            native_walls[name] = native_cli(tmp, [f"{name}.txt"])
            check((tmp / f"{name}-Rotated.fasta").read_bytes()
                  == (FIX / f"{name}-Rotated.fasta").read_bytes(),
                  f"{name}: the native CLI's -Rotated.fasta differs")
    emit({"phase": "pipeline", "rotated_identical": True,
          "aligned_rows_identical": True, "integrity": True,
          "launches": launches, "port_wall_s": walls,
          "native_cli_wall_s": native_walls,
          "interpreter_startup_s": startup})
    return launches, walls


def _oracle_lines(text: str):
    return [l for l in text.splitlines()
            if l.startswith("> Verifying rotations")
            or l.startswith(">   WARNING sequence")]


def phase_verify(cli, kernels, nw, verification):
    import numpy as np
    import torch

    from csa_tpu_torch.utils import PROFILER

    captured = []
    real = verification.verify_rotations

    def spy(*args, **kw):
        res = real(*args, **kw)
        captured.append((args, kw, res))
        return res

    out = {}
    verification.verify_rotations = spy
    kernels.reset_counts()
    try:
        for name in ("Primates", "Set3"):
            with tempfile.TemporaryDirectory() as tmp:
                tmp = Path(tmp)
                copy_fixture(tmp, name)
                PROFILER.reset()
                text, wall = run_port_cli(
                    cli, tmp, ["R", f"{name}.txt", "--verify-rotations",
                               "--profile"])
                check((tmp / f"{name}-Rotated.fasta").read_bytes()
                      == (FIX / f"{name}-Rotated.fasta").read_bytes(),
                      f"{name}: -Rotated.fasta differs with the oracle on")
            phase_s = [float(l.split()[2].rstrip("s"))
                       for l in text.splitlines()
                       if l.startswith(">   rot.device_verify")]
            out[name] = {"lines": _oracle_lines(text), "wall_s": wall,
                         "rot.device_verify_s": phase_s[0]}
    finally:
        verification.verify_rotations = real
    launches = dict(kernels.COUNTS)
    check(launches["nw"] > 0, f"the NW kernel was not launched: {launches}")
    check(len(captured) == 2, "the oracle did not run once per set")
    for name, (args, kw, res) in zip(("Primates", "Set3"), captured):
        encoded, rotations = args
        a, b = verification.oracle_batch(encoded, rotations)
        scores = nw.pairwise_nw_scores_plain(
            torch.from_numpy(a).to("cuda"), torch.from_numpy(b).to("cuda"))
        log = io.StringIO()
        want = verification.report(scores.cpu().numpy(), len(encoded), 8, log)
        check(want.num_confirmed == res.num_confirmed
              and np.array_equal(want.margins, res.margins)
              and np.array_equal(want.chosen_scores, res.chosen_scores),
              f"{name}: oracle margins differ from the plain version's")
        check(out[name]["lines"] == log.getvalue().splitlines(),
              f"{name}: printed oracle lines differ from the plain version's")
        out[name].update(pairs=int(a.shape[0]), length=int(a.shape[1]),
                         confirmed=res.num_confirmed,
                         checked=res.num_checked,
                         margins=[int(m) for m in res.margins])
    emit({"phase": "verify", "launches": launches, "rotated_identical": True,
          "equal_to_plain": True, "sets": out})
    return launches


def _mbp_set(n=1_000_000, k=8, seed=7):
    """k x n circular set (8 x 1 Mbp): one random base, rotated and
    mutated."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    rows = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        idxs = rng.integers(0, n, size=n // 200)
        row[idxs] = rng.integers(0, 4, size=n // 200)
        rows.append(row)
    return rows


def _write_mbp(path: Path, n=1_000_000, k=8, seed=7) -> None:
    import numpy as np

    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "w") as f:
        for i, row in enumerate(_mbp_set(n, k, seed)):
            f.write(f">s{i}\n{letters[row].tobytes().decode()}\n")


def phase_mbp(cli, rot, kernels, fio):
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src = tmp / "mbp.txt"
        _write_mbp(src)
        kernels.reset_counts()
        _, port_wall = run_port_cli(cli, tmp, ["R", "mbp.txt"])
        check(kernels.COUNTS["mscan"] > 0, "mbp: mscan was not launched")
        got = rotations_of(fio, tmp / "mbp-Rotated.fasta")
        seqs = fio.load_fasta(str(src), log=io.StringIO())
        port, port_analyze_ms = wall_ms(lambda: rot.analyze(
            seqs, device="cuda", log=io.StringIO()))
        (tmp / "mbp-Rotated.fasta").unlink()
        native_wall = native_cli(tmp, ["R", "mbp.txt"])
        want = rotations_of(fio, tmp / "mbp-Rotated.fasta")
    check(want == got, "mbp: port rotations (CLI) differ from the native "
                       "engine's")
    check(list(map(int, port.rotations)) == got,
          "mbp: port rotations (analyze) differ from the CLI's")
    emit({"phase": "mbp", "sequences": 8, "length": 1_000_000,
          "rotations_equal_native": True,
          "port_cli_R_wall_s": port_wall,
          "port_analyze_wall_s": port_analyze_ms / 1e3,
          "native_cli_R_wall_s": native_wall})
    return want, port_analyze_ms / 1e3, {"device": port_wall,
                                         "native": native_wall}


# csa_tpu's outputs at its two Mbp configurations (bench.py's _mbp_set),
# taken on a CPU host, since the card's machine has no JAX.  The sets are
# written by _write_mbp; in an empty directory with the repo on the path:
#   python -c "import chip_smoke as c, pathlib; c._write_mbp(pathlib.Path('mbp.txt'), *c.MBP_FULL_SET)"
#   python -m csa_tpu.cli mbp.txt --backend native
#   sha256sum mbp-Rotated.fasta mbp-Aligned.fasta
MBP_FULL_SET = (1_000_000, 8, 7)
MBP_FULL_SHA256 = {
    "mbp-Rotated.fasta":
        "31e098ddd699cfff0df133e68936e5f6e066b98bd366a5739ab8192ce7979759",
    "mbp-Aligned.fasta":
        "18caec92c59fa2d3a89ee55eb32159f9ccad5adca6b64eb2dc56eff93f182872",
}
# 4 x 5 Mbp, seed 13, mode R:
#   python -c "import chip_smoke as c, pathlib; c._write_mbp(pathlib.Path('mbp5.txt'), *c.MBP5_SET)"
#   python -m csa_tpu.cli R mbp5.txt --backend native
#   (the rotations from the headers, the four cascade counts from the
#   console, sha256sum mbp5-Rotated.fasta)
MBP5_SET = (5_000_000, 4, 13)
# its padded size k * _bucket(n), the collect cascade's scan length
MBP5_PADDED = 4 * 5_000_192
MBP5_ROTATIONS = [3_896_717, 4_584_269, 4_567_895, 2_524_738]
MBP5_CASCADE = (4_222_026, 92_976, 73_206, 29_951)
MBP5_ROTATED_SHA256 = (
    "fba4a228e5a1861a01ea2614fa7ce27863f5e964bab951d15e0056b6e80c9cb7")


def sha256_of(path: Path) -> str:
    import hashlib

    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def cascade_counts(text: str):
    """The four cascade counts of the console (nodes found, nodes left
    after the suffix and the repeat filters, chains)."""
    import re

    found = re.findall(r"(\d+) nodes found", text)
    left = re.findall(r"(\d+) nodes left", text)
    chains = re.findall(r"(\d+) chains found", text)
    check(len(found) == 1 and len(left) == 2 and len(chains) == 1,
          "the console does not hold the four cascade counts")
    return tuple(int(v) for v in (found[0], *left, chains[0]))


def profile_table(text: str):
    """({phase: seconds}, {counter: value}) of a ``--profile`` report: the
    phase lines, then (after the TOTAL line) the counters."""
    phases, counters = {}, {}
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if line.startswith(">   TOTAL"):
            break
        if line.startswith(">   "):
            name, secs = line.split()[1:3]
            phases[name] = float(secs.rstrip("s"))
    for line in lines[i + 1:]:
        if line.startswith("> [profile] DP cell-updates:"):
            counters["dp_cells"] = float(line.split()[4])
        elif line.startswith("> [profile] "):
            name, value = line[len("> [profile] "):].split(": ")
            counters[name] = float(value)
    return phases, counters


def check_mbp_full(tmp: Path, text: str) -> None:
    """The 8 x 1 Mbp run's console and files in ``tmp`` against
    csa_tpu's."""
    check("> Done!" in text, "mbp_full: the CLI did not print > Done!")
    check("> Checking integrity of aligned sequences... OK" in text,
          "mbp_full: integrity check failed")
    for name, want in MBP_FULL_SHA256.items():
        check(sha256_of(tmp / name) == want,
              f"mbp_full: {name} differs from csa_tpu's")


def check_mbp5(tmp: Path, text: str) -> None:
    """The 4 x 5 Mbp R run's cascade counts and rotated file in ``tmp``
    against csa_tpu's (its headers hold the rotations)."""
    check(cascade_counts(text) == MBP5_CASCADE,
          f"mbp5: cascade counts {cascade_counts(text)} differ from "
          f"csa_tpu's {MBP5_CASCADE}")
    check(sha256_of(tmp / "mbp5-Rotated.fasta") == MBP5_ROTATED_SHA256,
          "mbp5: -Rotated.fasta differs from csa_tpu's")


def phase_mbp_full(cli, kernels):
    """The full pipeline at 8 x 1 Mbp (seed 7) through the port's CLI on
    the default route, both output files against csa_tpu's digests."""
    import torch

    from csa_tpu_torch.utils import PROFILER

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _write_mbp(tmp / "mbp.txt", *MBP_FULL_SET)
        PROFILER.reset()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        try:
            text, wall = run_port_cli(cli, tmp, ["mbp.txt", "--profile"])
        finally:
            PROFILER.enabled = False
        launches = dict(kernels.COUNTS)
        peak = torch.cuda.max_memory_allocated()
        check_mbp_full(tmp, text)
    check(launches["mscan"] > 0, f"mbp_full: mscan was not launched: "
                                 f"{launches}")
    phases, counters = profile_table(text)
    out = {"sequences": MBP_FULL_SET[1], "length": MBP_FULL_SET[0],
           "cascade": cascade_counts(text), "outputs_equal_csa_tpu": True,
           "integrity": True, "wall_s": wall, "launches": launches,
           "cuda_peak_bytes": peak, "phases_s": phases,
           "counters": counters}
    emit({"phase": "mbp_full", **out})
    return out


def phase_mbp5(cli, rot, kernels, fio):
    """Rotation (mode R) at 4 x 5 Mbp (seed 13) through the port's CLI on
    the default route, then analyze once warm, against csa_tpu's
    rotations and cascade counts."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src = tmp / "mbp5.txt"
        _write_mbp(src, *MBP5_SET)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        text, cli_wall = run_port_cli(cli, tmp, ["R", "mbp5.txt"])
        launches = dict(kernels.COUNTS)
        cli_peak = torch.cuda.max_memory_allocated()
        check_mbp5(tmp, text)
        got = rotations_of(fio, tmp / "mbp5-Rotated.fasta")
        seqs = fio.load_fasta(str(src), log=io.StringIO())
    torch.cuda.reset_peak_memory_stats()
    res, analyze_ms = wall_ms(lambda: rot.analyze(
        seqs, device="cuda", log=io.StringIO()))
    analyze_peak = torch.cuda.max_memory_allocated()
    check(launches["mscan"] > 0, f"mbp5: mscan was not launched: {launches}")
    check(got == MBP5_ROTATIONS, f"mbp5: rotations {got} differ from "
                                 f"csa_tpu's {MBP5_ROTATIONS}")
    check(list(map(int, res.rotations)) == MBP5_ROTATIONS
          and (res.num_collected, res.num_after_suffix, res.num_after_unique,
               res.num_chains) == MBP5_CASCADE,
          "mbp5: analyze (warm) differs from csa_tpu")
    out = {"sequences": MBP5_SET[1], "length": MBP5_SET[0],
           "rotations_equal_csa_tpu": True, "cascade": MBP5_CASCADE,
           "cli_R_wall_s": cli_wall, "analyze_warm_s": analyze_ms / 1e3,
           "launches": launches, "cli_cuda_peak_bytes": cli_peak,
           "analyze_cuda_peak_bytes": analyze_peak}
    emit({"phase": "mbp5", **out})
    return out


def summary_mbp(full, mbp5, card: str) -> None:
    ph = full["phases_s"]
    top = ", ".join(f"{k} {v:.3f}" for k, v in sorted(
        ph.items(), key=lambda kv: -kv[1]) if not k.endswith(".total"))
    c = full["counters"]
    print(f"summary mbp_full 8x1Mbp ({card}): wall {full['wall_s']:.3f} s, "
          f"align.total {ph.get('align.total', 0):.3f}; {top}; "
          f"dp_device_dispatches {c.get('dp_device_dispatches', 0):.0f}, "
          f"dp_cells {c.get('dp_cells', 0):.4g}; card peak "
          f"{full['cuda_peak_bytes'] / 2**30:.3f} GiB; launches "
          f"{full['launches']}; outputs equal csa_tpu's", flush=True)
    print(f"summary mbp5 4x5Mbp R ({card}): CLI {mbp5['cli_R_wall_s']:.3f} "
          f"s, analyze warm {mbp5['analyze_warm_s']:.3f} s; card peak "
          f"{mbp5['cli_cuda_peak_bytes'] / 2**30:.3f} / "
          f"{mbp5['analyze_cuda_peak_bytes'] / 2**30:.3f} GiB; launches "
          f"{mbp5['launches']}; rotations and cascade equal csa_tpu's",
          flush=True)


# the routing phase's synthetic merges (rows x columns): squares, and
# skewed both ways
ROUTING_SHAPES = [(n, n) for n in (64, 128, 256, 512, 1024, 2048, 4096,
                                   8192)] + [
    (64, 1024), (1024, 64), (128, 8192), (8192, 128), (512, 8192),
    (8192, 512), (2048, 8192)]
# the routing phase's synthetic rounds below Primates' smallest (35 M
# cells): (merges, rows = columns of each)
ROUTING_ROUNDS = [(2, 256), (8, 256), (50, 128), (8, 512), (50, 256),
                  (8, 1024), (2, 2048), (50, 512)]
# the routing phase's synthetic R sets below Primates and between Set3
# and 8 x 1 Mbp: (name, length, sequences) from _mbp_set's generator
ROUTING_R_SETS = [("s4x16k", 16_000, 4), ("s8x50k", 50_000, 8),
                  ("s8x500k", 500_000, 8)]


def crossover(points):
    """The measured size T that minimises the summed time of ``points``
    ((size, host ms, card ms) each) when sizes of T and more go to the
    card and the rest to the host; ties go to the smaller T.  None when
    the host alone is faster than every such split."""
    sizes = sorted({p[0] for p in points})
    total = lambda T: sum(c if s >= T else h for s, h, c in points)  # noqa
    t_host = sum(h for _, h, _ in points)
    best = min(sizes, key=lambda T: (total(T), T), default=None)
    return None if best is None or t_host < total(best) else best


def _copy_item(item):
    import numpy as np

    return tuple(np.array(x) if isinstance(x, np.ndarray) else x
                 for x in item)


def _capture_rounds(runner, config, profile, fio, name):
    """The gap DP's rounds of ``name`` (at the fixture's rotations) as the
    device route batches them with both gates at 0: the fill inputs of
    every launch, copied (the host state changes them after)."""
    import numpy as np

    rounds = []
    real = profile.profile_paths

    def spy(items, device, **kw):
        rounds.append([_copy_item(it) for it in items])
        return real(items, device, **kw)

    seqs = fio.load_fasta(str(FIX / f"{name}.txt"), log=io.StringIO())
    rotations = rotations_of(fio, FIX / f"{name}-Rotated.fasta")
    rotated = [np.roll(e, -int(r))
               for e, r in zip(seqs.encoded_all(), rotations)]
    saved = config.run_config()
    config.set_run_config(config.RunConfig(device_min_cells=0,
                                           batch_min_cells=0))
    profile.profile_paths = spy
    try:
        runner.run_alignment(rotated, device="cuda", log=io.StringIO())
    finally:
        profile.profile_paths = real
        config.set_run_config(saved)
    return rounds


def _host_ms(native, item):
    """(path, host ms) of one native fill and walk."""
    t0 = time.perf_counter()
    res = native.dp_fill_path(item[0], item[1], item[2], item[3], item[4])
    return res[1], (time.perf_counter() - t0) * 1e3


def _merge_points(np, native, profile, items, reps):
    """(cells, host ms, card ms) of each merge: the native fill against
    one profile_path launch with its upload and the path's download,
    each the least of ``reps`` warm runs; the two paths must agree."""
    out = []
    for it in items:
        R, C = len(it[0]), len(it[1])
        host = []
        for _ in range(reps):
            want, ms = _host_ms(native, it)
            host.append(ms)
        card = []
        for _ in range(reps):
            got, ms = wall_ms(lambda: profile.profile_path(
                it[0], it[1], it[2], it[3], it[4], device="cuda"))
            card.append(ms)
        check(np.array_equal(got, want),
              f"routing: the card's path of a {R} x {C} merge differs from "
              "the native host fill's")
        out.append((R * C, min(host), min(card)))
    return out


def _bins(points):
    """Merges binned by cells (powers of 4 from 4^3): count, host and
    card ms summed, merges where the card wins."""
    bins = {}
    for cells, h, c in points:
        b = 4 ** max(3, (max(cells, 1).bit_length() - 1) // 2)
        rec = bins.setdefault(b, [0, 0.0, 0.0, 0])
        rec[0] += 1
        rec[1] += h
        rec[2] += c
        rec[3] += c < h
    return [{"cells_from": b, "merges": n, "host_ms": h, "card_ms": c,
             "card_wins": w} for b, (n, h, c, w) in sorted(bins.items())]


def _r_walls(tmp: Path, name: str):
    """Fresh-process walls of the port's CLI in mode R on ``name``.txt in
    ``tmp``, native then device (one run each: the Mbp phases take the
    time of the other runs); the rotated output of both routes must
    agree."""
    walls = {"native": [], "device": []}
    out = {}
    for backend in ("native", "device"):
        rotated = tmp / f"{name}-Rotated.fasta"
        rotated.unlink(missing_ok=True)
        walls[backend].append(run_python(tmp, [
            "-m", "csa_tpu_torch.cli", "R", f"{name}.txt", "--backend",
            backend]))
        out.setdefault(backend, rotated.read_bytes())
    check(out["native"] == out["device"],
          f"routing: {name} rotated differently by the native and the "
          "device route")
    return walls, out["native"]


def phase_routing(cli, kernels, fio, runner, profile, native, tools_files,
                  config, mbp_walls):
    """The crossovers behind the port's routing defaults: a merge (the
    native host fill against one profile_path launch), a round (the
    host fills in sequence against one batched launch) and the rotation
    route of `auto` (fresh-process R walls, --backend native against
    device); then the native, auto and numpy routes' output."""
    import numpy as np

    rng = np.random.default_rng(23)
    i = 9

    def item(R, C):
        sv = rng.integers(0, i + 1, size=(C, 5)).astype(np.int64)
        return (rng.integers(0, 4, size=R).astype(np.int64), sv, i,
                rng.integers(-60, 10, size=C + 1).astype(np.int64), -i)

    synth = [item(R, C) for R, C in ROUTING_SHAPES]
    profile.profile_path(*synth[0], device="cuda")  # warm-up
    synth_pts = _merge_points(np, native, profile, synth, 3)

    merges = {}
    batches = {"synthetic": [[item(n, n) for _ in range(g)]
                             for g, n in ROUTING_ROUNDS]}
    for name in ("Primates", "Set3"):
        batches[name] = _capture_rounds(runner, config, profile, fio, name)
        merges[name] = _merge_points(
            np, native, profile, [it for r in batches[name] for it in r], 2)
    rounds = {}
    for name, caught in batches.items():
        rows = []
        for items in caught:
            cells = sum(len(it[0]) * len(it[1]) for it in items)
            host = min(sum(_host_ms(native, it)[1] for it in items)
                       for _ in range(2))
            card = min(wall_ms(lambda: profile.profile_paths(
                items, "cuda"))[1] for _ in range(2))
            rows.append((cells, host, card, len(items)))
        rounds[name] = rows
    merge_pts = synth_pts + merges["Primates"] + merges["Set3"]
    round_pts = [r[:3] for name in rounds for r in rounds[name]]

    r_walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, n, k in ROUTING_R_SETS:
            _write_mbp(tmp / f"{name}.txt", n, k)
            walls, _ = _r_walls(tmp, name)
            r_walls[name] = {"chars": n * k, **walls}
        for name in ("Primates", "Set3"):
            copy_fixture(tmp, name)
            walls, rotated = _r_walls(tmp, name)
            check(rotated == (FIX / f"{name}-Rotated.fasta").read_bytes(),
                  f"routing: {name} -Rotated.fasta differs (mode R)")
            seqs = fio.load_fasta(str(FIX / f"{name}.txt"), log=io.StringIO())
            r_walls[name] = {"chars": int(sum(seqs.sizes)), **walls}
    # 8 x 1 Mbp from phase mbp: the port's CLI in this process (device)
    # and the JAX package's native CLI in its own
    r_walls["s8x1M"] = {"chars": 8_000_000, "device": [mbp_walls["device"]],
                        "native": [mbp_walls["native"]]}
    r_pts = [(v["chars"], min(v["native"]), min(v["device"]))
             for v in r_walls.values()]

    # the routes' output on the card's machine: native and auto on
    # Primates and Set3 in mode N, numpy on one small set
    routes = {}
    for backend in ("native", "auto"):
        for name in ("Primates", "Set3"):
            with tempfile.TemporaryDirectory() as tmp:
                tmp = Path(tmp)
                copy_fixture(tmp, name)
                kernels.reset_counts()
                _, wall = run_port_cli(cli, tmp, [f"{name}.txt", "--backend",
                                                  backend])
                counts = dict(kernels.COUNTS)
                rotf = tmp / f"{name}-Rotated.fasta"
                aln = tmp / f"{name}-Aligned.fasta"
                check(rotf.read_bytes() == (FIX / f"{name}-Rotated.fasta")
                      .read_bytes(), f"routing: {name} --backend {backend}: "
                                     "-Rotated.fasta differs")
                check(_content_rows(aln) == _content_rows(
                    FIX / f"{name}-Rotated-Aligned.fasta"),
                    f"routing: {name} --backend {backend}: aligned rows "
                    "differ from the fixture")
                check(tools_files.test_alignment_output(
                    str(rotf), str(aln), log=io.StringIO()),
                    f"routing: {name} --backend {backend}: integrity check "
                    "failed")
                check(counts["profile_dp"] == 0 and (
                    backend == "auto" or not any(counts.values())),
                    f"routing: --backend {backend} launched {counts}")
                routes[f"{name} {backend}"] = {"wall_s": wall,
                                               "launches": counts}
    # auto resolved to the device (threshold 0): the device route's
    # rotation, the host's alignment
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        copy_fixture(tmp, "Primates")
        threshold, cli.AUTO_DEVICE_MIN_CHARS = cli.AUTO_DEVICE_MIN_CHARS, 0
        kernels.reset_counts()
        try:
            _, wall = run_port_cli(cli, tmp, ["Primates.txt", "--backend",
                                              "auto"])
        finally:
            cli.AUTO_DEVICE_MIN_CHARS = threshold
        counts = dict(kernels.COUNTS)
        check((tmp / "Primates-Rotated.fasta").read_bytes()
              == (FIX / "Primates-Rotated.fasta").read_bytes()
              and _content_rows(tmp / "Primates-Aligned.fasta")
              == _content_rows(FIX / "Primates-Rotated-Aligned.fasta"),
              "routing: Primates --backend auto at threshold 0 differs")
        check(counts["mscan"] > 0 and counts["profile_dp"] == 0,
              f"routing: auto at threshold 0 launched {counts}")
        routes["Primates auto, threshold 0"] = {"wall_s": wall,
                                                "launches": counts}
    tiny = FIX / "tiny"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        name = "a-diverge-1"
        (tmp / f"{name}.txt").write_bytes((tiny / f"{name}.txt").read_bytes())
        kernels.reset_counts()
        _, wall = run_port_cli(cli, tmp, [f"{name}.txt", "--backend",
                                          "numpy"])
        for suffix in ("-Rotated.fasta", "-Aligned.fasta"):
            check((tmp / f"{name}{suffix}").read_bytes()
                  == (tiny / f"{name}{suffix}").read_bytes(),
                  f"routing: {name} --backend numpy: {suffix} differs")
        check(not any(kernels.COUNTS.values()),
              f"routing: --backend numpy launched {dict(kernels.COUNTS)}")
        routes[f"{name} numpy"] = {"wall_s": wall}

    defaults = config.RunConfig()
    out = {
        "card": smi_line(),
        "merge_crossover_cells": crossover(merge_pts),
        "round_crossover_cells": crossover(round_pts),
        "auto_crossover_chars": crossover(r_pts),
        "defaults": {"device_min_cells": defaults.device_min_cells,
                     "batch_min_cells": defaults.batch_min_cells,
                     "auto_device_min_chars": cli.AUTO_DEVICE_MIN_CHARS},
        "synthetic_merges": [
            {"R": R, "C": C, "host_ms": h, "card_ms": c}
            for (R, C), (_, h, c) in zip(ROUTING_SHAPES, synth_pts)],
        "real_merges": {n: _bins(p) for n, p in merges.items()},
        "real_merge_crossover_cells": {n: crossover(p)
                                       for n, p in merges.items()},
        "rounds": {n: [{"cells": c, "merges": m, "host_ms": h,
                        "card_ms": d} for c, h, d, m in rows]
                   for n, rows in rounds.items()},
        "r_walls_s": r_walls,
        "routes": routes,
    }
    emit({"phase": "routing", **out})
    return out


def summary_routing(out) -> None:
    syn = {(m["R"], m["C"]): m for m in out["synthetic_merges"]}
    pick = lambda R, C: (f"{R}x{C} {syn[R, C]['host_ms']:.3f}/"  # noqa
                         f"{syn[R, C]['card_ms']:.3f}")
    rnd = {n: (f"{sum(r['host_ms'] for r in rows):.1f}/"
               f"{sum(r['card_ms'] for r in rows):.1f}")
           for n, rows in out["rounds"].items() if n != "synthetic"}
    rnd.update({f"{r['merges']}x{r['cells'] // r['merges']}":
                f"{r['host_ms']:.2f}/{r['card_ms']:.2f}"
                for r in out["rounds"]["synthetic"]})
    rw = ", ".join(f"{n} {min(v['native']):.2f}/{min(v['device']):.2f}"
                   for n, v in out["r_walls_s"].items())
    print(f"summary routing ({out['card']}): merge crossover "
          f"{out['merge_crossover_cells']} cells (host/card ms "
          f"{pick(64, 64)}, {pick(512, 512)}, {pick(2048, 2048)}, "
          f"{pick(8192, 8192)}); round crossover "
          f"{out['round_crossover_cells']} cells (rounds host/card ms "
          f"{rnd}); auto crossover {out['auto_crossover_chars']} chars "
          f"(R walls native/device s: {rw}); defaults {out['defaults']}",
          flush=True)


# the sets the fused gate is measured on: the routing phase's R sets
# around the fixtures, (name, length, sequences) from _mbp_set's
# generator, or a fixture's name alone
FUSED_SETS = [("s4x16k", 16_000, 4), ("Primates",), ("Set3",),
              ("s8x50k", 50_000, 8), ("s8x200k", 200_000, 8),
              ("s8x500k", 500_000, 8)]
FUSED_ON = 1 << 62   # a gate above every set: the fused routes run


def _fused_set(np, fio, spec):
    if len(spec) == 1:
        return fio.load_fasta(str(FIX / f"{spec[0]}.txt"),
                              log=io.StringIO()).encoded_all()
    return [np.asarray(r) for r in _mbp_set(spec[1], spec[2])]


def _anchor_string(np, enc):
    """The anchors' linear string of a set (align/anchors.py): each
    sequence above the k separators, followed by its own separator."""
    k = len(enc)
    return np.concatenate([np.append(np.asarray(e, dtype=np.int64) + k, i)
                           for i, e in enumerate(enc)])


@contextlib.contextmanager
def fused_gate(engine, gate):
    saved = engine.FUSED_MAX_CHARS
    engine.FUSED_MAX_CHARS = gate
    try:
        yield
    finally:
        engine.FUSED_MAX_CHARS = saved


def _route_walls(engine, fn):
    """Warm in-process walls (ms) of ``fn`` on the staged and the fused
    route, in turns (staged, fused, fused, staged) after a warm-up of
    each (the fused one captures its graphs): what a process that calls
    one key again pays."""
    walls = {"staged": [], "fused": []}
    for route in ("staged", "fused", "staged", "fused", "fused", "staged"):
        with fused_gate(engine, 0 if route == "staged" else FUSED_ON):
            walls[route].append(wall_ms(fn)[1])
    return {r: w[1:] for r, w in walls.items()}


def _first_walls(engine, graphs, fn):
    """In-process walls (ms) of ``fn``'s first call of a key on each
    route, in turns (staged, fused, fused, staged): the fused route with
    no graph and no cached guess (what a CLI job, one process a call,
    pays on top of the process's start), the staged one as it always
    runs (it keeps nothing between calls)."""
    walls = {"staged": [], "fused": []}
    for route in ("staged", "fused", "fused", "staged"):
        if route == "fused":
            graphs.clear()
            for cache in (engine._TDEEP_CACHE, engine._CAPS_CACHE,
                          engine._LEVELS_CACHE, engine._LINEAR_LEVELS_CACHE):
                cache.clear()
        with fused_gate(engine, 0 if route == "staged" else FUSED_ON):
            walls[route].append(wall_ms(fn)[1])
    return walls


def _gate(points):
    """The largest measured size below the crossover of ``points``
    ((size, fused ms, staged ms) each; sizes from the crossover up go to
    the staged route): every size when there is none, 0 when the staged
    route wins from the smallest."""
    cut = crossover(points)
    sizes = sorted({p[0] for p in points})
    return cut, max((x for x in sizes if cut is None or x < cut), default=0)


def _device_trace(torch, fn):
    """One warm call of ``fn`` under torch.profiler: the card's launches
    (kernels, copies and sets), the share of the call's span (first host
    op to last device op) in which the card is idle, and the gaps between
    its busy stretches; ``None`` values where the trace holds no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = list(prof.events())
    dev = sorted((e.time_range.start, e.time_range.end) for e in evs
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if not dev:
        return {"launches": 0, "idle_share": None, "span_ms": None}
    busy, gaps, (lo, hi) = 0.0, [], dev[0]
    for a, b in dev[1:]:
        if a > hi:
            busy += hi - lo
            gaps.append(a - hi)
            lo = a
        hi = max(hi, b)
    busy += hi - lo
    span = hi - min(e.time_range.start for e in evs)
    tops = sorted(((getattr(a, "device_time_total", 0), a.key, a.count)
                   for a in prof.key_averages()), reverse=True)[:6]
    return {"launches": len(dev), "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / span,
            "gaps": len(gaps), "gap_ms_sum": sum(gaps) / 1e3,
            "gap_ms_max": max(gaps, default=0) / 1e3,
            "top_device_ms": [(k[:70], n, us / 1e3) for us, k, n in tops]}


def phase_fused(cli, engine, graphs, kernels, fio, tools_files):
    """The fused routes (one CUDA graph replay and one download a call):
    Primates and Set3 through the CLI in mode N on the fused routes (the
    gate forced open; twice, the second run replaying only) and on the
    staged routes, against the fixtures; mscan's launches and the
    replays; the staged-against-fused walls of rotation_final and
    linear_suffix_order, first calls and warm calls, and the gates they
    give; the graphs' memory; a trace of the staged block stage (the
    picture before) and of the fused one on Primates and Set3."""
    import numpy as np
    import torch
    from csa_tpu_torch.utils import PROFILER

    t_phase = time.perf_counter()
    real_run = graphs.run
    keys = []

    def spy(key, program, inputs, device):
        keys.append(key)
        return real_run(key, program, inputs, device)

    cli_runs = {}
    graphs.run = spy
    try:
        for name in ("Primates", "Set3"):
            for tag, gate in (("fused", FUSED_ON), ("fused_again", FUSED_ON),
                              ("staged", 0)):
                with tempfile.TemporaryDirectory() as tmp, \
                        fused_gate(engine, gate):
                    tmp = Path(tmp)
                    copy_fixture(tmp, name)
                    PROFILER.reset()
                    del keys[:]
                    captures = graphs.STATS["captures"]
                    kernels.reset_counts()
                    text, wall = run_port_cli(cli, tmp, [f"{name}.txt",
                                                         "--profile"])
                    mscan = kernels.COUNTS["mscan"]
                    rotf = tmp / f"{name}-Rotated.fasta"
                    aln = tmp / f"{name}-Aligned.fasta"
                    check(rotf.read_bytes() == (FIX / f"{name}-Rotated.fasta")
                          .read_bytes(), f"fused: {name} ({tag}): "
                                         "-Rotated.fasta differs")
                    check(_content_rows(aln) == _content_rows(
                        FIX / f"{name}-Rotated-Aligned.fasta"),
                        f"fused: {name} ({tag}): aligned rows differ")
                    check(tools_files.test_alignment_output(
                        str(rotf), str(aln), log=io.StringIO()),
                        f"fused: {name} ({tag}): integrity check failed")
                blocks = sum(k[0] == "block" for k in keys)
                rec = {"wall_s": wall, "mscan_launches": mscan,
                       "block_runs": blocks,
                       "linear_runs": sum(k[0] == "linear" for k in keys),
                       "captures": graphs.STATS["captures"] - captures,
                       "idx_fused_phase": "idx.fused" in _profile_phases(
                           text)}
                if tag == "staged":
                    check(not keys and not rec["idx_fused_phase"],
                          f"fused: {name} at gate 0 ran a fused program")
                else:
                    check(blocks >= 1 and rec["linear_runs"] >= 1
                          and rec["idx_fused_phase"],
                          f"fused: {name} did not take the fused routes")
                if tag == "fused_again":
                    check(rec["captures"] == 0 and blocks == 1
                          and rec["linear_runs"] == 1,
                          f"fused: {name}'s second run did not replay "
                          f"alone: {rec}")
                    check(mscan == 3 * blocks, f"fused: {name}: {mscan} "
                          f"mscan launches in {blocks} block replays")
                cli_runs[f"{name} {tag}"] = rec
    finally:
        graphs.run = real_run

    sets, first_pts, warm_pts, memory = {}, [], [], {}
    for spec in FUSED_SETS:
        enc = _fused_set(np, fio, spec)
        padded = len(enc) * engine._bucket(max(len(e) for e in enc))
        s = _anchor_string(np, enc)
        total = engine._bucket(len(s))
        blk_fn = lambda: engine.rotation_final(enc, "cuda")  # noqa
        lin_fn = lambda: engine.linear_suffix_order(s, "cuda")  # noqa
        blk = _route_walls(engine, blk_fn)
        lin = _route_walls(engine, lin_fn)
        with fused_gate(engine, FUSED_ON):
            fused = blk_fn()
            lin_f = lin_fn()
        with fused_gate(engine, 0):
            staged = blk_fn()
            lin_s = lin_fn()
        check(fused.num_collected == staged.num_collected
              and np.array_equal(fused.final_start, staged.final_start)
              and np.array_equal(fused.final_positions,
                                 staged.final_positions),
              f"fused: {spec[0]}: the fused block stage differs")
        check(all(np.array_equal(a, b) for a, b in zip(lin_f, lin_s)),
              f"fused: {spec[0]}: the fused linear sort differs")
        k, n_max = len(enc), engine._bucket(max(len(e) for e in enc))
        memory[spec[0]] = {
            "block": max((b for key, b, _, _ in graphs.entries()
                          if key[1][:3] == ("block", k, n_max)), default=0),
            "linear": max((b for key, b, _, _ in graphs.entries()
                           if key[1][:2] == ("linear", total)), default=0)}
        blk1 = _first_walls(engine, graphs, blk_fn)
        lin1 = _first_walls(engine, graphs, lin_fn)
        sets[spec[0]] = {"padded": padded, "linear_total": total,
                         "rotation_final_ms": blk,
                         "linear_suffix_order_ms": lin,
                         "rotation_final_first_ms": blk1,
                         "linear_suffix_order_first_ms": lin1}
        for size, first, warm in ((padded, blk1, blk), (total, lin1, lin)):
            first_pts.append((size, min(first["fused"]),
                              min(first["staged"])))
            warm_pts.append((size, min(warm["fused"]), min(warm["staged"])))
    # the default serves the entry points, which call each function once
    # a process: the gate from the first calls; the warm one is what a
    # process calling one key again would take
    cut, gate = _gate(first_pts)
    warm_cut, warm_gate = _gate(warm_pts)

    traces = {}
    for name in ("Primates", "Set3"):
        enc = _fused_set(np, fio, (name,))
        traces[name] = {
            "staged": _device_trace(torch, lambda: engine.rotation_final_staged(
                enc, "cuda")),
            "fused": _device_trace(torch, lambda: engine._rotation_final_fused(
                enc, "cuda"))}
    out = {"card": smi_line(), "cli": cli_runs, "sets": sets,
           "graph_memory_bytes": memory, "crossover_size": cut,
           "measured_gate": gate, "warm_crossover_size": warm_cut,
           "warm_gate": warm_gate, "default_gate": engine.FUSED_MAX_CHARS,
           "traces": traces,
           "refinements_cached": {
               "block": {str(k): v for k, v in engine._LEVELS_CACHE.items()},
               "linear": {str(k): v for k, v
                          in engine._LINEAR_LEVELS_CACHE.items()}},
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "fused", **out})
    return out


def summary_fused(out) -> None:
    ms = lambda d: f"{min(d['staged']):.2f}/{min(d['fused']):.2f}"  # noqa
    walls = ", ".join(
        f"{n} {v['padded']} {ms(v['rotation_final_first_ms'])} "
        f"lin {ms(v['linear_suffix_order_first_ms'])}"
        for n, v in out["sets"].items())
    warm = ", ".join(f"{n} {ms(v['rotation_final_ms'])} "
                     f"lin {ms(v['linear_suffix_order_ms'])}"
                     for n, v in out["sets"].items())
    tr = "; ".join(
        f"{n} " + ", ".join(
            f"{r} {t['launches']} launches, idle "
            + ("not measured" if t["idle_share"] is None
               else f"{t['idle_share']:.0%} of {t['span_ms']:.2f} ms, "
                    f"top {t['top_device_ms'][0]}")
            for r, t in v.items())
        for n, v in out["traces"].items())
    mem = ", ".join(f"{n} {v['block'] / 2**20:.0f}/{v['linear'] / 2**20:.0f}"
                    for n, v in out["graph_memory_bytes"].items())
    again = {n.split()[0]: v["mscan_launches"]
             for n, v in out["cli"].items() if n.endswith("fused_again")}
    print(f"summary fused ({out['card']}): gate measured "
          f"{out['measured_gate']} (crossover {out['crossover_size']}), "
          f"default {out['default_gate']}, warm gate {out['warm_gate']}; "
          f"first call staged/fused ms: {walls}; warm staged/fused ms: "
          f"{warm}; mscan a replayed run {again}; graph MiB block/linear "
          f"{mem}; traces {tr}; phase {out['seconds']:.1f} s", flush=True)


def _band_args(torch, np, profile, rng, Rb, Cloc, i, rank0, sc):
    """One band's inputs on the card: seeded codes and score vector, a
    random stale top row, and rank 0's edge (j * edge_rowgap) or a random
    halo as the left column."""
    sv = rng.integers(0, min(i, 64) + 1, size=(Cloc, 5))
    colsub, cg, rowgap = profile._channels(
        torch.from_numpy(sv)[None], torch.tensor([i]), **sc)
    left = (sc["indel"] * i * np.arange(1, Rb + 1) if rank0
            else rng.integers(-400, 100, size=Rb))
    put = lambda a, dt: torch.as_tensor(a, dtype=dt).to("cuda")  # noqa: E731
    return (put(rng.integers(0, 4, size=Rb), torch.int8),
            put(colsub[0], torch.int32), put(cg[0], torch.int32),
            int(rowgap[0]), put(rng.integers(-400, 100, size=Cloc + 1),
                                torch.int32), put(left, torch.int32))


def phase_band(band, stats):
    import numpy as np
    import torch

    from csa_tpu_torch.dp import profile

    rng = np.random.default_rng(9)
    dflt = dict(match=1, mismatch=-1, indel=-1, doublegap=0)
    nd = dict(match=2, mismatch=-3, indel=-2, doublegap=-1)
    R, C = SET3_GIANT
    Tc = profile.TILE_COLS
    step_us = stats["profile_dp"]["step_us"]
    # (name, Rb, Cloc, i, rank 0, scoring)
    cases = [
        ("rank0_edge", 300, 500, 7, True, dflt),
        ("halo", 300, 500, 7, False, dflt),
        ("rb1_cloc1", 1, 1, 3, False, dflt),
        ("rb_odd", 1021, 333, 5, True, dflt),
        ("non_default_scoring", 700, 900, 6, False, nd),
        ("i64", 256, 640, 64, False, dflt),
        ("set3_8_ranks", 2048, -(-C // 8), 9, False, dflt),
        ("set3_2_ranks", 2048, -(-C // 2), 9, True, dflt),
        ("cloc_30000", 2048, 30_000, 9, False, dflt),
    ]
    worst = 0
    for name, Rb, Cloc, i, rank0, sc in cases:
        args = _band_args(torch, np, profile, rng, Rb, Cloc, i, rank0, sc)
        scratch = band.scratch_for(Rb, Cloc, args[3], "cuda")
        kern = lambda: band.band_fill(*args, scratch=scratch)  # noqa: E731
        got = kern()
        want, pms = wall_ms(lambda: band.band_fill_plain(*args))
        torch.cuda.synchronize()
        # both direction bits of every cell (a ragged tile's other bytes
        # are undefined), the bottom row and the edge
        pairs = [(band.cell_bits(got[0], Rb, Cloc),
                  band.cell_bits(want[0], Rb, Cloc), "directions"),
                 (got[1], want[1], "bottom"), (got[2], want[2], "edge")]
        for g, w, what in pairs:
            check(torch.equal(g, w), f"band {what} differ in case {name}")
            worst = max(worst, int((g.long() - w.long()).abs().max()))
        ms = cuda_ms(kern, 5)
        # the batch fill (the engine without the band's code) on the same
        # one-gap tile graph: what the band's own code costs
        same = profile._upload(_profile_items(
            np, np.random.default_rng(Rb + Cloc), [(Rb, Cloc)],
            lambda r: i, True, sc), "cuda", **sc)
        same_ms = cuda_ms(lambda: profile._launch_fill(same), 5)
        cells = Rb * Cloc
        # in: codes, colsub, cg, top, left; out: 2 bits a cell, bottom,
        # edge
        nbytes = (Rb + 24 * Cloc + 4 * (Cloc + 1) + 4 * Rb
                  + cells / 4 + 4 * (Cloc + 1) + 4 * Rb)
        bms, by = bound(nbytes, PROFILE_OPS_PER_CELL * cells)
        ntr, ntc = profile.tile_grid(Rb, Cloc)
        # the design's floor: its tile anti-diagonals one after the other,
        # Tc + 31 steps each at the profile phase's step time
        floor_ms = (ntr + ntc - 1) * (Tc + 31) * step_us / 1e3
        emit({"phase": "band", "case": name, "Rb": Rb, "Cloc": Cloc,
              "i": i, "scoring": sc, "tiles": scratch.T,
              "tile_diagonals": ntr + ntc - 1, "workers": scratch.workers,
              "equal": True, "ms": ms, "plain_ms": pms,
              "gcell_per_s": cells / ms / 1e6, "bound_ms": bms,
              "bound_by": by, "design_floor_ms": floor_ms,
              "profile_fill_same_tiles_ms": same_ms})
        if name == "set3_8_ranks":
            stats["band"].update(ms=ms, plain_ms=pms, library_ms=None,
                                 bound_ms=bms, bound_by=by,
                                 design_floor_ms=floor_ms,
                                 profile_fill_same_tiles_ms=same_ms)
    stats["band"]["max_abs_err"] = worst


def _band_spans(band, fill):
    """Run ``fill`` with every band launch between two CUDA events on its
    rank's stream; returns (device span from the first band's start to
    the last band's end, median band ms, ms from one band call's start to
    the next), in milliseconds."""
    import numpy as np
    import torch

    real = band.band_fill
    log = []

    def timed(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*args, **kw)
        e1.record()
        log.append((e0, e1, time.perf_counter()))
        return out

    band.band_fill = timed
    try:
        fill()
    finally:
        band.band_fill = real
    torch.cuda.synchronize()
    first = log[0][0]
    span = max(first.elapsed_time(e1) for _, e1, _ in log)
    med = float(np.median([e0.elapsed_time(e1) for e0, e1, _ in log]))
    calls = [b[2] - a[2] for a, b in zip(log, log[1:])]
    return span, med, float(np.median(calls)) * 1e3 if calls else 0.0


def phase_seqpar(seqpar, profile, band, kernels, native):
    import numpy as np
    import torch

    from csa_tpu_torch.parallel.sharded import make_mesh

    i = 9
    rng = np.random.default_rng(17)
    for name, (R, C) in (("set3_largest_giant", SET3_GIANT),
                         ("primates_largest_giant", PRIMATES_GIANT)):
        codes = rng.integers(0, 4, size=R).astype(np.int8)
        sv = rng.integers(0, i + 1, size=(C, 5)).astype(np.int64)
        top = rng.integers(-60, 10, size=C + 1).astype(np.int64)
        erg = -11
        profile.profile_path(codes, sv, i, top, erg, device="cuda")  # warm-up
        ref, prof_ms = wall_ms(lambda: profile.profile_path(
            codes, sv, i, top, erg, device="cuda"))
        nat = native.dp_fill_path(codes, sv, i, top, erg)
        check(nat is not None and np.array_equal(ref, nat[1]),
              f"seqpar {name}: the profile kernel's path differs from the "
              "native one")
        runs = {}
        for n in (2, 4, 8):
            mesh = make_mesh(n, devices=["cuda"])
            seqpar.dp_path_seqpar(codes, sv, i, mesh, top_row=top,
                                  edge_rowgap=erg)  # warm-up
            kernels.reset_counts()
            got, ms = wall_ms(lambda: seqpar.dp_path_seqpar(
                codes, sv, i, mesh, top_row=top, edge_rowgap=erg))
            launches = kernels.COUNTS["band"]
            nb = -(-R // seqpar.BAND_ROWS)
            check(launches == n * nb + 1,
                  f"seqpar {name} at {n} ranks: {launches} band launches, "
                  f"want {n * nb + 1}")
            check(np.array_equal(got, ref),
                  f"seqpar {name} at {n} ranks: path differs from the "
                  "profile kernel's")
            # the fill alone, then the walk kernel against its host walk
            # on the same blocks
            fill = lambda: seqpar.fill_blocks(  # noqa: E731
                codes, sv, i, mesh, band_rows=seqpar.BAND_ROWS, top_row=top,
                edge_rowgap=erg, match=1, mismatch=-1, indel=-1,
                doublegap=0)
            (blocks, nb, Rb, Cloc), fill_ms = wall_ms(fill)
            walked, walk_ms = wall_ms(lambda: band.band_walk(
                blocks, R, C, nb=nb, Rb=Rb, Cloc=Cloc))
            check(np.array_equal(band.band_walk_plain(
                blocks, R, C, nb=nb, Rb=Rb, Cloc=Cloc), walked),
                f"seqpar {name} at {n} ranks: the walk kernel differs from "
                "the host walk")
            # the device's share of the fill: the supersteps' span, a
            # band's time on the card, the host's time between launches
            span, band_med, call_ms = _band_spans(band, fill)
            runs[n] = {"ms": ms, "fill_ms": fill_ms, "walk_ms": walk_ms,
                       "fill_device_span_ms": span,
                       "band_device_ms_median": band_med,
                       "host_ms_between_band_calls": call_ms,
                       "band_launches": launches, "bands": nb,
                       "band_rows": Rb, "cols_per_rank": Cloc,
                       "gcell_per_s": R * C / ms / 1e6}
        emit({"phase": "seqpar", "case": name, "R": R, "C": C, "i": i,
              "stale_top": True, "equal_profile_kernel": True,
              "equal_native_host": True, "profile_kernel_ms": prof_ms,
              "profile_kernel_gcell_per_s": R * C / prof_ms / 1e6,
              "ranks": runs})


def phase_sharded(cli, kernels, tools_files, seqpar, profile, single_walls):
    from csa_tpu_torch.utils import PROFILER

    # wall seconds of each giant (seqpar) and of each rank-split batch of
    # the rest of a round; both return host arrays, so they have synced
    calls = []
    batches = []
    real = seqpar.dp_path_seqpar
    real_batch = profile.profile_paths_sharded

    def spy(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        calls.append(time.perf_counter() - t0)
        return out

    def batch_spy(*args, **kw):
        t0 = time.perf_counter()
        out = real_batch(*args, **kw)
        batches.append(time.perf_counter() - t0)
        return out

    out = {}
    launches = {}
    for name in ("Primates", "Set3"):
        rec = {"single_device_wall_s": single_walls[name]}
        for backend in ("device", "sharded"):
            argv = [f"{name}.txt", "--profile"]
            if backend == "sharded":
                argv += ["--backend", "sharded", "--mesh", "8x1"]
            with tempfile.TemporaryDirectory() as tmp:
                tmp = Path(tmp)
                copy_fixture(tmp, name)
                PROFILER.reset()
                calls.clear()
                batches.clear()
                seqpar.dp_path_seqpar = spy
                profile.profile_paths_sharded = batch_spy
                kernels.reset_counts()
                try:
                    _, wall = run_port_cli(cli, tmp, argv)
                finally:
                    seqpar.dp_path_seqpar = real
                    profile.profile_paths_sharded = real_batch
                counts = dict(kernels.COUNTS)
                rot = tmp / f"{name}-Rotated.fasta"
                aln = tmp / f"{name}-Aligned.fasta"
                check(rot.read_bytes() == (FIX / f"{name}-Rotated.fasta")
                      .read_bytes(), f"{name} {backend}: -Rotated.fasta "
                                     "differs")
                check(_content_rows(aln) == _content_rows(
                    FIX / f"{name}-Rotated-Aligned.fasta"),
                    f"{name} {backend}: aligned rows differ from the fixture")
                check(tools_files.test_alignment_output(
                    str(rot), str(aln), log=io.StringIO()),
                    f"{name} {backend}: integrity check failed")
            rec[backend] = {
                "profiled_wall_s": wall,
                "align.dp_fill_s": PROFILER.phases.get("align.dp_fill"),
                "dp_device_dispatches":
                    PROFILER.counters.get("dp_device_dispatches"),
                "seqpar_dispatches": len(calls),
                "seqpar_s": sum(calls), "seqpar_max_s": max(calls, default=0),
                "rank_split_batches": len(batches),
                "rank_split_batch_s": sum(batches), "launches": counts,
                "phases_s": {k: round(v, 4)
                             for k, v in PROFILER.phases.items()}}
            if backend == "sharded":
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
        check(rec["sharded"]["seqpar_dispatches"] > 0,
              f"{name}: no merge reached dp_path_seqpar")
        check({"rot.block_stage[sharded]", "idx.replicate"}
              <= set(rec["sharded"]["phases_s"]),
              f"{name}: the rotation did not run sharded")
        out[name] = rec
    check(launches["band"] > 0 and launches["profile_dp"] > 0,
          f"a kernel of the sharded path was not launched: {launches}")
    emit({"phase": "sharded", "mesh": "8x1", "rotated_identical": True,
          "aligned_rows_identical": True, "integrity": True,
          "launches": launches, "sets": out})
    return launches


def _profile_phases(text: str):
    return {l.split()[1] for l in text.splitlines() if l.startswith(">   ")}


def phase_sharded_rotation(cli, rot, kernels, fio, scaling, native_rot,
                           single_analyze_s):
    from csa_tpu_torch.parallel.sharded import make_mesh
    from csa_tpu_torch.utils import PROFILER

    def blocks(res):
        return (list(map(int, res.rotations)), res.num_collected,
                res.num_after_suffix, res.num_after_unique, res.num_chains,
                res.block_depths.tolist())

    out = {"single_device_analyze_s": single_analyze_s}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _write_mbp(tmp / "mbp.txt")
        seqs = fio.load_fasta(str(tmp / "mbp.txt"), log=io.StringIO())
        single = rot.analyze(seqs, device="cuda", log=io.StringIO())
        check(list(map(int, single.rotations)) == native_rot,
              "sharded_rotation: the single-device port's rotations differ "
              "from the native engine's")
        analyze = {}
        for n in (1, 2, 4, 8):
            mesh = make_mesh(n, devices=["cuda"])
            runs = []
            for _ in range(2):
                kernels.reset_counts()
                res, ms = wall_ms(lambda: rot.analyze(
                    seqs, device="cuda", log=io.StringIO(), mesh=mesh))
                runs.append((res, ms / 1e3, kernels.COUNTS["mscan"]))
            for res, _, launches in runs:
                check(blocks(res) == blocks(single),
                      f"sharded_rotation: {n} ranks differ from the "
                      "single-device port")
                check(launches >= 3 * n,
                      f"sharded_rotation: {launches} mscan launches at {n} "
                      "ranks")
            analyze[n] = {"wall_s": [r[1] for r in runs],
                          "mscan_launches": [r[2] for r in runs]}
        out["analyze"] = analyze
        cli_runs = []
        for _ in range(2):
            (tmp / "mbp-Rotated.fasta").unlink(missing_ok=True)
            PROFILER.reset()
            kernels.reset_counts()
            text, wall = run_port_cli(cli, tmp, [
                "R", "mbp.txt", "--backend", "sharded", "--mesh", "8x1",
                "--profile"])
            check(kernels.COUNTS["mscan"] >= 3 * 8,
                  "sharded_rotation: the CLI's ranks did not launch mscan")
            check({"rot.block_stage[sharded]", "idx.replicate"}
                  <= _profile_phases(text),
                  "sharded_rotation: the CLI's rotation did not run sharded")
            rotated = (tmp / "mbp-Rotated.fasta").read_bytes()
            check(rotations_of(fio, tmp / "mbp-Rotated.fasta") == native_rot,
                  "sharded_rotation: the CLI's rotations differ from the "
                  "native engine's")
            cli_runs.append((rotated, wall))
        check(cli_runs[0][0] == cli_runs[1][0],
              "sharded_rotation: two CLI runs at --mesh 8x1 differ")
        out["cli_8x1_wall_s"] = [w for _, w in cli_runs]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        copy_fixture(tmp, "Primates")
        walls = []
        for _ in range(2):
            (tmp / "Primates-Rotated.fasta").unlink(missing_ok=True)
            PROFILER.reset()
            text, wall = run_port_cli(cli, tmp, [
                "R", "Primates.txt", "--backend", "sharded", "--mesh", "3x1",
                "--profile"])
            phases = _profile_phases(text)
            check("rot.block_stage[sharded]" in phases
                  and "idx.replicate" not in phases,
                  "sharded_rotation: 3 ranks did not take the single-device "
                  "stage")
            check((tmp / "Primates-Rotated.fasta").read_bytes()
                  == (FIX / "Primates-Rotated.fasta").read_bytes(),
                  "sharded_rotation: Primates at --mesh 3x1 differs")
            walls.append(wall)
        out["primates_3x1_wall_s"] = walls
    m = scaling.measure(k=8, n=1_000_000, seed=7, ranks=(1, 2, 4, 8),
                        reps=2, device="cuda")
    check(m["argsort"]["exact_vs_stable_sort"],
          "sharded_rotation: sharded_argsort differs from torch.sort")
    check(m["sharded_alignment_parity"],
          "sharded_rotation: the sharded alignment differs")
    check(m["giant_merge_seqpar"]["path_identical_to_native"] is True,
          "sharded_rotation: the giant's path differs from the native one")
    out["scaling"] = m
    emit({"phase": "sharded_rotation", "rotations_equal_native": True,
          "runs_agree": True, **out})
    return out


def summary_sharded_rotation(out) -> None:
    m = out["scaling"]
    fmt = lambda d: "/".join(f"{d[n]:.3f}" for n in (1, 2, 4, 8))  # noqa
    mb = "/".join(f"{m['exchange_bytes'][n] / 1e6:.0f}" for n in (1, 2, 4, 8))
    print(f"summary sharded_rotation 8x1Mbp: block stage single "
          f"{m['single_device_wall_s']:.3f} s, ranks 1/2/4/8 "
          f"{fmt(m['walls_s'])} s; analyze single "
          f"{out['single_device_analyze_s']:.3f}, ranks "
          f"{fmt({n: min(v['wall_s']) for n, v in out['analyze'].items()})}"
          f" s; exchange MB {mb}", flush=True)


# one process of the port's CLI: its kernels' launch counts zeroed just
# before cli.main and read just after, and the wall of cli.main
CLI_CHILD = """
import json, sys, time
from csa_tpu_torch import cli, kernels
kernels.reset_counts()
t0 = time.perf_counter()
rc = cli.main(sys.argv[1:])
wall = time.perf_counter() - t0
print("CSA_CHILD " + json.dumps({"launches": dict(kernels.COUNTS),
                                 "wall_s": wall}), flush=True)
sys.exit(rc)
"""


def run_cli_processes(distributed, tools_files, name, n, backend=None,
                      visible=None):
    """The port's CLI, mode N on ``name`` at --backend sharded --mesh 8x1,
    as ``n`` processes of one world (``n`` = 1: one process alone), each
    in a directory of its own with ``CUDA_VISIBLE_DEVICES`` from
    ``visible``.  Checks every process's output against the fixtures and
    its world's backend; returns (per process: launches and cli.main
    wall, the group's wall with the interpreters' start-up)."""
    with tempfile.TemporaryDirectory() as tmp:
        port = distributed.free_port()
        argvs, cwds, envs = [], [], []
        for pid in range(n):
            d = Path(tmp) / f"p{pid}"
            d.mkdir()
            copy_fixture(d, name)
            argv = [sys.executable, "-c", CLI_CHILD, f"{name}.txt",
                    "--backend", "sharded", "--mesh", "8x1"]
            if n > 1:
                argv += ["--coordinator", f"127.0.0.1:{port}",
                         "--num-processes", str(n), "--process-id", str(pid)]
            env = {**os.environ, "PYTHONPATH": str(ROOT)}
            if visible is not None:
                env["CUDA_VISIBLE_DEVICES"] = visible[pid]
            argvs.append(argv)
            cwds.append(d)
            envs.append(env)
        t0 = time.perf_counter()
        outs = distributed.run_processes(argvs, timeout=600, cwds=cwds,
                                         envs=envs)
        group_wall = time.perf_counter() - t0
        procs = []
        for pid, (d, (rc, out, err)) in enumerate(zip(cwds, outs)):
            what = f"distributed: {name}, process {pid} of {n}"
            check(rc == 0, f"{what} exited {rc}: {err[-2000:]}")
            rot = d / f"{name}-Rotated.fasta"
            aln = d / f"{name}-Aligned.fasta"
            check(rot.read_bytes() == (FIX / f"{name}-Rotated.fasta")
                  .read_bytes(), f"{what}: -Rotated.fasta differs")
            check(_content_rows(aln) == _content_rows(
                FIX / f"{name}-Rotated-Aligned.fasta"),
                f"{what}: aligned rows differ from the fixture")
            check(tools_files.test_alignment_output(
                str(rot), str(aln), log=io.StringIO()),
                f"{what}: integrity check failed")
            if n > 1:
                check(f"process {pid}/{n}, 8 global ranks, backend "
                      f"{backend}" in out, f"{what}: not a {backend} world")
            procs.append(json.loads(next(
                l for l in out.splitlines()
                if l.startswith("CSA_CHILD "))[len("CSA_CHILD "):]))
    return procs, group_wall


# the kernels every process of a leg launches: each of Set3's rounds
# at --mesh 8x1 is a giant (band) and a merge of about 1,000 cells,
# which the per-merge gate keeps on the native host fill
LEG_KERNELS = {"Primates": ("mscan", "profile_dp"),
               "Set3": ("mscan", "band")}


def _cli_leg(distributed, tools_files, n, backend, visible=None):
    """Primates and Set3 as ``n`` processes; every process launches
    mscan and profile_dp on Primates, mscan and band on Set3."""
    out = {}
    for name in ("Primates", "Set3"):
        procs, wall = run_cli_processes(distributed, tools_files, name, n,
                                        backend, visible)
        for pid, p in enumerate(procs):
            need = LEG_KERNELS[name]
            check(all(p["launches"][k] > 0 for k in need),
                  f"distributed: {name}, process {pid} of {n} ({backend}) "
                  f"did not launch {need}: {p['launches']}")
        out[name] = {"group_wall_s": wall,
                     "cli_wall_s": [p["wall_s"] for p in procs],
                     "launches": [p["launches"] for p in procs]}
    return out


def _dryrun(distributed, n, per, backend, visible=None):
    res = distributed.run_multiprocess_dryrun(n, per, "cuda", timeout=600,
                                              visible=visible)
    check(res.get("ok") is True and res.get("backend") == backend,
          f"distributed: the dryrun of {n} x {per} ranks over {backend} "
          f"failed: {res}")
    res.pop("blocks")
    return res


def _teardown_loop(teardown, worlds, backend, visible):
    """``worlds`` two-process worlds of every Ranks exchange on CUDA
    ranks, 3 to a pair of processes: no abort, every process exits 0,
    every world agrees with one process and frees its group."""
    res = teardown.run_teardown_loop(worlds, device="cuda",
                                     worlds_per_process=3, timeout=600,
                                     visible=visible)
    bad = res["aborted_worlds"] or res["failed_worlds"]
    check(not bad, f"distributed: {res['aborts']} aborted and "
          f"{res['failed']} failed of {worlds} {backend} teardown worlds; "
          f"the first: {res['records'][bad[0]] if bad else None}")
    check(all(r["backend"] == backend and r["group_freed"]
              for r in res["records"]),
          f"distributed: a teardown world was not {backend} or kept its "
          "group")
    return res


def phase_distributed(distributed, teardown, tools_files):
    import torch

    # the one-card legs on card 0 whatever the machine holds
    out = {"dryrun": {"gloo_2x4": _dryrun(distributed, 2, 4, "gloo",
                                          ["0", "0"])},
           "single": _cli_leg(distributed, tools_files, 1, None, ["0"]),
           "gloo_2": _cli_leg(distributed, tools_files, 2, "gloo",
                              ["0", "0"])}
    loops = {"gloo": _teardown_loop(teardown, 12, "gloo", ["0", "0"])}
    cards = torch.cuda.device_count()
    for n in (2, 4):
        if n > cards:
            continue
        visible = [str(k) for k in range(n)]
        out["dryrun"][f"nccl_{n}x{8 // n}"] = _dryrun(
            distributed, n, 8 // n, "nccl", visible)
        out[f"nccl_{n}"] = _cli_leg(distributed, tools_files, n, "nccl",
                                    visible)
    if cards >= 2:
        loops["nccl"] = _teardown_loop(teardown, 4, "nccl", ["0", "1"])
    else:
        print("distributed: the NCCL leg was not run: one card is visible, "
              "and NCCL needs a card of its own for each process",
              flush=True)
    emit({"phase": "distributed", "cards": cards, "mesh": "8x1",
          "rotated_identical": True, "aligned_rows_identical": True,
          **out, "teardown": loops})
    out["teardown"] = loops
    return out


def summary_teardown(out, teardown, card: str) -> None:
    for backend, res in out["teardown"].items():
        print(f"{teardown.summary_line(res)} backend={backend} "
              f"card={card}", flush=True)


def summary_distributed(out) -> None:
    dr = out["dryrun"]
    legs = [k for k in out if k not in ("dryrun", "single", "teardown")]
    walls = "; ".join(
        f"{name} single {out['single'][name]['cli_wall_s'][0]:.3f} s, "
        + ", ".join(f"{leg} " + "/".join(f"{w:.3f}" for w in
                                         out[leg][name]["cli_wall_s"])
                    + " s" for leg in legs)
        for name in ("Primates", "Set3"))
    print(f"summary distributed 8x1: dryrun "
          + ", ".join(f"{k} ok, {v['rank_process_bytes'] / 1e6:.1f} MB "
                      f"across processes" for k, v in dr.items())
          + f"; cli.main walls {walls}"
          + ("" if any(k.startswith("nccl") for k in out)
             else "; NCCL not run (one card)"), flush=True)


def summary(stats, launches) -> None:
    """One short line a kernel shape: ms, bound ms and share, plain and
    library ms, launches on its path."""
    rows = [("mscan 12x278528", stats["mscan"], "mscan"),
            ("mscan 12x8003584", stats["mscan"]["at_12x8003584"], "mscan"),
            (f"mscan 12x{MBP5_PADDED}",
             stats["mscan"][f"at_12x{MBP5_PADDED}"], "mscan"),
            ("profile_dp 8x8192^2", stats["profile_dp"], "profile_dp"),
            ("nw 135x17408^2", stats["nw"], "nw"),
            ("nw set3 oracle", stats["nw"]["set3_oracle"], "nw"),
            ("band 2048x2607", stats["band"], "band")]
    fmt = lambda v: "none" if v is None else f"{v:.4f}"  # noqa: E731
    for label, st, name in rows:
        dev = (f", kernel alone {fmt(st['device_ms'])} ms"
               if st.get("device_ms") is not None else "")
        print(f"summary {label}: {st['ms']:.4f} ms{dev}, bound "
              f"{st['bound_ms']:.4f} ({st['bound_by']}, "
              f"{st['bound_ms'] / st['ms']:.0%}), plain "
              f"{st['plain_ms']:.3f}, library {fmt(st.get('library_ms'))}, "
              f"launches {launches[name]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from csa_tpu_torch import cli, config, kernels, native
    from csa_tpu_torch.align import runner
    from csa_tpu_torch.dp import band, nw, profile, seqpar
    from csa_tpu_torch.index import engine, graphs, mscan
    from csa_tpu_torch.io import fasta as fio
    from csa_tpu_torch.parallel import distributed, scaling, teardown
    from csa_tpu_torch.rotation import pipeline as rot
    from csa_tpu_torch.rotation import verification
    from csa_tpu_torch.tools import files as tools_files

    stats = {"mscan": {}, "profile_dp": {}, "nw": {}, "band": {}}
    phase_toolchain(kernels, native)
    phase_build(kernels)
    phase_mscan(mscan, stats)
    phase_profile(profile, kernels, stats)
    phase_nw(nw, fio, verification, stats)
    launches, walls = phase_pipeline(cli, kernels, tools_files)
    launches["nw"] = phase_verify(cli, kernels, nw, verification)["nw"]
    mbp_native, mbp_single_s, mbp_walls = phase_mbp(cli, rot, kernels, fio)
    mbp_full = phase_mbp_full(cli, kernels)
    mbp5 = phase_mbp5(cli, rot, kernels, fio)
    routing = phase_routing(cli, kernels, fio, runner, profile, native,
                            tools_files, config, mbp_walls)
    phase_band(band, stats)
    phase_seqpar(seqpar, profile, band, kernels, native)
    launches["band"] = phase_sharded(cli, kernels, tools_files, seqpar,
                                      profile, walls)["band"]
    sharded_rot = phase_sharded_rotation(cli, rot, kernels, fio, scaling,
                                         mbp_native, mbp_single_s)
    dist_out = phase_distributed(distributed, teardown, tools_files)
    fused = phase_fused(cli, engine, graphs, kernels, fio, tools_files)
    check("jax" not in sys.modules, "jax was imported")
    check("csa_tpu" not in sys.modules, "the JAX package was imported")

    meta = {
        "mscan": ("csa_tpu_torch/csrc/mscan.cu",
                  "csa_tpu/index/mscan.py:34"),
        "profile_dp": ("csa_tpu_torch/csrc/profile_dp.cu",
                       "csa_tpu/dp/pallas_profile.py:83"),
        "nw": ("csa_tpu_torch/csrc/nw.cu", "csa_tpu/dp/pallas_nw.py:38"),
        "band": ("csa_tpu_torch/csrc/band.cu",
                 "csa_tpu/dp/pallas_band.py:63"),
    }
    card = smi_line()
    print(card)
    summary(stats, launches)
    summary_sharded_rotation(sharded_rot)
    summary_distributed(dist_out)
    summary_teardown(dist_out, teardown, card)
    summary_routing(routing)
    summary_fused(fused)
    summary_mbp(mbp_full, mbp5, card)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **stats[name]}
        for name, (src, rep) in meta.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
