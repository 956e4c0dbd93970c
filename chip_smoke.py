#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (csa_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each on stdout:
  1. toolchain: torch, CUDA, nvcc, triton, the card (nvidia-smi);
  2. build:     both kernels from csa_tpu_torch/csrc with nvcc (sm_90a);
  3. mscan:     kernel against torch.cummax, every option, at the
                collect cascade's shapes (Primates, 8 x 1 Mbp);
  4. profile:   the profile-DP kernel's paths against the plain version's
                (ragged stale batch, non-default scoring, i = 64, R or
                C = 1, 8 x 8192^2, one 17k x 28k gap);
  5. pipeline:  the port's CLI, full pipeline, on Primates and Set3, with
                rotated and aligned output against the fixtures, the
                integrity check and both kernels' launch counts (zeroed
                just before, read just after);
  6. mbp:       rotation mode on 8 x 1 Mbp (seed 7) against the native
                host engine on the same machine.
Then the card's name and power limit, a JSON line with one entry per
kernel, and the last line {"ok": true, "device": {...}}.  Any failed
phase raises: the exit code is non-zero and the last line is not
printed.  Without a CUDA device it exits 2 before printing anything.
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


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
    emit({"phase": "toolchain", "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": ver[-1], "triton": triton_ver,
          "nvidia_smi": smi_line(),
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "native_host_engine": native.available()})


def phase_build(kernels):
    t0 = time.perf_counter()
    lib = kernels.build(force=True)
    kernels.load()
    emit({"phase": "build", "library": str(lib.relative_to(ROOT)),
          "sources": [str(p.relative_to(ROOT)) for p in kernels.sources()],
          "seconds": round(time.perf_counter() - t0, 3)})


def phase_mscan(mscan, stats):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for n in (278_528, 8_003_584):
        for cummin in (False, True):
            for reverse in (False, True):
                for reduce in (False, True):
                    cases.append((12, n, cummin, reverse, reduce))
    cases.append((8, 8_003_584, False, False, True))
    worst = 0
    for M, N, cummin, reverse, reduce in cases:
        x = torch.randint(-(2**30), 2**30, (M, N), generator=gen,
                          device="cuda", dtype=torch.int32)
        if cummin:
            kern = lambda: mscan.multi_cummin(  # noqa: E731
                x, reverse=reverse, max_over_channels=reduce)
            plain = lambda: -mscan.multi_cummax_plain(  # noqa: E731
                -x, reverse=reverse, min_over_channels=reduce)
        else:
            kern = lambda: mscan.multi_cummax(  # noqa: E731
                x, reverse=reverse, min_over_channels=reduce)
            plain = lambda: mscan.multi_cummax_plain(  # noqa: E731
                x, reverse=reverse, min_over_channels=reduce)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, want),
              f"mscan differs M={M} N={N} cummin={cummin} "
              f"reverse={reverse} reduce={reduce}")
        ms, pms = cuda_ms(kern, 5), cuda_ms(plain, 5)
        emit({"phase": "mscan", "M": M, "N": N, "cummin": cummin,
              "reverse": reverse, "reduce": reduce, "equal": True,
              "ms": round(ms, 4), "plain_ms": round(pms, 4)})
        if (M, N, cummin, reverse, reduce) == (12, 278_528, False, False,
                                                False):
            stats["mscan"].update(ms=ms, plain_ms=pms)
    stats["mscan"]["max_abs_err"] = worst


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


def phase_profile(profile, stats):
    import numpy as np

    rng = np.random.default_rng(5)
    rand = lambda lo, hi, g: [  # noqa: E731
        (int(rng.integers(lo, hi)), int(rng.integers(lo, hi)))
        for _ in range(g)]
    i16 = lambda r: int(r.integers(1, 17))  # noqa: E731
    nd = dict(match=3, mismatch=-2, indel=-4, doublegap=-1)
    cases = [
        ("ragged_stale", rand(1, 3000, 16), i16, True, {}),
        ("non_default_scoring", rand(500, 2500, 4), i16, False, nd),
        ("i64", rand(500, 2000, 4), lambda r: 64, False, {}),
        ("thin", [(1, 5000), (5000, 1), (1, 1)], i16, False, {}),
        ("batch_8x8192", [(8192, 8192)] * 8, i16, False, {}),
        ("giant_17kx28k", [(17_000, 28_000)], i16, True, {}),
    ]
    worst = 0
    for name, shapes, i_of, stale, sc in cases:
        items = _profile_items(np, rng, shapes, i_of, stale, sc)
        cells = sum(R * C for R, C in shapes)
        profile.profile_paths(items, "cuda", **sc)  # warm-up
        want, pms = wall_ms(lambda: profile.profile_paths_plain(
            items, "cuda", **sc))
        got, ms = wall_ms(lambda: profile.profile_paths(items, "cuda", **sc))
        for a, b in zip(got, want):
            check(len(a) == len(b) and np.array_equal(a, b),
                  f"profile paths differ in case {name}")
            worst = max(worst, int(np.abs(a.astype(int) - b).max(initial=0)))
        emit({"phase": "profile", "case": name, "gaps": len(items),
              "cells": cells, "equal": True, "ms": round(ms, 3),
              "plain_ms": round(pms, 3),
              "kernel_gcell_per_s": round(cells / ms / 1e6, 4)})
        if name == "batch_8x8192":
            stats["profile_dp"].update(ms=ms, plain_ms=pms)
    stats["profile_dp"]["max_abs_err"] = worst


def _content_rows(path):
    return [l for l in Path(path).read_text().splitlines()
            if not l.startswith(">")]


def phase_pipeline(cli, kernels, tools_files, jcli):
    walls = {}
    kernels.reset_counts()
    for name in ("Primates", "Set3"):
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            (tmp / f"{name}.txt").write_bytes((FIX / f"{name}.txt").read_bytes())
            log = io.StringIO()
            cwd = os.getcwd()
            os.chdir(tmp)
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(log):
                    rc = cli.main([f"{name}.txt"])
                wall = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
            check(rc == 0, f"{name}: port CLI returned {rc}")
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
        walls[name] = wall
    launches = dict(kernels.COUNTS)
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was not launched: {launches}")
    native_walls = {}
    for name in ("Primates", "Set3"):
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            (tmp / f"{name}.txt").write_bytes((FIX / f"{name}.txt").read_bytes())
            cwd = os.getcwd()
            os.chdir(tmp)
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = jcli.main([f"{name}.txt", "--backend", "native"])
                native_walls[name] = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
            check(rc == 0, f"{name}: native CLI returned {rc}")
    emit({"phase": "pipeline", "rotated_identical": True,
          "aligned_rows_identical": True, "integrity": True,
          "launches": launches,
          "port_wall_s": {k: round(v, 3) for k, v in walls.items()},
          "native_host_wall_s": {k: round(v, 3)
                                 for k, v in native_walls.items()}})
    return launches


def _mbp_set(n=1_000_000, k=8, seed=7):
    """8 x 1 Mbp circular set: one random base, rotated and mutated."""
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


def phase_mbp(cli, rot, kernels, fio, jrot):
    import numpy as np

    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src = tmp / "mbp.txt"
        with open(src, "w") as f:
            for i, row in enumerate(_mbp_set()):
                f.write(f">s{i}\n{letters[row].tobytes().decode()}\n")
        cwd = os.getcwd()
        os.chdir(tmp)
        kernels.reset_counts()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["R", "mbp.txt"])
            port_wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        check(rc == 0, f"mbp: port CLI returned {rc}")
        check(kernels.COUNTS["mscan"] > 0, "mbp: mscan was not launched")
        got = [fio.parse_rotated_header(l[1:].strip())[1]
               for l in (tmp / "mbp-Rotated.fasta").read_text().splitlines()
               if l.startswith(">")]
        seqs = fio.load_fasta(str(src), log=io.StringIO())
        t0 = time.perf_counter()
        res = jrot.analyze(seqs, backend="native", log=io.StringIO())
        native_wall = time.perf_counter() - t0
        port, port_analyze_ms = wall_ms(lambda: rot.analyze(
            seqs, device="cuda", log=io.StringIO()))
    check(list(map(int, res.rotations)) == got,
          "mbp: port rotations (CLI) differ from the native engine")
    check(list(map(int, port.rotations)) == got,
          "mbp: port rotations (analyze) differ from the CLI's")
    emit({"phase": "mbp", "sequences": 8, "length": 1_000_000,
          "rotations_equal_native": True,
          "port_cli_R_wall_s": round(port_wall, 3),
          "port_analyze_wall_s": round(port_analyze_ms / 1e3, 3),
          "native_analyze_wall_s": round(native_wall, 3)})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from csa_tpu import cli as jcli  # the native host engine's CLI
    from csa_tpu import native
    from csa_tpu.io import fasta as fio
    from csa_tpu.rotation import pipeline as jrot
    from csa_tpu.tools import files as tools_files
    from csa_tpu_torch import cli, kernels
    from csa_tpu_torch.dp import profile
    from csa_tpu_torch.index import mscan
    from csa_tpu_torch.rotation import pipeline as rot

    stats = {"mscan": {}, "profile_dp": {}}
    phase_toolchain(kernels, native)
    phase_build(kernels)
    phase_mscan(mscan, stats)
    phase_profile(profile, stats)
    launches = phase_pipeline(cli, kernels, tools_files, jcli)
    phase_mbp(cli, rot, kernels, fio, jrot)
    check("jax" not in sys.modules, "jax was imported")

    meta = {
        "mscan": ("csa_tpu_torch/csrc/mscan.cu",
                  "csa_tpu/index/mscan.py:34"),
        "profile_dp": ("csa_tpu_torch/csrc/profile_dp.cu",
                       "csa_tpu/dp/pallas_profile.py:83"),
    }
    print(smi_line())
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": round(stats[name]["ms"], 4),
         "plain_ms": round(stats[name]["plain_ms"], 4)}
        for name, (src, rep) in meta.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
