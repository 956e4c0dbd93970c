"""Rank-count scaling of the sharded rotation block stage (counterpart of
:mod:`csa_tpu.parallel.scaling`).

:func:`measure` runs the staged block stage
(``engine.rotation_final_staged``, the stage the ranks shard) on a
synthetic circular set at 1, 2, 4 and 8 ranks laid out as the CLI's
``--backend sharded`` lays them: round-robin over the visible cards for
``device="cuda"`` (the default; ranks that share a card get a stream
each), on ``device`` alone for the CPU or an indexed card.  It gives:

* the warm wall of the stage at each rank count and its per-stage walls
  in one profiled run (the ``idx.*`` phases, which end when the
  device's work ends), beside the single-device stage's;
* the bytes the rank exchanges moved in that run (the
  ``rank_exchange_bytes`` and ``rank_peer_copy_bytes`` counters of
  :class:`.sharded.Ranks`), beside the JAX package's analytic model;
* the final blocks and cascade counts at every rank count, which must
  equal the single-device stage's (``AssertionError`` otherwise);
* :func:`.dsort.sharded_argsort` of an array of the stage's size against
  one stable ``torch.sort`` of it, timed;
* the sharded alignment's parity at the largest rank count
  (``profile_paths_sharded`` against ``profile_paths``), and one giant
  merge (Set3's scale by default) through ``dp_path_seqpar`` against
  the port's native host fill.

Ranks that share one card share its SMs: on one card the walls say what
the sharded path costs there, not what a mesh of cards would give.
Sizes are arguments, so a CPU test runs it small.

    python -m csa_tpu_torch.parallel.scaling      # one JSON line, on cuda
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from .. import native
from ..dp import profile, seqpar
from ..index import engine
from ..utils import PROFILER
from . import dsort
from .sharded import make_mesh


def _synthetic_set(k: int, n: int, seed: int):
    """k rotated copies of one random sequence, 0.5 % of each mutated."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    enc = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        idxs = rng.integers(0, n, size=n // 200)
        row[idxs] = rng.integers(0, 4, size=n // 200)
        enc.append(row)
    return enc


def _wall(fn, device):
    """(result, seconds) of ``fn`` with the device drained on both ends."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _blocks(res):
    return (res.num_collected, res.num_after_suffix, res.final_start.tolist(),
            res.final_depth.tolist(), res.final_positions.tolist())


def _profiled(fn):
    """(phases, counters) of one run of ``fn`` under the profiler; the
    process-wide profiler is reset before and after."""
    was = PROFILER.enabled
    PROFILER.reset()
    PROFILER.enabled = True
    try:
        fn()
        return dict(PROFILER.phases), dict(PROFILER.counters)
    finally:
        PROFILER.enabled = was
        PROFILER.reset()


def measure(k: int = 8, n: int = 100_000, ranks=(1, 2, 4, 8), reps: int = 2,
            device="cuda", *, seed: int = 11, giant=(17_408, 28_160),
            pack_w: int = 12):
    """The measurements above, as one JSON-ready dict."""
    device = torch.device(device)
    enc = _synthetic_set(k, n, seed)
    cards = None if device.type == "cuda" and device.index is None \
        else [device]
    meshes = {d: make_mesh(d, (d, 1), devices=cards) for d in ranks}

    def stage(mesh):
        return engine.rotation_final_staged(enc, device, pack_w=pack_w,
                                            mesh=mesh)

    ref = stage(None)   # also the warm-up
    if ref is None:
        raise ValueError("the synthetic set has duplicate rotations")
    single = min(_wall(lambda: stage(None), device)[1] for _ in range(reps))
    single_stages = dict(sorted(_profiled(lambda: stage(None))[0].items()))
    walls, stage_walls, xbytes, peer = {}, {}, {}, {}
    for d, mesh in meshes.items():
        runs = [_wall(lambda: stage(mesh), device) for _ in range(reps + 1)]
        for res, _ in runs:
            if _blocks(res) != _blocks(ref):
                raise AssertionError(
                    f"sharded cascade diverged at {d} ranks: "
                    f"{_blocks(res)[:2]} != {_blocks(ref)[:2]}")
        walls[d] = min(t for _, t in runs[1:])
        phases, counters = _profiled(lambda: stage(mesh))
        stage_walls[d] = dict(sorted(phases.items()))
        xbytes[d] = int(counters.get("rank_exchange_bytes", 0))
        peer[d] = int(counters.get("rank_peer_copy_bytes", 0))

    n_max = engine._bucket(n)
    N = k * n_max
    x = np.random.default_rng(0).integers(0, 1 << 28, size=N,
                                          dtype=np.int32)
    xt = torch.from_numpy(x).to(device)
    (_, want), sort_s = _wall(lambda: torch.sort(xt, stable=True), device)
    argsort_walls, argsort_exact = {}, True
    for d, mesh in meshes.items():
        dsort.sharded_argsort(xt, mesh)
        (_, order), argsort_walls[d] = _wall(
            lambda: dsort.sharded_argsort(xt, mesh), device)
        argsort_exact &= bool(torch.equal(order, want))

    full = meshes[max(ranks)]
    rng = np.random.default_rng(5)
    items = []
    for _ in range(11):
        R, C, i = (int(v) for v in (rng.integers(20, 200),
                                    rng.integers(20, 200),
                                    rng.integers(1, 5)))
        sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
        items.append((rng.integers(0, 4, size=R).astype(np.int8), sv, i,
                      profile.default_top_row(sv, i, indel=-1, doublegap=0),
                      -i))
    align_parity = all(
        np.array_equal(a, b) for a, b in zip(
            profile.profile_paths(items, device),
            profile.profile_paths_sharded(items, full)))

    rngg = np.random.default_rng(21)
    Rg, Cg = giant
    ig = 9
    gcodes = rngg.integers(0, 4, size=Rg).astype(np.int8)
    gsv = rngg.integers(0, 3, size=(Cg, 5)).astype(np.int64)
    gtop = profile.default_top_row(gsv, ig, indel=-1, doublegap=0)

    def giant_path():
        return seqpar.dp_path_seqpar(gcodes, gsv, ig, full, top_row=gtop,
                                     edge_rowgap=-ig)

    giant_path()
    gpath, giant_s = _wall(giant_path, device)
    host = native.dp_fill_path(gcodes, gsv, ig, gtop, -ig)

    # JAX's analytic model (csa_tpu/parallel/scaling.py): bytes each
    # device's sort ladder touches (three int32 operands a level) and the
    # explicit merge's collectives
    levels = 1
    while (pack_w << (levels - 1)) < n_max:
        levels += 1
    cap = 4096
    model = {
        "per_device_sort_bytes": {d: int(levels * 3 * 4 * N / d)
                                  for d in ranks},
        "collective_bytes_per_merge": {d: int(4 * cap + 4 * cap * k // d)
                                       for d in ranks},
    }
    return {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "device_count": (torch.cuda.device_count()
                         if device.type == "cuda" else 0),
        "cards_in_mesh": len(set(meshes[max(ranks)].devices)),
        "workload": f"{k} x {n} bp synthetic (seed {seed}, 0.5% mutated)",
        "rotations": N,
        "single_device_wall_s": single,
        "single_device_stage_walls_s": single_stages,
        "walls_s": walls,
        "stage_walls_s": stage_walls,
        "exchange_bytes": xbytes,
        "peer_copy_bytes": peer,
        "cascade": {"num_collected": ref.num_collected,
                    "num_after_suffix": ref.num_after_suffix,
                    "num_final": len(ref.final_start)},
        "cascade_parity_across_ranks": True,
        "argsort": {"n": N, "torch_sort_s": sort_s,
                    "sharded_walls_s": argsort_walls,
                    "exact_vs_stable_sort": argsort_exact},
        "sharded_alignment_parity": align_parity,
        "giant_merge_seqpar": {
            "shape": f"{Rg}x{Cg}", "ranks": full.size, "wall_s": giant_s,
            "path_identical_to_native": (None if host is None
                                         else bool(np.array_equal(gpath,
                                                                  host[1])))},
        "jax_model": model,
    }


def main():
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
