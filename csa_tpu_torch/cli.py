"""Command-line driver of the PyTorch/CUDA port (counterpart of
:mod:`csa_tpu.cli`).

========  ==========================================================
mode      behavior
========  ==========================================================
(none)    Rotate + Align + Images (full pipeline)
R         Rotation only -> ``<base>-Rotated.fasta`` + block artifacts
A         Alignment only (rotations = 0) -> ``<base>-Aligned.fasta``
I         Circular alignment plot only
C         Clean/normalize a FASTA file -> ``Clean-<file>``
S         Sum-of-pairs score + stats of an alignment
M         Convert aligned FASTA -> MSF
========  ==========================================================

Modes N, R and A run on the route ``--backend`` names (default
``device``, or ``CSA_TPU_BACKEND``), the routes of ``csa_tpu`` with
``device`` in the place of ``jax``:

* ``device``: the rotation block stage, the anchors' suffix sort and
  the gap DP on ``--device`` (default ``cuda``).  The gap DP's small
  work stays on the native host library behind two gates, measured on
  the H100 (:mod:`csa_tpu_torch.config`): a merge below
  ``--device-min-cells`` cells (``CSA_TPU_DEVICE_MIN_CELLS``), a
  round's batch below ``CSA_TPU_BATCH_MIN_CELLS`` cells.
* ``native``: every stage on the port's native host library (its numpy
  twins where it is missing); ``numpy``: the exact numpy engines.
  Neither makes a CUDA call.
* ``auto``: rotation by size (``device`` at or above
  ``rotation.pipeline.AUTO_DEVICE_MIN_CHARS`` characters,
  ``CSA_TPU_AUTO_DEVICE_MIN``; ``native`` below), alignment on the host
  (``native`` when the library is built, else ``numpy``).
* ``sharded``: the rotation block stage (modes N and R) and the
  alignment's gap DP (modes N and A) over a mesh of ``--mesh SEQxPOS``
  ranks (default: one per visible card) laid out on ``--device``'s
  type, several ranks to a card when there are more ranks than cards.
  Rotation takes the sharded index build and collect front on a
  power-of-two rank count, and the single-device stage on the mesh's
  first rank on any other; the output is the same.

Every route writes the same output.  A route that runs on the card looks
for it when it starts; without one, ``--device cuda`` exits non-zero
(``auto`` too, when it resolves to ``device``): the CPU runs only when
asked for with ``--device cpu``.  I, C, S and M are host tools.
``--coordinator HOST:PORT``, ``--num-processes N`` and ``--process-id
p`` (or the ``CSA_TPU_*`` variables ``csa_tpu`` reads) run modes N, R
and A as one of N processes (:mod:`csa_tpu_torch.parallel.distributed`):
the mesh of ``--backend sharded`` then spans the ranks of every
process, each process runs the whole CLI on its own copy of the input
and writes its own output next to it, and every process's output is
the single-process run's.
``--verify-rotations`` (modes N and R) scores each chosen rotation
against sampled alternatives with the pairwise NW kernel on
``--device`` (:mod:`csa_tpu_torch.rotation.verification`), whatever
the route.
``CSA_TPU_TORCH_TRACE=<dir>`` wraps the run in ``torch.profiler`` and
writes ``<dir>/trace.json``.

    python -m csa_tpu_torch.cli Primates.txt
    python -m csa_tpu_torch.cli R Primates.txt --backend native
    python -m csa_tpu_torch.cli R Primates.txt --device cuda --verify-rotations
    python -m csa_tpu_torch.cli Set3.txt --backend sharded --mesh 8x1
    python -m csa_tpu_torch.cli Set3.txt --backend sharded --mesh 8x1 \
        --coordinator host0:8476 --num-processes 2 --process-id 0
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import __version__
from .config import from_jax_config, scoring_kwargs
from .console import banner
from .io import fasta as fio
from .rotation.chains import INT_MAX

POSITIONS_SUFFIX = "-positions.txt"
IMAGEMAP_SUFFIX = "-imagemap.txt"
ROTATIONS_SUFFIX = "-Rotated.fasta"
ALIGNMENT_SUFFIX = "-Aligned.fasta"
BLOCKSINFO_SUFFIX = "-Blocks.csv"
BLOCKSIMAGE_SUFFIX = "-Blocks.bmp"
CIRCULARIMAGE_SUFFIX = "-CircularAlignment.bmp"


def output_filename(inputfilename: str, extra: str) -> str:
    """Join the input file's basename with a suffix (csamsa.c:44-58)."""
    base, dot, _ = inputfilename.rpartition(".")
    if not dot:
        base = inputfilename
    return base + extra


def _load(args) -> fio.SequenceSet:
    print(f"> Loading sequences from file <{args.input}> ... ", end="")
    try:
        size = os.path.getsize(args.input)
    except OSError:
        print()
        raise SystemExit("\n> ERROR: Sequence file not found")
    print(f"({size} bytes)")
    try:
        seqs = fio.load_fasta(args.input, log=sys.stdout)
    except fio.FastaError as e:
        raise SystemExit(f"\n> ERROR: {e}")
    print(f"> {len(seqs)} sequences successfully loaded")
    fio.discard_duplicate_rotations(seqs, log=sys.stdout)
    return seqs


DEVICE_ROUTES = ("device", "sharded")


def _device(args):
    """``--device`` as a torch device, looked for the first time a route
    needs it: a CUDA device that is not there exits non-zero."""
    import torch

    if isinstance(args.device, torch.device):
        return args.device
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "> ERROR: --device cuda but no CUDA device is available "
            "(use --device cpu to run the plain PyTorch versions on the CPU)"
        )
    if dev.type not in ("cpu", "cuda"):
        raise SystemExit(f"> ERROR: unsupported --device {args.device}")
    args.device = dev
    return dev


def _resolve_host_backend(backend: str) -> str:
    """``auto`` for the alignment phase: the native host library when it
    is built, else numpy (csa_tpu/cli.py:108-117); rotation resolves
    ``auto`` by size in ``rotation.pipeline``."""
    if backend != "auto":
        return backend
    from . import native

    return "native" if native.available() else "numpy"


def run_rotation(args, seqs: fio.SequenceSet):
    from .report import blocks_report
    from .rotation import pipeline as rot
    from .utils import PROFILER

    t0 = time.time()
    backend = args.backend
    if backend == "auto":
        backend = rot.resolve_auto_backend(int(sum(seqs.sizes)))
    device = _device(args) if backend in DEVICE_ROUTES else None
    try:
        res = rot.analyze(seqs, device=device, backend=backend,
                          pack_w=args.kw["pack_w"],
                          max_interval=args.kw["max_interval"],
                          log=sys.stdout, mesh=args.rank_mesh)
    except rot.RotationError as e:
        raise SystemExit(f"\n> ERROR: {e}")
    if args.verify_rotations:
        from .rotation import verification

        with PROFILER.phase("rot.device_verify"):
            verification.verify_rotations(
                seqs.encoded_all(), res.rotations, device=_device(args),
                log=sys.stdout,
            )
    with PROFILER.phase("rot.artifacts"):
        fio.save_rotated(seqs, res.rotations,
                         output_filename(args.input, ROTATIONS_SUFFIX))
        blocks_report.write_blocks_artifacts(
            args.input, seqs, res,
            min_block_size=args.kw["min_block_size"],
            max_block_size=args.kw["max_block_size"],
        )
    if args.profile:
        print(f"> [profile] rotation phase: {time.time() - t0:.3f}s "
              f"(backend={backend}, device={args.device})")
    return res


def _parse_mesh(text: str):
    """``4x2`` -> (4, 2): (seq, pos) rank-mesh axes."""
    try:
        seq, _, pos = text.lower().partition("x")
        shape = (int(seq), int(pos))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"mesh must look like SEQxPOS (e.g. 4x2), got {text!r}"
        )
    if shape[0] < 1 or shape[1] < 1:
        raise argparse.ArgumentTypeError("mesh axes must be >= 1")
    return shape


def _mesh(args):
    """The rank mesh of ``--backend sharded`` on ``--device``'s type."""
    if args.backend != "sharded":
        return None
    from .parallel.sharded import make_mesh

    devices = [args.device] if args.device.type == "cpu" else None
    try:
        return make_mesh(shape=args.kw["mesh_shape"], devices=devices)
    except ValueError as e:
        raise SystemExit(f"> ERROR: {e}")


def run_alignment(args, seqs: fio.SequenceSet, rotations) -> str:
    from .align import msa
    from .tools import files as tools_files

    alignfile = output_filename(args.input, ALIGNMENT_SUFFIX)
    print("> Running multiple sequence alignment...")
    backend = _resolve_host_backend(args.backend)
    device = _device(args) if backend in DEVICE_ROUTES else None
    result = msa.align(seqs, rotations, device=device, mesh=args.rank_mesh,
                       backend=backend, **scoring_kwargs(args.kw))
    msa.save_alignment(seqs, rotations, result, alignfile)
    rotfile = output_filename(args.input, ROTATIONS_SUFFIX)
    source = rotfile if os.path.exists(rotfile) else args.input
    tools_files.test_alignment_output(source, alignfile)
    return alignfile


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="csa-tpu-torch",
        description="Multiple circular sequence aligner (PyTorch/CUDA)",
    )
    parser.add_argument("mode", nargs="?", default=None,
                        help="R|A|I|C|S|M (omit for full pipeline)")
    parser.add_argument("input", nargs="?", default=None,
                        help="multi-FASTA file")
    parser.add_argument("--device", default="cuda",
                        help="torch device for modes N/R/A (default cuda)")
    backends = ["auto", "numpy", "native", "device", "sharded"]
    env_backend = os.environ.get("CSA_TPU_BACKEND", "device")
    # csa_tpu's `jax` route is the port's `device`
    env_backend = {"jax": "device"}.get(env_backend, env_backend)
    parser.add_argument("--backend", choices=backends, default=env_backend,
                        help="device: one device (default, or "
                             "CSA_TPU_BACKEND); native / numpy: the host "
                             "engines, no CUDA call; auto: rotation by "
                             "size, alignment on the host; sharded: the "
                             "rotation block stage and the alignment's gap "
                             "DP over a mesh of ranks on --device's type")
    parser.add_argument("--mesh", type=_parse_mesh, default=None,
                        metavar="SEQxPOS",
                        help="rank mesh of --backend sharded, e.g. 8x1 "
                             "(default: one rank per visible card); ranks "
                             "may share a card")
    parser.add_argument("--min-block-size", type=int, default=10)
    parser.add_argument("--max-block-size", type=int, default=INT_MAX)
    parser.add_argument("--max-interval", type=int, default=INT_MAX)
    parser.add_argument("--match", type=int, default=1,
                        help="DP match score (default 1)")
    parser.add_argument("--mismatch", type=int, default=-1,
                        help="DP mismatch score (default -1)")
    parser.add_argument("--indel", type=int, default=-1,
                        help="DP indel score (default -1)")
    parser.add_argument("--doublegap", type=int, default=0,
                        help="DP gap-over-gap score (default 0)")
    parser.add_argument("--pack-w", type=int, default=None, metavar="W",
                        choices=range(2, 14),
                        help="k-mer packing width of the index engine "
                             "(2..13, default 12)")
    parser.add_argument("--device-min-cells", type=int, default=None,
                        metavar="N",
                        help="per-merge gap-DP cell count from which the "
                             "device route launches the kernel (below it "
                             "the native host fill runs)")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="multi-process launch: the coordinator's "
                             "address (the same on every process)")
    parser.add_argument("--num-processes", type=int, default=None,
                        metavar="N", help="multi-process launch: process "
                                          "count")
    parser.add_argument("--process-id", type=int, default=None,
                        metavar="I", help="multi-process launch: this "
                                          "process's 0-based index")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--verify-rotations", action="store_true",
                        help="score chosen vs alternative rotations with "
                             "the pairwise NW kernel on --device (oracle)")
    parser.add_argument("--version", action="version",
                        version=f"csa-tpu-torch {__version__}")
    args = parser.parse_args(argv)
    if args.backend not in backends:
        parser.error(f"CSA_TPU_BACKEND={env_backend!r} is not one of "
                     f"{', '.join(backends)}")

    from . import config

    defaults = config.RunConfig()
    cfg = config.RunConfig(
        scoring=config.Scoring(match=args.match, mismatch=args.mismatch,
                               indel=args.indel, doublegap=args.doublegap),
        min_block_size=args.min_block_size,
        max_block_size=args.max_block_size,
        max_interval=args.max_interval,
        pack_w=args.pack_w if args.pack_w is not None else defaults.pack_w,
        mesh_shape=args.mesh,
        device_min_cells=(args.device_min_cells
                          if args.device_min_cells is not None
                          else defaults.device_min_cells),
    )
    # the host code (merge, DGC, native kernels) reads the installed
    # config; the device code takes its scalars
    config.set_run_config(cfg)
    args.kw = from_jax_config(cfg)

    print(banner("[ csa-tpu-torch: Multiple Circular Sequence Aligner ]"))

    from .utils import PROFILER

    PROFILER.enabled = bool(args.profile)

    # reference argument convention: one arg = full pipeline on that
    # file; two args = mode char + file (csamsa.c:539-547)
    mode = "N"
    if args.input is None and args.mode is not None:
        args.input = args.mode
    elif args.mode is not None:
        mode = args.mode.upper()
        if mode not in ("R", "A", "I", "C", "S", "M"):
            mode = ""
    if not args.input or not mode:
        parser.print_help()
        return 0
    from .parallel import distributed

    try:
        rc = _run(args, mode)
    except BaseException:
        distributed.shutdown(wait=False)
        raise
    distributed.shutdown()
    return rc


def _run(args, mode: str) -> int:
    from .parallel import distributed
    from .utils import PROFILER, torch_trace

    if mode in ("N", "R", "A"):
        # a device route looks for the card now; auto when it resolves
        # to one, and --verify-rotations when it starts
        on_device = args.backend in DEVICE_ROUTES
        # the world first: the mesh spans it
        multi = distributed.initialize(
            args.coordinator, args.num_processes, args.process_id,
            device=_device(args) if on_device else "cpu")
        args.rank_mesh = _mesh(args)
        if multi:
            world = distributed.current()
            ranks = (args.rank_mesh.size if args.rank_mesh is not None
                     else world.size)
            print(f"> Multi-host runtime: process {world.rank}/{world.size}"
                  f", {ranks} global ranks, backend {world.backend}")

    with torch_trace(os.environ.get("CSA_TPU_TORCH_TRACE")):
        if mode in ("N", "R", "A"):
            with PROFILER.phase("io.load_fasta"):
                seqs = _load(args)

        res = None
        if mode in ("N", "R"):
            print("> Building generalized cyclic suffix index...")
            res = run_rotation(args, seqs)

        alignfile = None
        if mode in ("N", "A"):
            import numpy as np

            rotations = (res.rotations if res is not None
                         else np.zeros(len(seqs), dtype=np.int64))
            with PROFILER.phase("align.total"):
                alignfile = run_alignment(args, seqs, rotations)

        if mode in ("N", "I"):
            from .report import circular_plot

            source = alignfile if alignfile else args.input
            out = output_filename(args.input, CIRCULARIMAGE_SUFFIX)
            with PROFILER.phase("report.circular_plot"):
                circular_plot.draw_circular_alignment_plot(source, out)

    if mode in ("C", "S", "M"):
        from .tools import files as tools_files

        {"C": tools_files.clean_fasta, "S": tools_files.sum_of_pairs_score,
         "M": tools_files.fasta_to_msf}[mode](args.input)

    if args.profile:
        PROFILER.report(sys.stdout)
    print("> Done!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
