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
``device``), the routes of ``csa_tpu`` with ``device`` in the place of
``jax``; :func:`resolve_routes` turns it, once a job, into the route of
the rotation and of the alignment phase:

* ``device``: the rotation block stage, the anchors' suffix sort and
  the gap DP on ``--device`` (default ``cuda``).  The gap DP's small
  work stays on the native host library behind two gates, measured on
  the H100 (:class:`csa_tpu_torch.config.RunConfig`): a merge below
  ``--device-min-cells`` cells, a round's batch below
  ``RunConfig.batch_min_cells`` cells.
* ``native``: every stage on the port's native host library (its numpy
  twins where it is missing); ``numpy``: the exact numpy engines.
  Neither makes a CUDA call.
* ``auto``: rotation by size (``device`` at or above
  :data:`AUTO_DEVICE_MIN_CHARS` characters, ``native`` below),
  alignment on the ``native`` route.
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
``--profile`` records each phase of the run as a span in memory (name,
start, end, parent phase, job) and prints, after the run, every phase's
total and self time (without its child phases), a ``TOTAL`` of the
root phases and the counters (DP cells, device dispatches,
``idx.device_reads``: the host's reads of device values in the rotation
block stage).  The root phase is ``cli.main``, the whole call of
:func:`main`; a process started as the CLI (``python -m
csa_tpu_torch.cli``, the ``csa-tpu-torch`` script, as the web frontend
starts one a job) also shows its start-up: ``startup.imports`` (from the
package's import to :func:`main`, ``import torch`` included),
``startup.cuda_context``, ``startup.kernel_library`` and
``startup.host_library`` (the first load of each library).  What a
process spends outside those (its spawn, the interpreter's start and
exit) is its wall minus ``startup.imports`` and ``cli.main``.  Without
``--profile`` a phase costs one attribute check.
``CSA_TPU_TORCH_TRACE=<dir>`` wraps the run in ``torch.profiler`` and
writes ``<dir>/trace.json``; with ``--profile`` it holds every phase on
the device events' clock, start-up and ``cli.main`` included (``cat:
"csa_span"``, the job and the parent's name in ``args``).

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

from . import __version__, config
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


# `auto` crossover: from this many characters in all (8 x 500 kbp) the
# fresh-process R wall of the device route beats the native route's,
# measured by chip_smoke.py's phase `routing` on an NVIDIA H100 80GB
# HBM3, 700.00 W (PERF.md section 5)
AUTO_DEVICE_MIN_CHARS = 4_000_000
# the CUDA devices whose context this process has made (it lives as long
# as the process)
_CUDA_CONTEXTS = set()


def resolve_routes(backend: str, total_chars: int) -> tuple[str, str, bool]:
    """``--backend`` for a job of ``total_chars`` characters as
    ``(rotation route, alignment route, sharded)``: a route is
    ``device``, ``native`` or ``numpy``, and ``sharded`` runs the device
    routes over the rank mesh.  ``auto`` rotates on the native route
    below :data:`AUTO_DEVICE_MIN_CHARS` characters and on the device
    from there, and aligns on the native route.  It does not look for a
    card: a device route without one fails as ``--backend device``
    does."""
    if backend == "auto":
        rotation = ("native" if total_chars < AUTO_DEVICE_MIN_CHARS
                    else "device")
        return rotation, "native", False
    if backend == "sharded":
        return "device", "device", True
    return backend, backend, False


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
    if dev.type == "cuda" and not _CUDA_CONTEXTS:
        from .utils import PROFILER

        # the primary context, made here and not inside the first
        # device phase, so that start-up shows it on its own
        with PROFILER.startup_phase("startup.cuda_context"):
            torch.cuda.synchronize(dev)
        _CUDA_CONTEXTS.add(dev)
    args.device = dev
    return dev


def run_rotation(args, seqs: fio.SequenceSet, route: str):
    from .report import blocks_report
    from .rotation import pipeline as rot
    from .utils import PROFILER

    cfg = config.run_config()
    device = _device(args) if route == "device" else None
    try:
        res = rot.analyze(seqs, device=device, backend=route,
                          pack_w=cfg.pack_w, max_interval=cfg.max_interval,
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
        with PROFILER.phase("rot.artifacts.fasta"):
            fio.save_rotated(seqs, res.rotations,
                             output_filename(args.input, ROTATIONS_SUFFIX))
        with PROFILER.phase("rot.artifacts.blocks"):
            blocks_report.write_blocks_artifacts(
                args.input, seqs, res,
                min_block_size=cfg.min_block_size,
                max_block_size=cfg.max_block_size,
            )
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


def _mesh(device):
    """The rank mesh of ``--backend sharded`` on ``device``'s type."""
    from .parallel.sharded import make_mesh

    devices = [device] if device.type == "cpu" else None
    try:
        return make_mesh(shape=config.run_config().mesh_shape,
                         devices=devices)
    except ValueError as e:
        raise SystemExit(f"> ERROR: {e}")


def run_alignment(args, seqs: fio.SequenceSet, rotations, route: str) -> str:
    import numpy as np

    from .align import runner
    from .tools import files as tools_files
    from .utils import PROFILER

    alignfile = output_filename(args.input, ALIGNMENT_SUFFIX)
    print("> Running multiple sequence alignment...")
    device = _device(args) if route == "device" else None
    rotated = [np.roll(e, -int(r))
               for e, r in zip(seqs.encoded_all(), rotations)]
    result = runner.run_alignment(rotated, device=device,
                                  mesh=args.rank_mesh, dp_backend=route,
                                  log=sys.stdout)
    with PROFILER.phase("align.save"):
        runner.save_alignment(alignfile, result, rotated, seqs.names,
                              rotations)
    rotfile = output_filename(args.input, ROTATIONS_SUFFIX)
    source = rotfile if os.path.exists(rotfile) else args.input
    with PROFILER.phase("align.check_output"):
        tools_files.test_alignment_output(source, alignfile)
    return alignfile


def console_main() -> int:
    """``python -m csa_tpu_torch.cli`` and the ``csa-tpu-torch`` script:
    :func:`main` as the process's one job, with ``--profile`` spanning
    the process's start-up too (``torch`` is imported before
    :func:`main`, inside ``startup.imports``)."""
    from .utils import PROFILER

    PROFILER.startup = True
    try:
        return main()
    finally:
        PROFILER.startup = False


def main(argv=None) -> int:
    entry = time.perf_counter_ns()
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
    parser.add_argument("--backend", default="device",
                        choices=["auto", "numpy", "native", "device",
                                 "sharded"],
                        help="device: one device (default); native / "
                             "numpy: the host engines, no CUDA call; "
                             "auto: rotation by "
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
    # every phase reads the run's values from the installed config
    config.set_run_config(cfg)

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
    from . import IMPORTED_NS
    from .parallel import distributed
    from .utils import torch_trace

    # the job's root span closes, and the trace is written, before the
    # report prints
    with torch_trace(os.environ.get("CSA_TPU_TORCH_TRACE")), \
            PROFILER.job("cli.main", entry):
        if PROFILER.startup:
            PROFILER.record("startup.imports", IMPORTED_NS, entry)
        try:
            _run(args, mode)
        except BaseException:
            distributed.shutdown(wait=False)
            raise
        distributed.shutdown()
    if args.profile:
        PROFILER.report(sys.stdout)
    print("> Done!")
    return 0


def _run(args, mode: str) -> None:
    from .parallel import distributed
    from .utils import PROFILER

    if mode in ("N", "R", "A"):
        with PROFILER.phase("io.load_fasta"):
            seqs = _load(args)
        rotation, alignment, sharded = resolve_routes(
            args.backend, int(sum(seqs.sizes)))
        # a job that aligns on the card looks for it now (auto's device
        # rotation when it starts); the world first: the mesh spans it
        multi = distributed.initialize(
            args.coordinator, args.num_processes, args.process_id,
            device=_device(args) if alignment == "device" else "cpu")
        args.rank_mesh = _mesh(args.device) if sharded else None
        if multi:
            world = distributed.current()
            ranks = (args.rank_mesh.size if args.rank_mesh is not None
                     else world.size)
            print(f"> Multi-host runtime: process {world.rank}/{world.size}"
                  f", {ranks} global ranks, backend {world.backend}")

    res = None
    if mode in ("N", "R"):
        print("> Building generalized cyclic suffix index...")
        res = run_rotation(args, seqs, rotation)

    alignfile = None
    if mode in ("N", "A"):
        import numpy as np

        rotations = (res.rotations if res is not None
                     else np.zeros(len(seqs), dtype=np.int64))
        with PROFILER.phase("align.total"):
            alignfile = run_alignment(args, seqs, rotations, alignment)

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


if __name__ == "__main__":
    sys.exit(console_main())
