"""Run-time configuration of the port (its own copy of
:mod:`csa_tpu.config`).

:class:`RunConfig` holds every value of a run once: the progressive
DP's scoring matrix (:class:`Scoring`), the block-size and interval
bounds, the index engine's k-mer packing width, the rank mesh shape of
``--backend sharded`` and the two gates that decide which gap-DP merges
of the ``device`` route go to the card.  The CLI builds it from its
flags and installs it with :func:`set_run_config`, the one installer;
every phase reads it back with :func:`run_config`.  The host merge
reads the scoring once a call, the native host library gets it pushed
(here, and when the library loads), and the kernels' wrappers take it
as keyword arguments from their callers.
"""

from __future__ import annotations

from dataclasses import dataclass

INT_MAX = 2**31 - 1


@dataclass(frozen=True)
class Scoring:
    """Progressive-DP scoring (dynamicprogramming.c:16-19 defaults)."""

    match: int = 1
    mismatch: int = -1
    indel: int = -1
    doublegap: int = 0

    def as_tuple(self):
        return (self.match, self.mismatch, self.indel, self.doublegap)


@dataclass(frozen=True)
class RunConfig:
    """Every value of a run (the CLI's flags set all but
    ``batch_min_cells``)."""

    scoring: Scoring = Scoring()
    min_block_size: int = 10          # csamsa.c:573
    max_block_size: int = INT_MAX     # csamsa.c:574
    max_interval: int = INT_MAX       # csamsa.c:575
    pack_w: int = 12                  # k-mer packing width of the index
    mesh_shape: tuple | None = None   # (seq, pos) ranks, --backend sharded
    # gap-DP gates of the device route, at the crossovers that
    # chip_smoke.py's phase `routing` measured against the native host
    # fill on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 5):
    # a merge that goes alone (one profile_path launch with its upload
    # and download against the native fill; a Primates merge), and a
    # round's batch (one batched launch against the host fills in turn;
    # 8 merges of 512 x 512)
    device_min_cells: int = 2_893_397
    batch_min_cells: int = 2_097_152


_run_config = RunConfig()


def run_config() -> RunConfig:
    return _run_config


def set_run_config(cfg: RunConfig) -> None:
    """Install a run's config; its scoring matrix also goes into the
    native host library when it is loaded."""
    global _run_config
    _run_config = cfg
    from . import native

    native.push_scoring(cfg.scoring)
