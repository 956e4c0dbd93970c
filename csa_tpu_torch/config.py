"""Run-time configuration of the port (its own copy of
:mod:`csa_tpu.config`).

* :class:`Scoring` is the progressive-DP scoring matrix.  The host merge
  and DeleteGappedColumns read it through module globals of
  :mod:`csa_tpu_torch.align.progressive` and the native host library;
  :func:`set_scoring` installs it into both.  The device fills take it
  as keyword arguments (:func:`from_jax_config`, :func:`scoring_kwargs`),
  and ``progressive_dp_batched`` raises when the two disagree.
* :class:`RunConfig` holds the pipeline-level knobs: block-size and
  interval bounds, the index engine's k-mer packing width, the rank
  mesh shape of ``--backend sharded`` and the two gates that decide
  which gap-DP merges of the ``device`` route go to the card
  (:func:`device_min_cells`, :func:`batch_device_min_cells`; the
  ``CSA_TPU_DEVICE_MIN_CELLS`` and ``CSA_TPU_BATCH_MIN_CELLS``
  variables override them, as in ``csa_tpu``).

:func:`from_jax_config` turns any object with the same attributes (the
port's :class:`RunConfig`, or the JAX package's) into the scalar keyword
arguments the port's functions take; it imports nothing of the JAX
package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

INT_MAX = 2**31 - 1

SCORING_KEYS = ("match", "mismatch", "indel", "doublegap")


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
    """Pipeline-level knobs (CLI flags map 1:1 onto these fields)."""

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


DEFAULT_SCORING = Scoring()
_scoring = DEFAULT_SCORING
_run_config = RunConfig()


def run_config() -> RunConfig:
    return _run_config


def set_run_config(cfg: RunConfig) -> None:
    """Install a run's config: its scoring matrix goes into the host DP
    code, its gates into :func:`device_min_cells` and
    :func:`batch_device_min_cells` (the other fields reach the port's
    functions as arguments)."""
    global _run_config
    _run_config = cfg
    if cfg.scoring != scoring():
        set_scoring(cfg.scoring)


def device_min_cells() -> int:
    """Per-merge gate: a merge of fewer cells takes the native host fill."""
    env = os.environ.get("CSA_TPU_DEVICE_MIN_CELLS")
    if env:
        return int(env)
    return _run_config.device_min_cells


def batch_device_min_cells() -> int:
    """Per-round gate: a round's batch of fewer cells in all runs merge
    by merge on the host instead of as one launch (no mesh only)."""
    env = os.environ.get("CSA_TPU_BATCH_MIN_CELLS")
    if env:
        return int(env)
    return _run_config.batch_min_cells


def scoring() -> Scoring:
    return _scoring


def set_scoring(s: Scoring) -> None:
    """Install a scoring matrix into the port's host DP code: rebind the
    module globals of :mod:`csa_tpu_torch.align.progressive` and push the
    values into the port's native host library when it is built."""
    global _scoring
    _scoring = s
    from .align import progressive

    progressive.MATCH = s.match
    progressive.MISMATCH = s.mismatch
    progressive.INDEL = s.indel
    progressive.DOUBLEGAP = s.doublegap
    from . import native

    native.push_scoring(s)


def from_jax_config(cfg) -> dict:
    """Scalar kwargs of a run configuration (the port's :class:`RunConfig`
    or any object with the same attributes)."""
    sc = cfg.scoring
    return {
        "match": int(sc.match),
        "mismatch": int(sc.mismatch),
        "indel": int(sc.indel),
        "doublegap": int(sc.doublegap),
        "pack_w": int(cfg.pack_w),
        "max_interval": int(cfg.max_interval),
        "min_block_size": int(cfg.min_block_size),
        "max_block_size": int(cfg.max_block_size),
        "mesh_shape": (tuple(int(n) for n in cfg.mesh_shape)
                       if cfg.mesh_shape else None),
    }


def scoring_kwargs(kw: dict) -> dict:
    """The DP scoring subset of :func:`from_jax_config`'s dict."""
    return {k: kw[k] for k in SCORING_KEYS}
