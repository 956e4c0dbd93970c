"""Run-time configuration of the port (its own copy of
:mod:`csa_tpu.config`, without the JAX package's DP-gate fields).

* :class:`Scoring` is the progressive-DP scoring matrix.  The host merge
  and DeleteGappedColumns read it through module globals of
  :mod:`csa_tpu_torch.align.progressive` and the native host library;
  :func:`set_scoring` installs it into both.  The device fills take it
  as keyword arguments (:func:`from_jax_config`, :func:`scoring_kwargs`),
  and ``progressive_dp_batched`` raises when the two disagree.
* :class:`RunConfig` holds the pipeline-level knobs: block-size and
  interval bounds, the index engine's k-mer packing width and the rank
  mesh shape of ``--backend sharded``.

:func:`from_jax_config` turns any object with the same attributes (the
port's :class:`RunConfig`, or the JAX package's) into the scalar keyword
arguments the port's functions take; it imports nothing of the JAX
package.
"""

from __future__ import annotations

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


DEFAULT_SCORING = Scoring()
_scoring = DEFAULT_SCORING


def set_run_config(cfg: RunConfig) -> None:
    """Install a run's scoring matrix into the host DP code (the other
    fields reach the port's functions as arguments)."""
    if cfg.scoring != scoring():
        set_scoring(cfg.scoring)


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
