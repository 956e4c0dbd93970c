"""The port's view of the run configuration.

The system has no learned parameters; its state is the JAX package's
:class:`csa_tpu.config.RunConfig` (scoring, k-mer packing width, block
and interval bounds).  The port reads that same object, so both packages
run one configuration: :func:`from_jax_config` turns it into the scalar
keyword arguments the port's functions take.
"""

from __future__ import annotations

from csa_tpu.config import RunConfig

SCORING_KEYS = ("match", "mismatch", "indel", "doublegap")


def from_jax_config(cfg: RunConfig) -> dict:
    """Scalar kwargs of a :class:`csa_tpu.config.RunConfig`."""
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
    }


def scoring_kwargs(kw: dict) -> dict:
    """The DP scoring subset of :func:`from_jax_config`'s dict."""
    return {k: kw[k] for k in SCORING_KEYS}
