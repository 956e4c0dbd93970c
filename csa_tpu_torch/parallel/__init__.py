"""Rank meshes of the port (counterpart of :mod:`csa_tpu.parallel`)."""
