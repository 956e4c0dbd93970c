"""The benchmark's plain reference: the port's host engines on their
exact numpy route, frozen here so that later changes to the program
cannot move the yardstick.  It imports nothing of the program, of
``jax`` or of the JAX package (``perfbench/tests/test_isolation.py``);
:func:`.pipeline.run` works every output of a job out again from the
input file.
"""
