"""csa_tpu_torch: the PyTorch/CUDA port of csa_tpu."""

__version__ = "0.1.0"
