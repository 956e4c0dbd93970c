"""csa_tpu_torch: the PyTorch/CUDA port of csa_tpu."""

import time as _time

# the start of the span ``startup.imports`` of a CLI process
IMPORTED_NS = _time.perf_counter_ns()

__version__ = "0.1.0"
