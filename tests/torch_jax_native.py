"""Make the JAX package's native host library ready in this process.

``csa_tpu.native`` builds ``libcsa_host.so`` in place with ``make -B`` and
no lock whenever the file is absent or older than its source, and it
remembers a failed load for the life of the process.  Several test
workers that start together can therefore rewrite the file under one
another, and a worker that loads a half-written file keeps ``None`` for
good: its tests of the library then skip or fail.

:func:`ensure` repairs that from the outside.  It takes an inter-process
lock, and under it clears the remembered failure and asks again; by then
at most one process is building, and the next one finds a fresh library
and only loads it.  The port's test files that reach ``csa_tpu.native``
(directly, or through a JAX function that does) call it while they are
imported.  Test workers import every test file before they run any test,
so each worker holds a loaded library from then on.

Not a test file; only tests import it.
"""

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

from csa_tpu import native

_ATTEMPTS = 5


def _lock_path() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tag = hashlib.sha256(repo.encode()).hexdigest()[:16]
    return os.path.join(tempfile.gettempdir(), f"csa_jax_native_{tag}.lock")


def ensure() -> bool:
    """True when ``csa_tpu.native`` holds a loaded library.  Raises if it
    cannot be had although ``make`` and a C++ compiler exist; returns
    False where there is no toolchain (the library's tests then skip)."""
    if native._lib is not None:
        return True
    with open(_lock_path(), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        # a process that has not reached this lock yet may still be
        # building unlocked: give its write a moment to end
        for attempt in range(_ATTEMPTS):
            native._tried = False
            if native.available():
                return True
            time.sleep(0.5 * (attempt + 1))
        cxx = os.environ.get("CXX", "g++")
        if shutil.which("make") is None or shutil.which(cxx) is None:
            return False
        proc = subprocess.run(["make", "-B", "-C", native._HERE],
                              capture_output=True, text=True)
        raise RuntimeError(
            f"csa_tpu.native: {native._LIB_PATH} is not loadable after "
            f"{_ATTEMPTS} attempts under the lock; make returned "
            f"{proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
