"""Build, load and launch the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and the objects are
linked into ONE shared library with a plain C interface, loaded with
:mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c csrc/<name>.cu -o _build/<name>.<pid>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libcsa_kernels_<hash>.so _build/*.<pid>.o

The library name carries a hash of the sources, the headers they include
(``csrc/*.cuh``) and the flags, so the first call after an edit of any of
them rebuilds it; a stale library is never loaded.
The build happens at first use, never at import, so the CPU-only test
machines can import every module.  A missing ``nvcc`` or a failed build
raises :class:`KernelBuildError`: there is no fallback.

Each C entry launches on the caller's stream (PyTorch's current stream)
and returns ``cudaGetLastError()``; :func:`call` raises
:class:`KernelLaunchError` when it is not 0.

``COUNTS`` holds one launch counter per kernel wrapper; each wrapper adds
one exactly where it calls its C entry, so a run can show which kernels
the main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from ..utils import PROFILER

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

COUNTS = {"mscan": 0, "profile_dp": 0, "nw": 0, "band": 0}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry -> argument types (pointers and the stream are c_void_p)
_SIGNATURES = {
    "csa_mscan": [_VP, _VP, _VP, _I, _LL, _I, _I, _I, _VP],
    "csa_profile_fill": [
        _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _I, _I, _VP,
    ],
    "csa_profile_walk": [_VP, _VP, _I, _I, _I, _I, _VP, _VP, _VP],
    "csa_nw_scores": [_VP, _VP, _I, _I, _I, _I, _I, _VP, _VP, _VP, _VP],
    "csa_band_fill": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _I,
        _I, _I, _I, _VP,
    ],
    "csa_band_walk": [_VP, _LL, _I, _I, _I, _I, _I, _I, _I, _VP, _VP, _VP],
}

_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


class KernelLaunchError(RuntimeError):
    """A C entry reported a CUDA error."""


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    """The headers the sources include (``csrc/*.cuh``)."""
    return sorted(CSRC.glob("*.cuh"))


def _find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcsa_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless a library of the same hash exists."""
    out = library_path()
    if out.exists() and not force:
        return out
    nvcc = _find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "csa_tpu_torch cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    objs = [BUILD_DIR / f"{src.stem}.{pid}.o" for src in sources()]
    tmp = out.with_suffix(f".{pid}.tmp")
    try:
        jobs = []
        for src, obj in zip(sources(), objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        results = []
        for cmd, proc in jobs:
            stdout, stderr = proc.communicate()
            results.append((cmd, proc.returncode, stdout, stderr))
        if all(r[1] == 0 for r in results):
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            results.append((cmd, proc.returncode, proc.stdout, proc.stderr))
        for cmd, rc, stdout, stderr in results:
            if rc != 0:
                raise KernelBuildError(
                    f"nvcc failed ({rc}): {' '.join(cmd)}\n{stdout}\n{stderr}"
                )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    if _lib is None:
        with PROFILER.startup_phase("startup.kernel_library"):
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.csa_error_string.argtypes = [ctypes.c_int]
            lib.csa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Run one C entry; raise if it reports a CUDA error."""
    lib = load()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.csa_error_string(rc).decode()
        raise KernelLaunchError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_device(t: torch.Tensor, what: str) -> str:
    """'cpu' or 'cuda' for a tensor; raise for any other device type."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(
            f"{what}: tensors must lie on the CPU or a CUDA device, "
            f"got {t.device}"
        )
    return kind
