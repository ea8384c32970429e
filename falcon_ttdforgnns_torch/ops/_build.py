"""Build and load the Hopper kernels of ``csrc/tt_kernels.cu``.

nvcc compiles the source into a shared library with a plain C interface
(seconds, no PyTorch headers), keyed on a hash of the source and flags, in
``falcon_ttdforgnns_torch/build/``; ctypes loads it.  Nothing is built at
import time: the first CUDA call builds.  A missing nvcc or a failed build
raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tt_kernels.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_f = ctypes.c_float
_SIGNATURES = {
    "tt_fwd": [_p, _ll, ctypes.POINTER(_i), _p, _p, _p, _p, _p, _p],
    "tt_grads": [_p, _p, _ll, ctypes.POINTER(_i), _p, _p, _p, _p, _p, _p],
    "tt_adam_apply": [_i, ctypes.POINTER(_ll), ctypes.POINTER(_p),
                      ctypes.POINTER(_p), ctypes.POINTER(_p), ctypes.POINTER(_p),
                      _p, _f, _f, _f, _f, _f, _p],
}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
                           "/usr/local/cuda and PATH): the CUDA kernels of "
                           "falcon_ttdforgnns_torch cannot be built")
    return found


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"tt_kernels_{key.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if this source has not been built yet.  Returns
    the library path and the compiler's report (ptxas register and shared
    memory use; empty when the library already existed)."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so, res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _i
    lib.tt_error_string.argtypes = [_i]
    lib.tt_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = library().tt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
