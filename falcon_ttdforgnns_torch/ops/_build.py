"""Build and load the Hopper kernels of ``csrc/*.cu`` and the host runtime
``csrc/falcon_native.cpp``.

nvcc compiles each CUDA source into its own shared library with a plain C
interface (seconds, no PyTorch headers), keyed on a hash of the source and
flags, in ``falcon_ttdforgnns_torch/build/``; ctypes loads it.  Nothing is
built at import time: the first CUDA call of a source's wrappers builds
that source, and :func:`build_all` builds every source with one nvcc each,
all started together.  The host runtime is built the same way by the host
C++ compiler (:func:`build_host`, the JAX package's ``csrc/Makefile``
flags) at the first call of ``graph/_native.py``.  A missing compiler or a
failed build raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_f = ctypes.c_float
_pp = ctypes.POINTER(_p)
# per source: its C functions' argument types, and its error-string function
_SIGNATURES: Dict[str, Dict[str, list]] = {
    "tt_kernels": {
        "tt_fwd": [_p, _p, _ll, _i, ctypes.POINTER(_i), _p, _p, _p, _p, _p, _i, _p, _i, _p],
        "tt_grads": [_p, _p, _p, _i, _ll, _i, ctypes.POINTER(_i), _p, _p, _p, _p, _p, _p],
        "tt_adam_apply": [_i, ctypes.POINTER(_ll), _pp, _pp, _pp, _pp,
                          _p, _f, _f, _f, _f, _f, _p],
        "tt_sgd_apply": [_i, ctypes.POINTER(_ll), _pp, _pp, _f, _p],
        "tt_adagrad_apply": [_i, ctypes.POINTER(_ll), ctypes.POINTER(_i), _pp, _pp, _pp,
                             _f, _f, _i, _p],
    },
    "spmm_kernels": {
        "spmm_tile_sum": [_p, _i, _ll, _i, _p, _p, _p, _p, _p, _i, _ll, _i, _i, _i, _p, _ll,
                          _p],
        "spmm_window_gather": [_p, _i, _ll, _i, _p, _p, _p, _i, _ll, _p, _p],
    },
    "tower_kernels": {
        "fanout_mean_bf16": [_p, _ll, _i, _i, _p, _p],
        "fanout_mean_bf16_bwd": [_p, _ll, _i, _i, _p, _p],
        "segment_mean_bf16": [_p, _p, _p, _p, _ll, _i, _p, _p],
        "csr_mean_f32": [_p, _p, _p, _p, _ll, _i, _p, _p],
        "csr_mean_bf16": [_p, _p, _p, _p, _ll, _i, _p, _p],
    },
    "attn_kernels": {
        "csr_gat_bf16": [_p, _p, _p, _p, _p, _ll, _i, _i, _i, _p, _p],
        "csr_gat_f32": [_p, _p, _p, _p, _p, _ll, _i, _i, _i, _p, _p],
    },
    "optim_kernels": {
        "adam_f32_apply": [_i, _pp, _pp, _pp, _pp, ctypes.POINTER(_ll), _p, _p, _p, _f, _f, _f,
                           _i, _f, _f, _f, _f, _f, _p],
    },
}
_ERROR_STRING = {"tt_kernels": "tt_error_string", "spmm_kernels": "spmm_error_string",
                 "tower_kernels": "tower_error_string", "attn_kernels": "attn_error_string",
                 "optim_kernels": "optim_error_string"}
SOURCES = tuple(_SIGNATURES)


# the host runtime: csrc/<name>.cpp, built with the JAX package's
# csrc/Makefile flags (CXXFLAGS, then -shared)
HOST_SOURCES = ("falcon_native",)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-Wall",
             "-shared")


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


def _source(name: str) -> Path:
    if name not in _SIGNATURES:
        raise ValueError(f"unknown kernel source {name!r}; expected one of {SOURCES}")
    return CSRC / f"{name}.cu"


def library_path(name: str = "tt_kernels") -> Path:
    """The library of one source, keyed on the source, the headers of
    ``csrc/`` it may include, and the flags."""
    key = hashlib.sha256(_source(name).read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    return BUILD_DIR / f"{name}_{key.hexdigest()[:16]}.so"


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++`` on PATH."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found ($CXX, g++, c++): the native "
                       "runtime of falcon_ttdforgnns_torch cannot be built")


def _compile(cmd, so: Path) -> Tuple[Path, subprocess.Popen]:
    """Start one compiler writing a file of this process's own; the caller
    moves it into place (:func:`_finish`), so that processes building the
    same library at once never load a half-written one."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    return tmp, subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _finish(name: str, so: Path, tmp: Path, proc: subprocess.Popen):
    """Wait for one compiler: (error message or None, its report)."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        return f"build of {name} failed ({proc.returncode}):\n{err}", ""
    os.replace(tmp, so)
    return None, out + err


def host_library_path(name: str = "falcon_native") -> Path:
    """The host runtime's library, keyed on its source and the flags."""
    if name not in HOST_SOURCES:
        raise ValueError(f"unknown host source {name!r}; expected one of {HOST_SOURCES}")
    src = CSRC / f"{name}.cpp"
    key = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{key.hexdigest()[:16]}.so"


def build_host(name: str = "falcon_native") -> Path:
    """Compile the host runtime if it has not been built yet; raises if the
    compiler is missing or fails."""
    return build_all((), (name,))[name][0]


def build_all(names=SOURCES, host=()) -> Dict[str, Tuple[Path, str]]:
    """Compile every CUDA source of ``names`` and host source of ``host``
    not built yet, one compiler process each, all running at once.
    Returns {source: (library path, the compiler's report)}; the report
    (for nvcc, ptxas register and shared memory use) is empty for a library
    that already existed.  Raises if any build failed."""
    todo, done = {}, {}
    for name in (*names, *host):
        cuda = name not in host
        so = library_path(name) if cuda else host_library_path(name)
        if so.exists():
            done[name] = (so, "")
            continue
        cmd = ([find_nvcc(), *NVCC_FLAGS, str(_source(name))] if cuda
               else [find_cxx(), *CXX_FLAGS, str(CSRC / f"{name}.cpp")])
        todo[name] = (so, *_compile(cmd, so))
    failed = []
    for name, (so, tmp, proc) in todo.items():
        msg, report = _finish(name, so, tmp, proc)
        if msg:
            failed.append(msg)
        else:
            done[name] = (so, report)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def build(name: str = "tt_kernels") -> Tuple[Path, str]:
    """Compile one source if it has not been built yet: (library path,
    compiler report)."""
    return build_all((name,))[name]


@functools.lru_cache(maxsize=None)
def library(name: str = "tt_kernels") -> ctypes.CDLL:
    so, _ = build(name)
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = _i
    err = getattr(lib, _ERROR_STRING[name])
    err.argtypes = [_i]
    err.restype = ctypes.c_char_p
    return lib


def current_stream(device_index: int) -> int:
    """The current stream of CUDA device ``device_index``, as the launchers
    take it: the raw handle that PyTorch's own generated kernels are launched
    on, read without making a ``torch.cuda.Stream`` object (host time per
    call: chip_smoke.py's "current stream" line)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check(rc: int, what: str, name: str = "tt_kernels") -> None:
    """Raise if a launcher of source ``name`` returned a CUDA error code."""
    if rc != 0:
        msg = getattr(library(name), _ERROR_STRING[name])(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
