"""Build and bind the port's CUDA kernels.

Each `csrc/<name>.cu` file has a plain C interface (the `.cuh` headers
beside them hold device code they share). At first use it is compiled with
`nvcc` for Hopper (`sm_90a`) into its own shared library under
`kernels/build/` (git-ignored), named by a hash of its source, the headers
and the flags so that an edited source is rebuilt, and loaded with
`ctypes`. `build_all()` starts one `nvcc` per source at once, so a fresh
checkout pays for the slowest build, not for the sum.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

# --fmad=false: no product may be contracted into an FMA behind the
# source's back; the kernels write the one FMA they need explicitly.
# --cudart static (nvcc's default, named so that no toolkit changes it):
# each library launches through its own copy of the runtime, so its
# launch-error check sees its own launches' errors alone; the profiler's
# trace records those launches all the same (trace_check.py)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "--cudart", "static", "-Xptxas", "-v"]

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# name -> {C function: argtypes}; every function returns int
SIGNATURES = {
    "detect_cands": {
        "detect_cands_launch": [_vp, _vp, _vp, _vp, _i, _ll, _i, _i, _i, _i,
                                _i, _i, _i, _i, _i, _i, _f, _f, _f, _f, _f,
                                _vp],
    },
    "slice_windows": {
        "slice_windows_launch": [_vp, _vp, _vp, _vp, _i, _ll, _i, _i, _f,
                                 _vp],
    },
    "detect_mask": {
        "detect_mask_launch": [_vp, _vp, _vp, _i, _ll, _ll, _ll, _i, _i, _i,
                               _i, _i, _f, _f, _f, _f, _vp],
    },
    "raw_planar": {
        "raw_planar_launch": [_vp, _vp, _vp, _i, _i, _ll, _i, _f, _f, _vp],
    },
    # the probes (airmodes_torch/probes/)
    "bw_probe": {
        "bw_copy_launch": [_vp, _vp, _ll, _ll, _ll, _vp],
        "bw_read_launch": [_vp, _vp, _ll, _vp],
        "bw_ring_read_launch": [_vp, _vp, _vp, _ll, _ll, _i, _i, _vp],
    },
    "planar_floor": {
        "planar_floor_launch": [_vp, _vp, _vp, _vp, _i, _ll, _i, _i, _i, _i,
                                _vp],
    },
    "detect_ablate": {
        "detect_ablate_launch": [_vp, _vp, _vp, _i, _ll, _ll, _ll, _i, _i,
                                 _i, _i, _i, _f, _f, _f, _f, _vp],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC, or put nvcc "
                       "on PATH, to build the CUDA kernels")


def _target(name: str) -> str:
    """The library's path, named by a hash of its source, the shared
    headers beside it and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or
    None when the library is already built."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, os.path.join(_CSRC, f"{name}.cu"),
           "-o", tmp]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> str:
    proc, tmp, target = job
    out, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(out)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)   # a racing process never loads half a file
    return out


def build_all() -> float:
    """Build every kernel library that is not built yet, all nvcc processes
    at once; returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {name: _start(name) for name in SIGNATURES}
        errors = []
        for name, job in jobs.items():
            if job is not None:
                try:
                    _finish(name, job)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (with ptxas register and shared-memory use) of the
    last build of `name`, or "" if it was not built by this checkout."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source `name`, built on first use."""
    with _lock:
        if name in _libs:
            return _libs[name]
        job = _start(name)
        if job is not None:
            _finish(name, job)
        dll = ctypes.CDLL(_target(name))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = ctypes.c_int
        _libs[name] = dll
        return dll


def check(rc: int, what: str) -> None:
    """Raise for a nonzero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
