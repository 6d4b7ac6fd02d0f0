"""Build the package's CUDA kernels at first use and bind them with ctypes.

Every `csrc/*.cu` file is compiled by its own `nvcc` for Hopper (`sm_90a`),
all of them at once, and the objects are linked into one shared library
with a plain C interface. The library lands in
`devc_tpu_torch/_build/<hash>/`, keyed by a hash of the sources (headers
included) and flags, so an unchanged checkout builds once. Each C entry point returns
`cudaGetLastError()` after its launch; `check` raises on a non-zero code.
A failed build raises: nothing here falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each entry point: (argtypes, restype)
_SIGNATURES = {
    # theta, phi, values, out, sim, l_out, part, batch, nq, nk, c, splits,
    # inv_t, stream
    "devc_corr_fwd": ([_P] * 7 + [_I] * 5 + [ctypes.c_float, _P], _I),
    # a, b, c, d, x, n_sys, len, stream
    "devc_tridiag_pcr": ([_P] * 5 + [_I, _I, _P], _I),
    # src, guide, out, batch, h, w, axis, guide_bstride, lam, sigma, stream
    "devc_smooth_pass": ([_P] * 3 + [_I] * 4 + [ctypes.c_longlong]
                         + [ctypes.c_float] * 2 + [_P], _I),
    # df, phi, dtheta, part, batch, nq, nk, c, splits, stream
    "devc_corr_bwd_dq": ([_P] * 4 + [_I] * 5 + [_P], _I),
    # theta, phi, values, m, l, dd, dsim, dout, rows, df, dphi, dvalues,
    # part_v, part_p, batch, nq, nk, c, splits, psplits, inv_t, stream
    "devc_corr_bwd_dkv": ([_P] * 14 + [_I] * 6 + [ctypes.c_float, _P], _I),
    "devc_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}  # seconds, path and nvcc output of this process's load


class KernelError(RuntimeError):
    """A CUDA kernel failed to build or to launch."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise KernelError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def _key(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def load_kernels():
    """The kernel library, built on first call. Thread-safe; raises
    KernelError when nvcc is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        srcs = _sources()
        out_dir = os.path.join(BUILD_DIR, _key(srcs))
        lib_path = os.path.join(out_dir, "libdevc_kernels.so")
        log = ""
        if not os.path.exists(lib_path):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            nvcc = _nvcc()
            objs = [os.path.join(out_dir, os.path.basename(s) + f".{os.getpid()}.o")
                    for s in srcs]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                    for s, o in zip(srcs, objs)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in cmds]
            outs = [p.communicate()[0] for p in procs]  # waits for all
            log = "".join(outs)
            for cmd, p, out in zip(cmds, procs, outs):
                if p.returncode != 0:
                    raise KernelError(
                        f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log += res.stdout + res.stderr
            if res.returncode != 0:
                raise KernelError(
                    f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                    f"{res.stdout}{res.stderr}")
            for o in objs:
                os.remove(o)
            os.replace(tmp, lib_path)  # atomic against a concurrent build
        lib = ctypes.CDLL(lib_path)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        build_info.update(seconds=time.perf_counter() - t0, path=lib_path,
                          log=log)
        _lib = lib
        return lib


def check(code: int, name: str) -> None:
    """Raise KernelError for a non-zero cudaError_t from an entry point."""
    if code != 0:
        msg = load_kernels().devc_error_string(code).decode()
        raise KernelError(f"{name}: CUDA error {code} at launch: {msg}")
