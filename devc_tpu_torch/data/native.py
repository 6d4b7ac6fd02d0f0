"""ctypes bindings for the host C++ data kernels (mirrors
devc_tpu/data/native.py).

`native/forward_warp.cpp` (the forward-flow warp of the synthetic second
frame) and `native/resize_aa.cpp` (CenterPad's anti-aliased float64
resize) are the port's own copies of devc_tpu's sources. They are built
with g++ at first use, with devc_tpu's flags, into
`devc_tpu_torch/_build/native/<hash>/`, keyed by a hash of the sources
and flags. A failed build raises (as `utils/build.py` does for the CUDA
kernels): nothing falls back silently. The numpy versions
(`_forward_warp_numpy` here, `data/transforms.py::resize_antialiased_plain`)
are the plain references; a caller that wants them names them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = [os.path.join(_PKG_DIR, "native", n)
         for n in ("forward_warp.cpp", "resize_aa.cpp")]
BUILD_DIR = os.path.join(_PKG_DIR, "_build", "native")
# devc_tpu's flags, then its portable retry without -march / OpenMP
_FLAG_SETS = (("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"),
              ("-O3", "-shared", "-fPIC"))

_P8 = ctypes.POINTER(ctypes.c_uint8)
_PF = ctypes.POINTER(ctypes.c_float)
_PD = ctypes.POINTER(ctypes.c_double)
_I = ctypes.c_int

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """The host C++ data kernels failed to build or to load."""


def _key() -> str:
    h = hashlib.sha256(repr(_FLAG_SETS).encode())
    for s in _SRCS:
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(lib_path: str) -> None:
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    errors = []
    for flags in _FLAG_SETS:
        cmd = ["g++", *flags, *_SRCS, "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=180)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{' '.join(cmd)}: {e}")
            continue
        if res.returncode == 0:
            os.replace(tmp, lib_path)  # atomic against a concurrent build
            return
        errors.append(f"{' '.join(cmd)}: exit {res.returncode}\n{res.stderr}")
    raise NativeBuildError("g++ could not build the data kernels:\n"
                           + "\n".join(errors))


def get_lib():
    """The native library, built on first call (thread-safe). Raises
    NativeBuildError when g++ is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = os.path.join(BUILD_DIR, _key(), "libdevc_native.so")
        if not os.path.exists(lib_path):
            _build(lib_path)
        try:
            lib = ctypes.CDLL(lib_path)
            lib.forward_warp_u8.argtypes = [_P8, _PF, _PF, _P8, _I, _I, _I,
                                            _I, ctypes.c_float]
            lib.forward_warp_u8.restype = None
            lib.resize_aa_u8.argtypes = [_P8, _I, _I, _I, _PD, _I, _I]
            lib.resize_aa_u8.restype = None
        except (OSError, AttributeError) as e:
            raise NativeBuildError(f"cannot load {lib_path}: {e}") from e
        _lib = lib
        return lib


def _bilinear_gather(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Clamp-to-edge bilinear lookup; img [H, W] or [H, W, C]."""
    h, w = img.shape[:2]
    x = np.clip(x, 0, w - 1)
    y = np.clip(y, 0, h - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    wx = (x - x0)[..., None] if img.ndim == 3 else (x - x0)
    wy = (y - y0)[..., None] if img.ndim == 3 else (y - y0)
    return (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
            + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy)


def _forward_warp_numpy(src, u, v, max_iter=5, precision=1e-2):
    """The plain version of forward_warp_u8: the same fixed-point search,
    vectorized in numpy."""
    h, w = u.shape
    xr, yr = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    du = np.empty_like(u)
    du[:, :-1] = u[:, 1:] - u[:, :-1]
    du[:, -1] = u[:, -1] - u[:, -2]
    dv = np.empty_like(v)
    dv[:-1, :] = v[1:, :] - v[:-1, :]
    dv[-1, :] = v[-1, :] - v[-2, :]
    i = xr - u / (1.0 + du)
    j = yr - v / (1.0 + dv)
    small = (np.abs(u) < precision) & (np.abs(v) < precision)
    active = ~small
    for _ in range(max_iter):
        inb = (i >= 0) & (i <= w - 1) & (j >= 0) & (j <= h - 1)
        act = active & inb
        i_next = xr - _bilinear_gather(u, i, j)
        j_next = yr - _bilinear_gather(v, i, j)
        conv = (np.abs(i - i_next) < precision) & (np.abs(j - j_next) < precision)
        i = np.where(act, i_next, i)
        j = np.where(act, j_next, j)
        active = act & ~conv
    i = np.where(small, xr, i)
    j = np.where(small, yr, j)
    # reflect at the borders, then clamp
    i = np.abs(i)
    i = np.clip(np.where(i > w - 1, 2 * (w - 1) - i, i), 0, w - 1)
    j = np.abs(j)
    j = np.clip(np.where(j > h - 1, 2 * (h - 1) - j, j), 0, h - 1)
    out = _bilinear_gather(src.astype(np.float32), i, j)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def resize_aa_native(src_u8: np.ndarray, out_hw) -> np.ndarray:
    """Anti-aliased float64 resize of a uint8 [H, W] or [H, W, C] image
    (the reference's CenterPad resize; native/resize_aa.cpp) -> float64
    [oh, ow(, C)]."""
    lib = get_lib()
    src = np.ascontiguousarray(src_u8, dtype=np.uint8)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    h, w, c = src.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    dst = np.empty((oh, ow, c), np.float64)
    lib.resize_aa_u8(src.ctypes.data_as(_P8), h, w, c, dst.ctypes.data_as(_PD),
                     oh, ow)
    return dst[..., 0] if squeeze else dst


def forward_warp(src: np.ndarray, u: np.ndarray, v: np.ndarray,
                 max_iter: int = 5, precision: float = 1e-2) -> np.ndarray:
    """Warp uint8 HWC `src` by a forward flow (u horizontal, v vertical)
    with the C++ kernel (the reference's forward_mapping,
    utils/util_distortion.py:523-552)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.ndim == 2:
        src = src[..., None]
    h, w, c = src.shape
    u = np.ascontiguousarray(u, dtype=np.float32)
    v = np.ascontiguousarray(v, dtype=np.float32)
    assert u.shape == (h, w) and v.shape == (h, w)
    lib = get_lib()
    dst = np.empty_like(src)
    lib.forward_warp_u8(src.ctypes.data_as(_P8), u.ctypes.data_as(_PF),
                        v.ctypes.data_as(_PF), dst.ctypes.data_as(_P8),
                        h, w, c, max_iter, precision)
    return dst
