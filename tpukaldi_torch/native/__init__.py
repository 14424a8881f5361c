"""Native (C++) host data-plane ops: splice, CMVN, deltas and Kaldi's
compressed-matrix decode, built on demand with g++ and bound via ctypes.

`lib()` returns the loaded library or None.  None makes every op here
return None, and its caller (`..io.feats`, `..io.kaldi_io`) then runs the
same op in numpy: these are host ops on the data plane, not device
kernels, so that path hides no device and changes no result.  It is taken
when g++ is missing or the build fails, or with TPUKALDI_NATIVE=0.

The library is built from `data_ops.cc` into `build/tpukaldi_torch/`
beside the package (a directory `.gitignore` lists), named by a hash of the
source and the flags, never into the package itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..kernels._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_ops.cc")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def library_path() -> str:
    """Where the library built from `data_ops.cc` lives."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libtpukaldi_data_ops_{digest.hexdigest()[:16]}.so")


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(so: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
    try:
        result = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        result = None
    if result is None or result.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, so)  # atomic: another process never loads a partial file
    return True


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if os.environ.get("TPUKALDI_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            L = ctypes.CDLL(so)
        except OSError:
            return None
        i64, f32p, f64p = (
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
        )
        L.tk_splice.argtypes = [f32p, i64, i64, i64, i64, f32p]
        L.tk_chunk_cmvn.argtypes = [f32p, i64, i64]
        L.tk_apply_cmvn.argtypes = [f32p, i64, i64, f64p, ctypes.c_int]
        L.tk_add_deltas.argtypes = [
            f32p, i64, i64, ctypes.c_int, f64p,
            ctypes.POINTER(i64), ctypes.POINTER(i64), f32p,
        ]
        L.tk_decode_cm1.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_float, ctypes.c_float, i64, i64, f32p,
        ]
        _lib = L
        return _lib


def _fp32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _fp64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def splice(feats: np.ndarray, left: int, right: int) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    x = np.ascontiguousarray(feats, dtype=np.float32)
    n, d = x.shape
    out = np.empty((n - left - right, d * (left + right + 1)), dtype=np.float32)
    L.tk_splice(_fp32(x), n, d, left, right, _fp32(out))
    return out


def chunk_cmvn(feats: np.ndarray, inplace: bool = False) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    # the C op is in-place; `inplace=True` lets a caller that OWNS the
    # buffer (e.g. the chunk loader, which just built it via concatenate)
    # skip a full-chunk copy — on this class of host a 170 MB copy costs
    # seconds, comparable to the device step time of the whole chunk
    if inplace and feats.dtype == np.float32 and feats.flags.c_contiguous:
        x = feats
    else:
        x = np.array(feats, dtype=np.float32, order="C", copy=True)
    n, d = x.shape
    L.tk_chunk_cmvn(_fp32(x), n, d)
    return x


def apply_cmvn(
    feats: np.ndarray, stats: np.ndarray, norm_vars: bool
) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    # in-place C op: copy to protect the caller's buffer
    x = np.array(feats, dtype=np.float32, order="C", copy=True)
    st = np.ascontiguousarray(stats, dtype=np.float64)
    n, d = x.shape
    L.tk_apply_cmvn(_fp32(x), n, d, _fp64(st), int(norm_vars))
    return x


def add_deltas(
    feats: np.ndarray, scales, order: int
) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    x = np.ascontiguousarray(feats, dtype=np.float32)
    n, d = x.shape
    flat = np.concatenate([np.asarray(s, dtype=np.float64) for s in scales])
    offsets = np.zeros(len(scales), dtype=np.int64)
    lens = np.array([len(s) for s in scales], dtype=np.int64)
    offsets[1:] = np.cumsum(lens)[:-1]
    out = np.empty((n, d * (order + 1)), dtype=np.float32)
    L.tk_add_deltas(
        _fp32(x), n, d, order, _fp64(flat),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _fp32(out),
    )
    return out


def decode_cm1(
    headers: np.ndarray, data: np.ndarray, min_v: float, range_v: float,
    rows: int, cols: int,
) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    h = np.ascontiguousarray(headers, dtype=np.uint16)
    d = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.empty((rows, cols), dtype=np.float32)
    L.tk_decode_cm1(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        float(min_v), float(range_v), rows, cols, _fp32(out),
    )
    return out
