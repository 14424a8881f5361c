"""Checkpoints in tpukaldi's file format, without flax or msgpack.

tpukaldi writes one msgpack file per architecture (flax.serialization):
a map `{"params", "opt_state", "batch_stats"}` of nested string-keyed maps
whose leaves are numpy arrays, each a msgpack ext of type 1 holding the
msgpack triple `(shape, dtype name, C-order bytes)` (type 3 for a numpy
scalar).  This module reads and writes that subset of msgpack in pure
Python — maps, arrays, str, bin, int, float, bool, nil, ext 1 and 3 — so a
checkpoint trained by tpukaldi loads into the port and one written by the
port loads into tpukaldi, bit for bit.
"""

from __future__ import annotations

import os
import struct
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import numpy as np
from torch import nn

from ..compat.jax_params import from_jax_params, to_jax_params

if TYPE_CHECKING:
    from .optimizers import ArchOptimizer

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# ---------------------------------------------------------------- decoding
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # code -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(fixext[b])))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ext(code: int, payload: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, buf = unpackb(payload)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data: bytes) -> Any:
    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack value")
    return value


# ---------------------------------------------------------------- encoding
def _pack_len(out: bytearray, n: int, fix_base, fix_max, codes) -> None:
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= hi:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lo in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                              (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if v >= lo:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out += struct.pack(">Bb", fixext[n], code)
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)
    out += payload


def _pack(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(0xC0)
    elif isinstance(v, bool):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out += struct.pack(">Bd", 0xCB, v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(v, (bytes, bytearray, memoryview)):
        _pack_len(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += bytes(v)
    elif isinstance(v, (np.ndarray, np.generic)):
        arr = np.asarray(v)
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise ValueError(f"cannot serialize dtype {arr.dtype}")
        payload = packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        _pack_ext(out, _EXT_NPSCALAR if isinstance(v, np.generic)
                  else _EXT_NDARRAY, payload)
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 15, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 15, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    else:
        raise TypeError(f"cannot serialize {type(v).__name__}")


def packb(value: Any) -> bytes:
    out = bytearray()
    _pack(out, value)
    return bytes(out)


# ------------------------------------------------------------- checkpoints
def read_checkpoint(path: str) -> Tuple[Dict, Dict, Dict]:
    """(params, opt_state, batch_stats) numpy trees of one checkpoint."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    return payload["params"], payload["opt_state"], payload["batch_stats"]


def write_checkpoint(path: str, params: Dict, opt_state: Dict = None,
                     batch_stats: Dict = None) -> None:
    payload = {
        "params": params,
        "opt_state": opt_state or {},
        "batch_stats": batch_stats or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(payload))
    os.replace(tmp, path)  # atomic: the ledger never sees a torn checkpoint


def save_all(paths: Dict[str, str], modules: Dict[str, nn.Module],
             optimizers: Optional[Dict[str, "ArchOptimizer"]] = None) -> None:
    """One tpukaldi-format checkpoint per architecture: params, batch stats
    and, when `optimizers` has the architecture, its optimizer state in
    tpukaldi's optax layout.  Synchronous: the device-to-host copies and
    the write finish before it returns."""
    for arch, path in paths.items():
        module = modules[arch]
        params, stats = to_jax_params(module.state_dict(), type(module).__name__)
        opt = (optimizers or {}).get(arch)
        write_checkpoint(path, params, opt.state_tree() if opt else None, stats)


def load_all(paths: Dict[str, str], modules: Dict[str, nn.Module],
             optimizers: Optional[Dict[str, "ArchOptimizer"]] = None) -> None:
    """Load every architecture whose checkpoint exists into its module, and
    its optimizer state (moments and step count, not the lr: the caller's
    cfg lr stands) into `optimizers`."""
    for arch, path in paths.items():
        if path in ("none", "", None) or not os.path.exists(path):
            continue
        module = modules[arch]
        params, opt_state, stats = read_checkpoint(path)
        sd = from_jax_params(type(module).__name__, params, stats)
        device = next(module.parameters()).device
        module.load_state_dict({k: v.to(device) for k, v in sd.items()})
        opt = (optimizers or {}).get(arch)
        if opt is not None:
            opt.load_state_tree(opt_state, path)
