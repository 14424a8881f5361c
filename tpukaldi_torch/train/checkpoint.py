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

import math
import os
import queue
import struct
import threading
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import numpy as np
import torch
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


def _pack_ext_header(out: bytearray, code: int, n: int) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out += struct.pack(">Bb", fixext[n], code)
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)


def _pack(out: bytearray, v: Any, views: List[Tuple[int, memoryview]]) -> None:
    """Append `v` to `out`, except an array's data: that goes into `views`
    as (offset in `out`, a view of the array's own buffer), so a large
    checkpoint is never copied into one buffer (`_parts`)."""
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
        # the ext's payload is the triple (shape, dtype name, C-order
        # bytes); only a non-contiguous array (a transposed kernel) is
        # copied, into C order
        data = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        head = bytearray([0x93])
        _pack(head, list(arr.shape), views)
        _pack(head, arr.dtype.name, views)
        _pack_len(head, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        _pack_ext_header(out, _EXT_NPSCALAR if isinstance(v, np.generic)
                         else _EXT_NDARRAY, len(head) + len(data))
        out += head
        views.append((len(out), data))
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 15, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x, views)
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 15, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k, views)
            _pack(out, x, views)
    else:
        raise TypeError(f"cannot serialize {type(v).__name__}")


def _parts(value: Any) -> List[memoryview]:
    """The msgpack encoding of `value` as consecutive pieces: headers, and
    each array's data in place."""
    out = bytearray()
    views: List[Tuple[int, memoryview]] = []
    _pack(out, value, views)
    whole, parts, pos = memoryview(out), [], 0
    for at, data in views:
        parts += [whole[pos:at], data]
        pos = at
    return parts + [whole[pos:]]


def packb(value: Any) -> bytes:
    return b"".join(_parts(value))


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
        f.writelines(_parts(payload))
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


class AsyncCheckpointer:
    """Checkpoint writes that overlap training (tpukaldi's
    `train/checkpoint.py::AsyncCheckpointer`): `save_all_async` takes the
    state on the device and returns; one writer thread packs and writes
    while the next chunks train.  Saves queue (depth 2) instead of joining
    the previous one; a third save blocks until the oldest write is done,
    which bounds the snapshots in flight.  `wait()` drains the queue (call
    it before reading the files, and at the end of a run).  A writer error
    re-raises at the next `save_all_async` or `wait()`.

    On a CUDA device a save (1) copies every tensor it writes into one
    flat device buffer per dtype on the compute stream, in stream order
    with the steps around it (the next chunk's foreach optimizer updates
    the live tensors in place), and reads the step count and lr of the
    same moment; (2) copies those buffers with `non_blocking` into pinned
    host buffers on a side stream that waits for the compute stream, and
    records an event there; the pinned buffers are reused from save to
    save.  The writer thread waits on that event and then runs host code
    only: `to_jax_params`, the optimizer's tree, `packb` and
    `write_checkpoint`.  The files are byte-equal to `save_all`'s."""

    DEPTH = 2  # saves queued or being written at once

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._queue: "queue.Queue" = queue.Queue()
        # taken by a save before its snapshot, given back when it is written
        self._depth = threading.Semaphore(self.DEPTH)
        self._error: Optional[BaseException] = None
        # pinned host buffers ({(device, dtype): flat tensor}) no write holds
        self._free: List[Dict] = []
        self._lock = threading.Lock()
        self._stream = None  # the side stream of the device-to-host copies
        # (start, end) `time.perf_counter` of each write, in save order
        self.write_spans: List[Tuple[float, float]] = []

    def _raise_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _ensure_worker(self) -> None:
        if self._thread is not None:
            return

        def work():
            while True:
                item = self._queue.get()
                try:
                    self._write(item)
                except BaseException as e:  # re-raised on the caller
                    self._error = e
                finally:
                    self._queue.task_done()

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="tpukaldi-ckpt-writer")
        self._thread.start()

    def _pinned(self, sizes: Dict) -> Dict:
        """A set of pinned host buffers of at least `sizes` elements."""
        with self._lock:
            slot = self._free.pop() if self._free else {}
        for (device, dtype), n in sizes.items():
            if device.type == "cuda" and (
                    (device, dtype) not in slot
                    or slot[(device, dtype)].numel() < n):
                slot[(device, dtype)] = torch.empty(n, dtype=dtype,
                                                    pin_memory=True)
        return slot

    def save_all_async(self, paths: Dict[str, str],
                       modules: Dict[str, nn.Module],
                       optimizers: Optional[Dict[str, "ArchOptimizer"]] = None
                       ) -> None:
        self._raise_error()
        self._ensure_worker()
        self._depth.acquire()  # a third save waits for the oldest write
        try:
            item = self._snapshot(paths, modules, optimizers)
        except BaseException:
            self._depth.release()
            raise
        self._queue.put(item)

    def _snapshot(self, paths, modules, optimizers) -> Dict:
        """Steps (1) and (2): the work item of one save."""
        # (1) every tensor the files hold, by (arch, state key or "sd",
        # name), and the host values of the same moment
        tensors: Dict[Tuple[str, str, str], torch.Tensor] = {}
        archs = {}
        for arch in paths:
            module = modules[arch]
            for name, t in module.state_dict().items():
                tensors[(arch, "sd", name)] = t
            opt = (optimizers or {}).get(arch)
            count = lr = None
            if opt is not None:
                count, lr, moments = opt.capture()
                for key, by_name in moments.items():
                    for name, t in by_name.items():
                        tensors[(arch, key, name)] = t
            archs[arch] = (type(module).__name__, opt, count, lr)
        groups: Dict[Tuple[torch.device, torch.dtype], list] = {}
        for k, t in tensors.items():
            groups.setdefault((t.device, t.dtype), []).append(k)
        with torch.no_grad():
            flat = {g: torch.cat([tensors[k].reshape(-1) for k in keys])
                    for g, keys in groups.items()}
        layout = {g: [(k, tuple(tensors[k].shape)) for k in keys]
                  for g, keys in groups.items()}
        # (2) the device buffers to pinned host memory, on the side stream
        slot = self._pinned({g: f.numel() for g, f in flat.items()})
        host = {g: f for g, f in flat.items() if not f.is_cuda}  # copies
        done = None
        on_card = [g for g, f in flat.items() if f.is_cuda]
        if on_card:
            device = flat[on_card[0]].device
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            self._stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(self._stream):
                for g in on_card:
                    host[g] = slot[g][: flat[g].numel()]
                    host[g].copy_(flat[g], non_blocking=True)
                    # the device buffer stays allocated until its copy ends
                    flat[g].record_stream(self._stream)
                done = torch.cuda.Event()
                done.record(self._stream)
        return {"paths": dict(paths), "archs": archs, "layout": layout,
                "host": host, "done": done, "slot": slot}

    def _write(self, item: Dict) -> None:
        """The writer thread's part: host code only, once the copy is
        done."""
        try:
            if item["done"] is not None:
                item["done"].synchronize()
            t0 = time.perf_counter()
            arrays = {}
            for g, entries in item["layout"].items():
                buf, pos = item["host"][g].numpy(), 0
                for k, shape in entries:
                    n = math.prod(shape)
                    arrays[k] = buf[pos : pos + n].reshape(shape)
                    pos += n
            for arch, path in item["paths"].items():
                class_name, opt, count, lr = item["archs"][arch]
                sd = {name: a for (ar, part, name), a in arrays.items()
                      if ar == arch and part == "sd"}
                params, stats = to_jax_params(sd, class_name)
                opt_tree = None
                if opt is not None:
                    moments: Dict[str, Dict[str, np.ndarray]] = {}
                    for (ar, part, name), a in arrays.items():
                        if ar == arch and part != "sd":
                            moments.setdefault(part, {})[name] = a
                    opt_tree = opt.state_tree((count, lr, moments), sd)
                write_checkpoint(path, params, opt_tree, stats)
            self.write_spans.append((t0, time.perf_counter()))
        finally:
            with self._lock:
                self._free.append(item["slot"])
            self._depth.release()

    def wait(self) -> None:
        """Block until every queued write is on disk; re-raise a writer
        error."""
        if self._thread is not None:
            self._queue.join()
        self._raise_error()


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
        state = module.state_dict()
        module.load_state_dict({k: v.to(state[k].device) if k in state else v
                                for k, v in sd.items()})
        opt = (optimizers or {}).get(arch)
        if opt is not None:
            opt.load_state_tree(opt_state, path)
