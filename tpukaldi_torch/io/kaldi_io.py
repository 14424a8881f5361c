"""Kaldi ark/scp binary codecs, implemented from the on-disk format spec.

Covers the same wire formats the reference's vendored kaldi-io supports
(reference: data_io.py:650-1446): binary float32/float64 matrices ("FM "/"DM "),
compressed matrices ("CM "/"CM2 "/"CM3 "), float vectors ("FV "/"DV "),
int32 alignment vectors, text-mode matrices/vectors, RIFF wav payloads, and
scp indirection (`key path:offset`).  The implementation here is a fresh
stream-oriented design (single `_read_token` dispatch + dataclass readers)
rather than a translation; numerical output is byte-parity with Kaldi.

No subprocesses: where the reference shells out to `copy-feats`/`wav-copy`
(data_io.py:34-42) we parse the files directly.
"""

from __future__ import annotations

import io
import os
import struct
from typing import BinaryIO, Iterator, Tuple, Union

import numpy as np

BINARY_FLAG = b"\x00B"


class KaldiIOError(IOError):
    """Malformed Kaldi stream."""


# ---------------------------------------------------------------------------
# low-level primitives
# ---------------------------------------------------------------------------


def _expect(fd: BinaryIO, want: bytes, what: str) -> None:
    got = fd.read(len(want))
    if got != want:
        raise KaldiIOError(f"expected {what} ({want!r}), got {got!r}")


def _read_int32(fd: BinaryIO) -> int:
    """Kaldi basic-type int32: one size byte (\\x04) then little-endian int32."""
    size = fd.read(1)
    if size != b"\x04":
        raise KaldiIOError(f"expected int32 size byte, got {size!r}")
    return struct.unpack("<i", fd.read(4))[0]


def _write_int32(fd: BinaryIO, value: int) -> None:
    fd.write(b"\x04" + struct.pack("<i", value))


def read_key(fd: BinaryIO) -> str:
    """Read a whitespace-terminated utterance key; '' at EOF."""
    chars = []
    while True:
        c = fd.read(1)
        if c == b"":
            break
        if c in (b" ", b"\t", b"\n"):
            if chars:
                break
            continue
        chars.append(c)
    return b"".join(chars).decode("latin1")


def _peek(fd: BinaryIO, n: int) -> bytes:
    """Peek n bytes from a (possibly unseekable) stream."""
    if fd.seekable():
        pos = fd.tell()
        data = fd.read(n)
        fd.seek(pos)
        return data
    peek = getattr(fd, "peek", None)
    if peek is None:
        raise KaldiIOError(
            f"cannot peek unseekable stream without .peek ({type(fd).__name__}); "
            f"wrap it in io.BufferedReader"
        )
    data = peek(n)[:n]
    if 0 < len(data) < n:
        # BufferedReader.peek cannot refill past its buffer boundary, so a
        # short peek mid-stream is ambiguous with EOF for the caller; fail
        # loudly instead of letting format detection run on partial bytes
        # (callers treat b"" as EOF, which stays silent)
        if peek(1):
            raise KaldiIOError(
                f"short peek ({len(data)}/{n} bytes) at a buffer boundary "
                f"of an unseekable stream; buffer the stream fully "
                f"(e.g. io.BytesIO) before parsing"
            )
    return data


# ---------------------------------------------------------------------------
# open_or_fd: path / path:offset / fd / pipe
# ---------------------------------------------------------------------------


def open_or_fd(file: Union[str, BinaryIO], mode: str = "rb") -> BinaryIO:
    """Open `path`, `path:offset`, or pass through an existing fd.

    Unlike the reference (data_io.py:685-759) no `popen` shell pipes are
    spawned here; pipelines are handled natively by `.pipeline`.
    """
    if not isinstance(file, str):
        return file
    if "rb" in mode or "r" in mode:
        path, _, offset = file.rpartition(":")
        if path and offset.isdigit():
            fd = open(path, "rb")
            fd.seek(int(offset))
            return fd
        return open(file, "rb")
    return open(file, mode if "b" in mode else mode + "b")


# ---------------------------------------------------------------------------
# matrices
# ---------------------------------------------------------------------------


def _read_compressed_mat(fd: BinaryIO, fmt: str) -> np.ndarray:
    """Decode Kaldi CompressedMatrix (formats 1/2/3) to float32.

    Format spec: GlobalHeader {min f32, range f32, rows i32, cols i32};
    format 1 stores 4 uint16 percentiles per column plus one uint8/entry
    (column-major), formats 2/3 store uint16/uint8 per entry (row-major).
    Matches the decompression the reference performs at data_io.py:1150-1196.
    """
    min_value, rng = struct.unpack("<ff", fd.read(8))
    rows, cols = struct.unpack("<ii", fd.read(8))

    def u16_to_f32(u16: np.ndarray) -> np.ndarray:
        return min_value + rng * (1.0 / 65535.0) * u16.astype(np.float64)

    if fmt == "CM":
        headers = np.frombuffer(fd.read(8 * cols), dtype="<u2").reshape(cols, 4)
        data = np.frombuffer(fd.read(rows * cols), dtype=np.uint8).reshape(cols, rows)
        from .. import native

        fast = native.decode_cm1(headers, data, min_value, rng, rows, cols)
        if fast is not None:
            return fast
        p0, p25, p75, p100 = (u16_to_f32(headers[:, i])[:, None] for i in range(4))
        c = data.astype(np.float64)
        lo = p0 + (p25 - p0) * (c * (1.0 / 64.0))
        mid = p25 + (p75 - p25) * ((c - 64.0) * (1.0 / 128.0))
        hi = p75 + (p100 - p75) * ((c - 192.0) * (1.0 / 63.0))
        vals = np.where(c <= 64, lo, np.where(c <= 192, mid, hi))
        return vals.T.astype(np.float32)
    if fmt == "CM2":
        data = np.frombuffer(fd.read(2 * rows * cols), dtype="<u2")
        return u16_to_f32(data).reshape(rows, cols).astype(np.float32)
    if fmt == "CM3":
        data = np.frombuffer(fd.read(rows * cols), dtype=np.uint8)
        return (min_value + rng * (1.0 / 255.0) * data.astype(np.float64)).reshape(
            rows, cols
        ).astype(np.float32)
    raise KaldiIOError(f"unknown compressed-matrix format {fmt!r}")


def _read_binary_mat(fd: BinaryIO) -> np.ndarray:
    token = fd.read(3).decode("latin1")
    if token.startswith("CM"):
        # token is "CM " (fmt 1) or "CM2"/"CM3" followed by a space
        if token == "CM ":
            fmt = "CM"
        else:
            fd.read(1)  # trailing space
            fmt = token
        return _read_compressed_mat(fd, fmt)
    if token == "FM ":
        dtype, itemsize = "<f4", 4
    elif token == "DM ":
        dtype, itemsize = "<f8", 8
    else:
        raise KaldiIOError(f"unknown matrix token {token!r}")
    rows = _read_int32(fd)
    cols = _read_int32(fd)
    buf = fd.read(rows * cols * itemsize)
    if len(buf) != rows * cols * itemsize:
        raise KaldiIOError("truncated matrix payload")
    return np.frombuffer(buf, dtype=dtype).reshape(rows, cols).astype(np.float32)


def _read_text_mat(fd: BinaryIO) -> np.ndarray:
    rows, row = [], []
    buf = b""
    while True:
        c = fd.read(1)
        if c == b"" or c == b"]":
            if buf:
                row.append(float(buf))
            if row:
                rows.append(row)
            break
        if c in (b" ", b"\t", b"["):
            if buf:
                row.append(float(buf))
                buf = b""
        elif c == b"\n":
            if buf:
                row.append(float(buf))
                buf = b""
            if row:
                rows.append(row)
                row = []
        else:
            buf += c
    # consume trailing newline
    fd.read(1)
    return np.array(rows, dtype=np.float32)


def read_mat(fd_or_path: Union[str, BinaryIO]) -> np.ndarray:
    """Read one matrix (binary or text) at the current position / scp target."""
    fd = open_or_fd(fd_or_path)
    try:
        head = _peek(fd, 2)
        if head == BINARY_FLAG:
            fd.read(2)
            return _read_binary_mat(fd)
        if not head:
            # Kaldi errors here too: silently yielding a (0,) matrix turned
            # a bad scp offset / truncated ark into downstream shape chaos
            raise EOFError(
                "no matrix data at the requested position (bad scp offset "
                "or truncated ark)"
            )
        return _read_text_mat(fd)
    finally:
        if isinstance(fd_or_path, str):
            fd.close()


def write_mat(fd: BinaryIO, mat: np.ndarray, key: str = "") -> None:
    """Write a binary float32/float64 matrix, optionally with `key ` prefix.

    Byte-compatible with Kaldi so `latgen-faster-mapped` can consume the
    posterior arks we emit (reference writer: data_io.py:1200-1248).
    """
    if mat.ndim != 2:
        raise ValueError("write_mat expects a 2-D array")
    if key:
        fd.write(key.encode("latin1") + b" ")
    fd.write(BINARY_FLAG)
    if mat.dtype == np.float64:
        fd.write(b"DM ")
        # ascontiguousarray is at most ONE copy (none when the input is
        # already contiguous little-endian), vs astype+tobytes' two full
        # copies — posterior emission writes GBs through here and the
        # serialization rides the forward stage's critical path
        payload = np.ascontiguousarray(mat, dtype="<f8")
    else:
        fd.write(b"FM ")
        payload = np.ascontiguousarray(mat, dtype="<f4")
    _write_int32(fd, mat.shape[0])
    _write_int32(fd, mat.shape[1])
    fd.write(payload.data)


def write_mat_compressed(fd: BinaryIO, mat: np.ndarray, key: str = "") -> None:
    """Write a Kaldi CompressedMatrix in format 2 ("CM2 ": uint16/entry,
    row-major) — the simplest of the three formats; Kaldi reads it
    transparently wherever a matrix is expected.  ~2x smaller than FM with
    ~1e-4 relative quantization error."""
    if mat.ndim != 2:
        raise ValueError("write_mat_compressed expects a 2-D array")
    m = np.asarray(mat, dtype=np.float64)
    min_v = float(m.min()) if m.size else 0.0
    max_v = float(m.max()) if m.size else 0.0
    rng = max(max_v - min_v, 1e-10)
    q = np.round((m - min_v) / rng * 65535.0).astype("<u2")
    if key:
        fd.write(key.encode("latin1") + b" ")
    fd.write(BINARY_FLAG + b"CM2 ")
    fd.write(struct.pack("<ff", np.float32(min_v), np.float32(rng)))
    fd.write(struct.pack("<ii", m.shape[0], m.shape[1]))
    fd.write(q.tobytes())


# ---------------------------------------------------------------------------
# float vectors (incl. RIFF wav payloads)
# ---------------------------------------------------------------------------


def _read_riff_wav(fd: BinaryIO) -> np.ndarray:
    """Minimal RIFF/WAVE parser -> float32 samples (16-bit PCM, first channel).

    Reference behavior: data_io.py:945-991 reads wav entries from wav-copy
    output; we parse the container directly.
    """
    header = fd.read(12)
    if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise KaldiIOError("not a RIFF/WAVE stream")
    n_channels, sample_bytes = 1, 2
    data = None
    while True:
        chunk_hdr = fd.read(8)
        if len(chunk_hdr) < 8:
            break
        cid, size = chunk_hdr[:4], struct.unpack("<I", chunk_hdr[4:])[0]
        if cid == b"fmt ":
            fmt = fd.read(size)
            n_channels = struct.unpack("<H", fmt[2:4])[0]
            bits = struct.unpack("<H", fmt[14:16])[0]
            sample_bytes = bits // 8
        elif cid == b"data":
            data = fd.read(size)
            break
        else:
            fd.read(size)
        if size % 2:  # RIFF chunks are word-aligned: skip the pad byte
            fd.read(1)
    if data is None:
        raise KaldiIOError("RIFF stream has no data chunk")
    if sample_bytes != 2:
        raise KaldiIOError("only 16-bit PCM wav supported")
    samples = np.frombuffer(data, dtype="<i2").astype(np.float32)
    if n_channels > 1:
        samples = samples.reshape(-1, n_channels)[:, 0].copy()
    return samples


def read_vec_flt(fd_or_path: Union[str, BinaryIO]) -> np.ndarray:
    fd = open_or_fd(fd_or_path)
    try:
        head = _peek(fd, 4)
        if head[:4] == b"RIFF":
            return _read_riff_wav(fd)
        if head[:2] == BINARY_FLAG:
            fd.read(2)
            if _peek(fd, 4) == b"RIFF":
                return _read_riff_wav(fd)
            token = fd.read(3).decode("latin1")
            if token == "FV ":
                dtype, itemsize = "<f4", 4
            elif token == "DV ":
                dtype, itemsize = "<f8", 8
            else:
                raise KaldiIOError(f"unknown vector token {token!r}")
            dim = _read_int32(fd)
            buf = fd.read(dim * itemsize)
            if len(buf) != dim * itemsize:
                raise KaldiIOError(
                    f"truncated vector payload: wanted {dim * itemsize} "
                    f"bytes, got {len(buf)}"
                )
            return np.frombuffer(buf, dtype=dtype).astype(np.float32)
        # text vector: "[ v v v ]"
        return _read_text_mat(fd).reshape(-1)
    finally:
        if isinstance(fd_or_path, str):
            fd.close()


def write_vec_flt(fd: BinaryIO, vec: np.ndarray, key: str = "") -> None:
    if key:
        fd.write(key.encode("latin1") + b" ")
    fd.write(BINARY_FLAG)
    if vec.dtype == np.float64:
        fd.write(b"DV ")
        payload = vec.astype("<f8")
    else:
        fd.write(b"FV ")
        payload = vec.astype("<f4")
    _write_int32(fd, vec.shape[0])
    fd.write(payload.tobytes())


# ---------------------------------------------------------------------------
# int32 vectors (alignments)
# ---------------------------------------------------------------------------


def read_vec_int(fd_or_path: Union[str, BinaryIO]) -> np.ndarray:
    """Read one int32 vector (Kaldi alignment format, size-byte-per-element)."""
    fd = open_or_fd(fd_or_path)
    try:
        if _peek(fd, 2) == BINARY_FLAG:
            fd.read(2)
            n = _read_int32(fd)
            # payload: n * (\x04 + int32); strided decode instead of a loop
            raw = np.frombuffer(fd.read(5 * n), dtype=np.uint8).reshape(n, 5)
            if n and not (raw[:, 0] == 4).all():
                raise KaldiIOError("corrupt int-vector size bytes")
            return raw[:, 1:].copy().view("<i4").reshape(n).astype(np.int64)
        # text: whitespace-separated ints until newline/]
        line = fd.readline().decode("latin1").strip().strip("[]")
        return np.array([int(v) for v in line.split()], dtype=np.int64)
    finally:
        if isinstance(fd_or_path, str):
            fd.close()


def write_vec_int(fd: BinaryIO, vec: np.ndarray, key: str = "") -> None:
    if key:
        fd.write(key.encode("latin1") + b" ")
    fd.write(BINARY_FLAG)
    _write_int32(fd, len(vec))
    raw = np.empty((len(vec), 5), dtype=np.uint8)
    raw[:, 0] = 4
    raw[:, 1:] = np.asarray(vec, dtype="<i4").reshape(-1, 1).view(np.uint8)
    fd.write(raw.tobytes())


# ---------------------------------------------------------------------------
# ark / scp generators
# ---------------------------------------------------------------------------


def _ark_iter(fd_or_path, reader) -> Iterator[Tuple[str, np.ndarray]]:
    fd = open_or_fd(fd_or_path)
    try:
        while True:
            key = read_key(fd)
            if not key:
                return
            yield key, reader(fd)
    finally:
        if isinstance(fd_or_path, str):
            fd.close()


def read_mat_ark(fd_or_path) -> Iterator[Tuple[str, np.ndarray]]:
    return _ark_iter(fd_or_path, read_mat)


def read_vec_int_ark(fd_or_path) -> Iterator[Tuple[str, np.ndarray]]:
    return _ark_iter(fd_or_path, read_vec_int)


def read_vec_flt_ark(fd_or_path) -> Iterator[Tuple[str, np.ndarray]]:
    return _ark_iter(fd_or_path, read_vec_flt)


def read_scp_entries(scp_path: str) -> Iterator[Tuple[str, str]]:
    """Yield (key, rxspec) lines of an scp file."""
    with open(scp_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, rxspec = line.partition(" ")
            yield key, rxspec.strip()


def read_mat_scp(scp_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    for key, rxspec in read_scp_entries(scp_path):
        yield key, read_mat(rxspec)


def read_vec_flt_scp(scp_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    for key, rxspec in read_scp_entries(scp_path):
        yield key, read_vec_flt(rxspec)


class ArkScpWriter:
    """Write a paired (ark, scp) like Kaldi's `ark,scp:` wxspec."""

    def __init__(self, ark_path: str, scp_path: str = None, writer=write_mat):
        self._ark = open(ark_path, "wb")
        self._ark_path = os.path.abspath(ark_path)
        self._scp = open(scp_path, "w") if scp_path else None
        self._writer = writer

    def write(self, key: str, data: np.ndarray) -> None:
        self._ark.write(key.encode("latin1") + b" ")
        offset = self._ark.tell()
        self._writer(self._ark, data)
        if self._scp:
            self._scp.write(f"{key} {self._ark_path}:{offset}\n")

    def close(self) -> None:
        self._ark.close()
        if self._scp:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# posteriors / confusion networks / segments
# (reference surface: data_io.py:1251-1446)
# ---------------------------------------------------------------------------


def read_post(fd_or_path: Union[str, BinaryIO]) -> list:
    """Read one Kaldi Posterior: C++ vector<vector<pair<int32,float>>>.

    Outer vector = frames; inner vector = (index, value) records per frame.
    Wire layout: '\\0B', int32 n_frames, then per frame int32 n_pairs
    followed by n_pairs of (int32 idx, float32 val) — every basic type
    prefixed by its 1-byte size marker.
    """
    fd = open_or_fd(fd_or_path)
    try:
        _expect(fd, BINARY_FLAG, "binary flag")
        n_frames = _read_int32(fd)
        rec = np.dtype([("si", "i1"), ("idx", "<i4"), ("sv", "i1"), ("val", "<f4")])
        out = []
        for _ in range(n_frames):
            n_pairs = _read_int32(fd)
            data = np.frombuffer(fd.read(n_pairs * rec.itemsize), dtype=rec,
                                 count=n_pairs)
            if n_pairs and (data["si"][0] != 4 or data["sv"][0] != 4):
                raise KaldiIOError("malformed posterior pair record")
            out.append([(int(i), float(v)) for i, v in zip(data["idx"],
                                                           data["val"])])
        return out
    finally:
        if isinstance(fd_or_path, str):
            fd.close()


def write_post(fd: BinaryIO, post: list, key: str = "") -> None:
    """Write one Posterior (inverse of read_post; Kaldi-binary-compatible)."""
    if key:
        fd.write(key.encode("latin1") + b" ")
    fd.write(BINARY_FLAG)
    _write_int32(fd, len(post))
    for frame in post:
        _write_int32(fd, len(frame))
        for idx, val in frame:
            fd.write(b"\x04" + struct.pack("<i", int(idx)))
            fd.write(b"\x04" + struct.pack("<f", float(val)))


def read_post_ark(fd_or_path: Union[str, BinaryIO]) -> Iterator[Tuple[str, list]]:
    """Generator of (key, posterior) from an ark stream."""
    fd = open_or_fd(fd_or_path)
    try:
        key = read_key(fd)
        while key:
            yield key, read_post(fd)
            key = read_key(fd)
    finally:
        if isinstance(fd_or_path, str):
            fd.close()


def read_post_scp(fd_or_path: Union[str, BinaryIO]) -> Iterator[Tuple[str, list]]:
    for key, rx in read_scp_entries(fd_or_path):
        yield key, read_post(rx)


def read_post_rxspec(spec: str) -> Iterator[Tuple[str, list]]:
    """'ark:...' / 'scp:...' posterior reader (data_io.py:1256-1266)."""
    kind, _, path = spec.partition(":")
    if kind == "ark":
        return read_post_ark(path)
    if kind == "scp":
        return read_post_scp(path)
    raise KaldiIOError(f"posterior rxspec must start with ark:/scp:, got {spec!r}")


def read_cnet_ark(fd_or_path: Union[str, BinaryIO]) -> Iterator[Tuple[str, list]]:
    """Confusion networks share the Posterior wire format (data_io.py:1251)."""
    return read_post_ark(fd_or_path)


def read_cntime(fd_or_path: Union[str, BinaryIO]) -> list:
    """Confusion-network bin times: vector<pair<float,float>> of
    (t_begin, t_end) per bin (data_io.py:1389-1421)."""
    fd = open_or_fd(fd_or_path)
    try:
        _expect(fd, BINARY_FLAG, "binary flag")
        n = _read_int32(fd)
        rec = np.dtype([("sb", "i1"), ("tb", "<f4"), ("se", "i1"), ("te", "<f4")])
        data = np.frombuffer(fd.read(n * rec.itemsize), dtype=rec, count=n)
        if n and (data["sb"][0] != 4 or data["se"][0] != 4):
            raise KaldiIOError("malformed cntime record")
        return [(float(b), float(e)) for b, e in zip(data["tb"], data["te"])]
    finally:
        if isinstance(fd_or_path, str):
            fd.close()


def read_cntime_ark(fd_or_path: Union[str, BinaryIO]) -> Iterator[Tuple[str, list]]:
    fd = open_or_fd(fd_or_path)
    try:
        key = read_key(fd)
        while key:
            yield key, read_cntime(fd)
            key = read_key(fd)
    finally:
        if isinstance(fd_or_path, str):
            fd.close()


def read_segments_as_bool_vec(path: str) -> np.ndarray:
    """Kaldi 'segments' file for ONE recording -> per-frame bool vector
    at 100 frames/sec (data_io.py:1429-1446): lines '<utt> <rec> <beg> <end>'
    with times in seconds; True inside any segment."""
    segs = []
    recs = set()
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 4:
                raise KaldiIOError(f"bad segments line: {line!r}")
            recs.add(parts[1])
            segs.append((float(parts[2]), float(parts[3])))
    if not segs:
        raise KaldiIOError("empty segments file")
    if len(recs) != 1:
        raise KaldiIOError("segments file must reference a single recording")
    start = np.rint([100 * b for b, _ in segs]).astype(int)
    end = np.rint([100 * e for _, e in segs]).astype(int)
    vec = np.zeros(int(end.max()), dtype=bool)
    for b, e in zip(start, end):
        vec[b:e] = True
    return vec
