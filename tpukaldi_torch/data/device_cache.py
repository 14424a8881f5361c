"""Device-resident corpus cache with on-device batch assembly (counterpart
of tpukaldi's `data/device_cache.py`; reference semantics: the whole chunk
tensor is re-built and re-uploaded per chunk per epoch, core.py:504-507).

Design ("the host plans, the device assembles"):

- Each (dataset, feature stream) is read ONCE per run (scp + fea_opts
  pipeline per utterance, composition-independent, so cacheable), and the
  raw (unspliced, un-CMVN'd) frames live concatenated on the device for the
  rest of the run.  Labels likewise (before the min-subtraction).  A host
  numpy mirror is kept for exact statistics.
- Per chunk, ALL of the reference's host-plane semantics are replayed in
  INDEX SPACE (`build_chunk_index`): max_seq_length splitting with the
  min-tail rule, double length-sort, context-window splice (roll+trim),
  cw_max compensation, per-chunk CMVN, label min-subtraction, frame
  shuffle, giving per-stream row maps and per-chunk affine constants
  instead of a materialized chunk matrix (reference counterparts:
  data_io.py:16-281, data_io.py:522-647).
- Per batch, the host emits int32 gather indices (-1 = padding);
  `DeviceCorpusCache.assemble` gathers from the resident corpus, applies
  the CMVN affine, zeroes padding and concatenates the streams, as plain
  tensor ops on the consumer's stream: equal to the host-assembled batch
  up to the CMVN statistics' accumulation order (host: f32/f64 single
  pass; here: f64 moments with exact excluded-row corrections per splice
  lag; the differences vanish at f32).

Index-space equivalences used (from io/feats.py's splice: roll by -lag,
then drop `left` head / `right` tail rows):
  spliced row r, lag j in [0, left+right] reads raw row (r + j): the
  mod-n wrap only ever touches rows the trim drops, so the map is a plain
  slice; after cw_max compensation, final row r of stream s reads raw rows
  r + lo_s + j (lo_s = cw_l_max - left_s), and the final label row r reads
  raw label row r + cw_l_max.

On a card the uploads never wait for the device's queued steps: a store,
and a chunk's constants, cross from pinned host memory without blocking on
a side stream the cache owns, and record an event; the first `assemble`
that reads them makes the consumer's stream wait for that event.

`ChunkRuntime` takes the cache under TPUKALDI_DEVICE_CACHE: "auto"
(default; on for a CUDA device), "1" (forced, on any device), "0" (off).
It falls back to the host path, on CacheUnavailable only, for wav streams,
rate-differing chunks, chunk keys that are not cached and corpora over
TPUKALDI_DEVICE_CACHE_MAX_BYTES (default 8e9); production forward never
takes it.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.cfg import DatasetSpec
from ..io import kaldi_io as kio
from ..io.pipeline import apply_pipeline, parse_pipeline
from .batching import DEFAULT_BUCKETS, bucket_for
from .chunk_loader import _chunk_config
from .labels import read_label_stream



class CacheUnavailable(Exception):
    """Raised when the cache cannot serve a chunk; callers fall back to the
    host data path."""


# ---------------------------------------------------------------------------
# corpus storage
# ---------------------------------------------------------------------------


@dataclass
class StreamStore:
    """One feature stream of one dataset, resident on the device, with its
    host mirror."""

    name: str
    dim: int
    offsets: Dict[str, Tuple[int, int]]  # utt -> (row offset, n rows)
    host: np.ndarray  # (N, dim) float32
    device: torch.Tensor  # (N, dim) float32 on the cache's device
    cw_left: int
    cw_right: int


@dataclass
class LabelStore:
    """All label streams of one dataset, stacked (N, L) int32."""

    lab_names: Tuple[str, ...]
    offsets: Dict[str, Tuple[int, int]]
    host: np.ndarray  # (N, L) int32
    device: torch.Tensor  # (N, L) int32 on the cache's device


@dataclass
class ChunkIndexData:
    """Index-space chunk: everything `ChunkData` tells the batching layer,
    with row maps + affine constants instead of materialized arrays."""

    names: List[str]
    end_index: np.ndarray
    lab_end_index: np.ndarray
    fea_layout: Dict[str, Tuple[int, int]]  # spliced column ranges
    lab_layout: Dict[str, int]
    streams: List[str]
    full_idx: Dict[str, np.ndarray]  # stream -> (N_final, n_lags) int32
    mu: Dict[str, np.ndarray]  # stream -> (n_lags*D,) float32
    sig: Dict[str, np.ndarray]
    lab_full_idx: np.ndarray  # (N_final,) int32 (size 0 when no labels)
    lab_min: np.ndarray  # (L,) int32
    dataset: str = ""
    shuffled: bool = False
    window_shift: int = 1
    window_size: int = 1
    # filled by DeviceCorpusCache.prepare_chunk: device-resident constants
    device_consts: Optional[dict] = None

    @property
    def rates_differ(self) -> bool:
        return False

    @property
    def n_frames(self) -> int:
        return 0 if not self.streams else self.full_idx[self.streams[0]].shape[0]

    @property
    def n_sentences(self) -> int:
        return len(self.names)

    @property
    def sentence_lengths(self) -> np.ndarray:
        starts = np.concatenate([[0], self.end_index[:-1]])
        return self.end_index - starts

    @property
    def lab_sentence_lengths(self) -> np.ndarray:
        starts = np.concatenate([[0], self.lab_end_index[:-1]])
        return self.lab_end_index - starts

    def fea_dim(self, name: str) -> int:
        beg, end = self.fea_layout[name]
        return end - beg


@dataclass
class IdxBatch:
    """Device-assembly work item: gather indices instead of data.
    -1 marks padding rows (assembled as zeros, like the host path)."""

    fea_idx: Dict[str, np.ndarray]  # (T, B, n_lags) or (B, n_lags) int32
    lab_idx: np.ndarray  # (T, B) or (B,) int32
    names: List[str]
    lengths: np.ndarray
    n_valid_t: Optional[int] = None


# ---------------------------------------------------------------------------
# index-space replication of the host chunk pipeline
# ---------------------------------------------------------------------------


def _plan_pieces(keys: Sequence[str], lengths: Dict[str, int], cc):
    """Replicate load_dataset_stream's split+sort in index space
    (chunk_loader.py:119-147,219-241): per utterance, pieces of
    <= size_fea rows with the min-tail rule, alphabetical-then-length
    stable sort of utterances, then a stable length sort of the pieces.
    Returns (names, pieces) with pieces = [(utt, start, len)]."""
    size, step = cc["size_fea"], cc["step_fea"]
    ordered = sorted(sorted(keys), key=lambda k: lengths[k])
    names: List[str] = []
    pieces: List[Tuple[str, int, int]] = []
    for key in ordered:
        n = lengths[key]
        if size <= 0 or n <= size:
            utt_pieces = [(key, 0, n)]
        else:
            utt_pieces = []
            threshold = size + size / 4
            i = 0
            while True:
                start = i * step
                if n - start > threshold:
                    utt_pieces.append((key, start, size))
                else:
                    utt_pieces.append((key, start, n - start))
                    break
                i += 1
        for j, p in enumerate(utt_pieces):
            names.append(f"{key}_split{j}" if len(utt_pieces) > 1 else key)
            pieces.append(p)
    order = np.argsort([p[2] for p in pieces], kind="stable")
    return [names[i] for i in order], [pieces[i] for i in order]


def _chunk_stats(store: StreamStore, raw_map: np.ndarray, n_lags: int):
    """Exact per-chunk CMVN statistics of the spliced pre-compensation
    matrix, from f64 moments over the raw rows with per-lag excluded-row
    corrections.

    The host computes mean/std over the spliced matrix (chunk_loader
    :266-272); its lag-j column reads raw rows j .. n-(l+r)-1+j, i.e. the
    full chunk minus (l+r) rows that differ per lag.  total - excluded is
    exact; f64 accumulation matches the native chunk_cmvn's double
    accumulators (io/feats.py:41-57)."""
    rows = store.host[raw_map]
    n_pre = raw_map.shape[0]
    total1 = rows.sum(axis=0, dtype=np.float64)
    total2 = (rows.astype(np.float64) ** 2).sum(axis=0)
    cnt = n_pre - (n_lags - 1)
    D = store.dim
    mu = np.empty((n_lags, D), np.float64)
    var = np.empty((n_lags, D), np.float64)
    for j in range(n_lags):
        if n_lags == 1:
            s1, s2 = total1, total2
        else:
            excl = rows[np.r_[cnt + j : n_pre, 0:j]].astype(np.float64)
            s1 = total1 - excl.sum(axis=0)
            s2 = total2 - (excl ** 2).sum(axis=0)
        m = s1 / cnt
        mu[j] = m
        var[j] = np.maximum(s2 / cnt - m * m, 0.0)
    return (
        mu.reshape(-1).astype(np.float32),
        np.sqrt(var).reshape(-1).astype(np.float32),
        rows,
    )


def build_chunk_index(
    fea_stores: Dict[str, StreamStore],
    lab_store: Optional[LabelStore],
    fea_names: List[str],
    lab_names: List[str],
    chunk_keys: List[str],
    max_seq_length,
    shuffle_frames: bool = False,
    seed: int = 0,
    dataset: str = "",
) -> ChunkIndexData:
    """The index-space `load_chunk` (chunk_loader.py:287-384)."""
    cc = _chunk_config(max_seq_length)
    if cc["window_size"] > 1 or cc["window_shift"] > 1:
        raise CacheUnavailable("rate-differing (raw-wave) chunks use the host path")
    stores = [fea_stores[n] for n in fea_names]
    cw_l_max = max(s.cw_left for s in stores)
    cw_r_max = max(s.cw_right for s in stores)

    # utterance set: present in every touched store (reference intersects
    # feats with labels per stream, data_io.py:50-55, and errors when empty)
    keys = [k for k in chunk_keys if all(k in s.offsets for s in stores)]
    if lab_names:
        if lab_store is None:
            raise CacheUnavailable("labels not cached")
        keys = [k for k in keys if k in lab_store.offsets]
        if not keys:
            raise ValueError(
                "no utterances shared between features and labels — check "
                "the lab_folder alignment directory for this dataset"
            )
    if not keys:
        raise CacheUnavailable("no cached utterances for this chunk")

    lengths = {k: stores[0].offsets[k][1] for k in keys}
    for s in stores[1:]:
        for k in keys:
            if s.offsets[k][1] != lengths[k]:
                raise ValueError("end indexes differ across streams")
    if lab_names:
        for k in keys:
            if lab_store.offsets[k][1] != lengths[k]:
                raise ValueError(
                    f"utterance {k!r}: feature/label lengths differ"
                )

    names, pieces = _plan_pieces(keys, lengths, cc)
    piece_lens = np.asarray([p[2] for p in pieces], dtype=np.int64)
    n_pre = int(piece_lens.sum())
    n_final = n_pre - cw_l_max - cw_r_max
    if n_final <= 0:
        raise CacheUnavailable("chunk shorter than the context window")

    # end_index: raw cumsum - cw_l_max, last additionally - cw_r_max
    # (chunk_loader.py:267-268,335-341)
    end_index = np.cumsum(piece_lens) - cw_l_max
    end_index[-1] -= cw_r_max

    full_idx: Dict[str, np.ndarray] = {}
    mus: Dict[str, np.ndarray] = {}
    sigs: Dict[str, np.ndarray] = {}
    fea_layout: Dict[str, Tuple[int, int]] = {}
    col = 0
    for s in stores:
        raw_map = np.concatenate(
            [
                np.arange(
                    s.offsets[utt][0] + start,
                    s.offsets[utt][0] + start + ln,
                    dtype=np.int64,
                )
                for (utt, start, ln) in pieces
            ]
        )
        n_lags = s.cw_left + s.cw_right + 1
        lo = cw_l_max - s.cw_left
        idx = np.empty((n_final, n_lags), dtype=np.int32)
        for j in range(n_lags):
            idx[:, j] = raw_map[lo + j : lo + j + n_final]
        mu, sig, _ = _chunk_stats(s, raw_map, n_lags)
        full_idx[s.name] = idx
        mus[s.name] = mu
        sigs[s.name] = sig
        fea_layout[s.name] = (col, col + n_lags * s.dim)
        col += n_lags * s.dim

    lab_layout: Dict[str, int] = {}
    if lab_names:
        lab_raw_map = np.concatenate(
            [
                np.arange(
                    lab_store.offsets[utt][0] + start,
                    lab_store.offsets[utt][0] + start + ln,
                    dtype=np.int64,
                )
                for (utt, start, ln) in pieces
            ]
        )
        lab_full_idx = lab_raw_map[cw_l_max : n_pre - cw_r_max].astype(np.int32)
        cols = [lab_store.lab_names.index(n) for n in lab_names]
        # per-chunk min over the UNtrimmed concat (chunk_loader.py:273-274)
        lab_min = np.asarray(
            [int(lab_store.host[lab_raw_map, c].min()) for c in cols],
            dtype=np.int32,
        )
        lab_layout = {n: i for i, n in enumerate(lab_names)}
    else:
        lab_full_idx = np.zeros((0,), dtype=np.int32)
        lab_min = np.zeros((0,), dtype=np.int32)

    cm = ChunkIndexData(
        names=names,
        end_index=np.asarray(end_index),
        lab_end_index=np.asarray(end_index),
        fea_layout=fea_layout,
        lab_layout=lab_layout,
        streams=[s.name for s in stores],
        full_idx=full_idx,
        mu=mus,
        sig=sigs,
        lab_full_idx=lab_full_idx,
        lab_min=lab_min,
        dataset=dataset,
    )
    if shuffle_frames:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(cm.n_frames)
        for s in cm.streams:
            cm.full_idx[s] = cm.full_idx[s][perm]
        if cm.lab_full_idx.size:
            cm.lab_full_idx = cm.lab_full_idx[perm]
        cm.shuffled = True
    return cm


# ---------------------------------------------------------------------------
# batch index iterators (mirror data/batching.py)
# ---------------------------------------------------------------------------


def iter_frame_index_batches(cm: ChunkIndexData, batch_size: int):
    """Index twin of iter_frame_batches (batching.py:52-59)."""
    n_batches = cm.n_frames // batch_size
    L = cm.lab_full_idx.size > 0
    for i in range(n_batches):
        beg, end = i * batch_size, (i + 1) * batch_size
        yield IdxBatch(
            fea_idx={s: cm.full_idx[s][beg:end] for s in cm.streams},
            lab_idx=(cm.lab_full_idx[beg:end] if L
                     else np.zeros((batch_size,), np.int32)),
            names=[],
            lengths=np.asarray([batch_size]),
        )


def iter_seq_index_batches(
    cm: ChunkIndexData,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    pad_to_bucket: bool = True,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
):
    """Index twin of iter_seq_batches (batching.py:62-127): same bucket
    rounding, same rng call sequence for the random-left-zero offsets, -1
    padding instead of zero rows."""
    lengths = cm.sentence_lengths
    starts = np.concatenate([[0], cm.end_index[:-1]])
    n_batches = cm.n_sentences // batch_size
    has_labs = cm.lab_full_idx.size > 0
    for i in range(n_batches):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        batch_lens = lengths[sl]
        batch_starts = starts[sl]
        max_len = int(batch_lens.max())
        T = bucket_for(max_len, buckets) if pad_to_bucket else max_len
        fea_idx = {
            s: np.full((T, batch_size, cm.full_idx[s].shape[1]), -1, np.int32)
            for s in cm.streams
        }
        lab_idx = np.full((T, batch_size), -1, np.int32)
        for k in range(batch_size):
            ln = int(batch_lens[k])
            n_zeros = max_len - ln
            off = int(rng.integers(0, n_zeros + 1)) if rng is not None else 0
            row = slice(int(batch_starts[k]), int(batch_starts[k]) + ln)
            for s in cm.streams:
                fea_idx[s][off : off + ln, k] = cm.full_idx[s][row]
            if has_labs:
                lab_idx[off : off + ln, k] = cm.lab_full_idx[row]
        yield IdxBatch(
            fea_idx=fea_idx,
            lab_idx=lab_idx,
            names=cm.names[sl],
            lengths=batch_lens,
            n_valid_t=max_len,
        )


# ---------------------------------------------------------------------------
# the cache itself + the jitted assembler
# ---------------------------------------------------------------------------


def _read_stream_utterances(fea) -> Tuple[Dict[str, np.ndarray], int]:
    """Full-scp read of one feature stream, post-fea_opts, pre-splice/CMVN
    (the composition-independent prefix of load_dataset_stream,
    chunk_loader.py:166-184)."""
    stages = parse_pipeline(fea.opts) if fea.opts else []
    first_rx = next(iter(kio.read_scp_entries(fea.lst)), None)
    if first_rx is None:
        raise ValueError(f"empty feature list {fea.lst!r}")
    path = first_rx[1].rpartition(":")[0] or first_rx[1]
    with open(path, "rb") as f:
        head = f.read(max(64, len(first_rx[0]) + 16))
    is_wav = b"RIFF" in head
    if is_wav:
        raise CacheUnavailable("wav streams use the host path")
    out = {}
    for key, rx in kio.read_scp_entries(fea.lst):
        mat = kio.read_mat(rx)
        out[key] = np.asarray(
            apply_pipeline(stages, key, mat) if stages else mat,
            dtype=np.float32,
        )
    dims = {m.shape[1] for m in out.values()}
    if len(dims) != 1:
        raise ValueError(f"inconsistent feature dims in {fea.lst!r}: {dims}")
    return out, dims.pop()



_TORCH_DTYPES = {np.float32: torch.float32, np.int32: torch.int32}


def _indices(x, device: torch.device) -> torch.Tensor:
    """Gather indices (numpy, or a host tensor pinned for a card) on
    `device`, copied without blocking the host."""
    return torch.as_tensor(x).to(device, non_blocking=True)


class DeviceCorpusCache:
    """Per-run registry of the resident streams and labels on `device`, and
    the batch assembler.

    On a card every upload (a store, a chunk's constants) goes from pinned
    host memory without blocking onto the cache's own side stream and
    records an event: the loader runs on the chunk prefetcher's thread
    while the consumer's stream holds queued train steps, and a copy on
    that stream, or from pageable memory, would wait for them.  The first
    `assemble` of a chunk on a stream makes that stream wait for the events
    and marks the resident tensors as used there, so the caching allocator
    never hands out their memory before the stream's reads are done."""

    def __init__(self, device, max_bytes: Optional[int] = None):
        self.device = torch.device(device)
        self.max_bytes = max_bytes if max_bytes is not None else int(
            float(os.environ.get("TPUKALDI_DEVICE_CACHE_MAX_BYTES", "8e9"))
        )
        self._streams: Dict[Tuple[str, str], StreamStore] = {}
        self._labels: Dict[Tuple[str, Tuple[str, ...]], LabelStore] = {}
        self._bytes = 0
        self._disabled: set = set()
        self._side: Optional[torch.cuda.Stream] = None
        # store key -> the event that marks its upload done (a card only)
        self._events: Dict[tuple, torch.cuda.Event] = {}
        # (store key, bytes, seconds to read, pin and enqueue it), in order
        self.uploads: List[Tuple[tuple, int, float]] = []

    @property
    def resident_bytes(self) -> int:
        """Bytes of the resident streams and labels on the device."""
        return sum(s.device.nbytes for s in self._streams.values()) + sum(
            s.device.nbytes for s in self._labels.values())

    # ---- uploads ----
    def _host_buffer(self, shape, dtype) -> np.ndarray:
        """An empty host array; on a card in pinned memory, so that its
        upload does not block."""
        if self.device.type != "cuda":
            return np.empty(shape, dtype)
        return torch.empty(shape, dtype=_TORCH_DTYPES[dtype],
                           pin_memory=True).numpy()

    def _upload(self, host: np.ndarray):
        """`host` on the device, and the event that marks the copy done
        (None off a card): on a card a non-blocking copy from pinned memory
        on the side stream."""
        src = torch.from_numpy(host)
        if self.device.type != "cuda":
            return src.to(self.device), None
        if not src.is_pinned():
            src = src.pin_memory()
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._side):
            dev = src.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._side)
        return dev, event

    def _store(self, key: tuple, host: np.ndarray) -> torch.Tensor:
        dev, event = self._upload(host)
        if event is not None:
            self._events[key] = event
        return dev

    # ---- store builders ----
    def stream(self, ds: DatasetSpec, fea_name: str) -> StreamStore:
        key = (ds.name, fea_name)
        if key in self._disabled:
            raise CacheUnavailable(f"stream {key} previously disabled")
        if key not in self._streams:
            t0 = time.perf_counter()
            fea = ds.features[fea_name]
            utts, dim = _read_stream_utterances(fea)
            n_total = sum(m.shape[0] for m in utts.values())
            nbytes = n_total * dim * 4
            if self._bytes + nbytes > self.max_bytes:
                self._disabled.add(key)
                raise CacheUnavailable(
                    f"stream {key} ({nbytes/1e9:.2f} GB) exceeds the device "
                    f"cache budget"
                )
            offsets: Dict[str, Tuple[int, int]] = {}
            host = self._host_buffer((n_total, dim), np.float32)
            row = 0
            for utt, mat in utts.items():
                offsets[utt] = (row, mat.shape[0])
                host[row : row + mat.shape[0]] = mat
                row += mat.shape[0]
            self._streams[key] = StreamStore(
                name=fea_name, dim=dim, offsets=offsets, host=host,
                device=self._store(("fea", *key), host),
                cw_left=fea.cw_left, cw_right=fea.cw_right,
            )
            self._bytes += nbytes
            self.uploads.append((key, nbytes, time.perf_counter() - t0))
        return self._streams[key]

    def labels(self, ds: DatasetSpec, lab_names: List[str]) -> LabelStore:
        key = (ds.name, tuple(lab_names))
        if key not in self._labels:
            t0 = time.perf_counter()
            per_stream = [
                read_label_stream(ds.labels[n].folder, ds.labels[n].opts)
                for n in lab_names
            ]
            common = set(per_stream[0])
            for d in per_stream[1:]:
                common &= set(d)
            common = sorted(common)
            if not common:
                raise CacheUnavailable("label streams share no utterances")
            for utt in common:
                ln = len(per_stream[0][utt])
                for d in per_stream[1:]:
                    if len(d[utt]) != ln:
                        raise ValueError(
                            f"utterance {utt!r}: label lengths differ across "
                            f"streams"
                        )
            n_total = sum(len(per_stream[0][u]) for u in common)
            host = self._host_buffer((n_total, len(lab_names)), np.int32)
            offsets: Dict[str, Tuple[int, int]] = {}
            row = 0
            for utt in common:
                ln = len(per_stream[0][utt])
                offsets[utt] = (row, ln)
                for c, d in enumerate(per_stream):
                    host[row : row + ln, c] = d[utt]
                row += ln
            self._labels[key] = LabelStore(
                lab_names=tuple(lab_names), offsets=offsets, host=host,
                device=self._store(("lab", *key), host),
            )
            self.uploads.append((key, host.nbytes, time.perf_counter() - t0))
        return self._labels[key]

    # ---- chunk loading ----
    def load_chunk_index(
        self,
        ds: DatasetSpec,
        fea_names: List[str],
        lab_names: List[str],
        max_seq_length,
        shuffle_frames: bool,
        seed: int,
        lst_files: Optional[Dict[str, str]] = None,
    ) -> ChunkIndexData:
        cc = _chunk_config(max_seq_length)
        if cc["window_size"] > 1 or cc["window_shift"] > 1:
            # before the upload: the host path serves these chunks
            raise CacheUnavailable(
                "rate-differing (raw-wave) chunks use the host path")
        stores = {n: self.stream(ds, n) for n in fea_names}
        lab_store = self.labels(ds, lab_names) if lab_names else None
        # the chunk's utterance set comes from the planner's .lst of the
        # FIRST stream (the planner writes identical key sets per stream)
        lst = (lst_files or {}).get(
            fea_names[0], ds.features[fea_names[0]].lst
        )
        chunk_keys = [k for k, _ in kio.read_scp_entries(lst)]
        missing = [k for k in chunk_keys if k not in stores[fea_names[0]].offsets]
        if missing:
            raise CacheUnavailable(
                f"{len(missing)} chunk utterances absent from the cached "
                f"corpus (e.g. {missing[0]!r})"
            )
        cm = build_chunk_index(
            stores, lab_store, fea_names, lab_names, chunk_keys,
            max_seq_length, shuffle_frames=shuffle_frames, seed=seed,
            dataset=ds.name,
        )
        self.prepare_chunk(cm)
        return cm

    # ---- device assembly ----
    def prepare_chunk(self, cm: ChunkIndexData) -> None:
        """The chunk's constants for its `assemble` calls: the resident
        stores, and `mu`, `sig` and `lab_min` put on the device once (on a
        card from pinned memory on the side stream, without blocking)."""
        keys = [("fea", cm.dataset, s) for s in cm.streams]
        corpora = {s: self._streams[(cm.dataset, s)].device
                   for s in cm.streams}
        lab_corpus = None
        if cm.lab_layout:
            lab_key = (cm.dataset, tuple(cm.lab_layout))
            keys.append(("lab", *lab_key))
            lab_corpus = self._labels[lab_key].device
        events = [self._events[k] for k in keys if k in self._events]
        host = {"mu": cm.mu, "sig": cm.sig}
        consts = {}
        for name in ("mu", "sig"):
            consts[name] = {}
            for s in cm.streams:
                consts[name][s], event = self._upload(host[name][s])
                events.append(event)
        consts["lab_min"], event = self._upload(cm.lab_min)
        events.append(event)
        resident = [*corpora.values(), *consts["mu"].values(),
                    *consts["sig"].values(), consts["lab_min"]]
        if lab_corpus is not None:
            resident.append(lab_corpus)
        cm.device_consts = {
            "corpora": corpora, "lab_corpus": lab_corpus, **consts,
            "resident": resident,
            "events": [e for e in events if e is not None],
            # the streams that have waited for the events
            "ready_on": set(),
        }

    def _ready(self, c: dict) -> None:
        """The current stream waits for the chunk's uploads once, and the
        resident tensors are marked as used on it."""
        if self.device.type != "cuda":
            return
        stream = torch.cuda.current_stream(self.device)
        if stream in c["ready_on"]:
            return
        for event in c["events"]:
            stream.wait_event(event)
        for t in c["resident"]:
            t.record_stream(stream)
        c["ready_on"].add(stream)

    def assemble(self, cm: ChunkIndexData, fea_idx, lab_idx):
        """fea_idx: dict stream -> (..., n_lags) int32 indices, -1 for
        padding; lab_idx: (...) int32 (numpy, or host tensors pinned for a
        card).  Returns (feats float32 (..., sum of n_lags*D), labs int32
        (..., L)) on the device, enqueued on the current stream."""
        c = cm.device_consts
        if c is None:
            self.prepare_chunk(cm)
            c = cm.device_consts
        self._ready(c)
        parts = []
        for s in cm.streams:
            idx = _indices(fea_idx[s], self.device)
            corpus = c["corpora"][s]
            g = corpus.index_select(0, idx.clamp_min(0).reshape(-1))
            g = g.reshape(*idx.shape[:-1], idx.shape[-1] * corpus.shape[1])
            g = (g - c["mu"][s]) / c["sig"][s]
            parts.append(g.masked_fill(idx[..., :1] < 0, 0.0))
        feats = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        lab_idx = _indices(lab_idx, self.device)
        lab_corpus = c["lab_corpus"]
        if lab_corpus is None:
            labs = torch.zeros((*lab_idx.shape, 0), dtype=torch.int32,
                               device=self.device)
        else:
            lv = lab_corpus.index_select(0, lab_idx.clamp_min(0).reshape(-1))
            lv = lv.reshape(*lab_idx.shape, lab_corpus.shape[1])
            labs = (lv - c["lab_min"]).masked_fill(lab_idx[..., None] < 0, 0)
        return feats, labs
