"""Batch assembly: chunk arrays -> fixed-shape device-ready batches.

Reference semantics (core.py:577-608): sequential models get (T, B, D)
batches padded to the longest sentence in the batch with a random number of
leading zeros (train-time regularization); non-sequential models get flat
(B, D) slices of the pre-shuffled frame matrix; forward mode runs whole
utterances at batch size 1.

TPU addition: **bucketed padding** — T is rounded up to a bucket boundary so
XLA compiles one program per bucket instead of one per distinct max-length
(SURVEY.md §5.7 TPU note).  Padded frames carry label 0 and are included in
the loss exactly like the reference's zero-padding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .chunk_loader import ChunkData

DEFAULT_BUCKETS = (25, 50, 75, 100, 150, 200, 300, 400, 500, 750, 1000, 1500, 2000)


def bucket_for(length: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    return int(np.ceil(length / 500) * 500)


@dataclass
class SeqBatch:
    feats: np.ndarray  # (T, B, D) float32
    labs: np.ndarray  # (T, B, L) int32
    names: List[str]
    lengths: np.ndarray  # true sentence lengths (B,)
    # the unbucketed batch-max length on the cost (label) time axis — the T
    # the reference would have padded to; rows beyond it are bucket padding
    # and must be masked out of loss/err (graph.compiler._masked_mean)
    n_valid_t: Optional[int] = None


@dataclass
class FrameBatch:
    feats: np.ndarray  # (B, D)
    labs: np.ndarray  # (B, L)


def iter_frame_batches(chunk: ChunkData, batch_size: int) -> Iterator[FrameBatch]:
    """Flat frame batches for non-sequential models (core.py:600-603).
    The trailing partial batch is dropped, as in the reference
    (N_batches = N // batch_size, core.py:558-559)."""
    n_batches = chunk.n_frames // batch_size
    for i in range(n_batches):
        beg, end = i * batch_size, (i + 1) * batch_size
        yield FrameBatch(feats=chunk.feats[beg:end], labs=chunk.labs[beg:end])


def iter_seq_batches(
    chunk: ChunkData,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    pad_to_bucket: bool = True,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
) -> Iterator[SeqBatch]:
    """Sentence batches for sequential models (core.py:581-598).

    `rng` enables the reference's random-left-zero-padding regularization;
    None places each sentence at offset 0 (valid/forward determinism).
    """
    lengths = chunk.sentence_lengths
    starts = np.concatenate([[0], chunk.end_index[:-1]])
    lab_lengths = chunk.lab_sentence_lengths
    lab_starts = np.concatenate([[0], chunk.lab_end_index[:-1]])
    rates_differ = chunk.rates_differ
    n_batches = chunk.n_sentences // batch_size
    L = chunk.labs.shape[1]
    for i in range(n_batches):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        batch_lens = lengths[sl]
        batch_starts = starts[sl]
        max_len = int(batch_lens.max())
        if rates_differ:
            # keep the STFT frame relation: T_fea = (T_lab-1)*shift + window
            # so the front-end's output frames align with the label axis
            max_lab = int(lab_lengths[sl].max()) if L else 0
            T_lab = bucket_for(max_lab, buckets) if pad_to_bucket else max_lab
            T = (T_lab - 1) * chunk.window_shift + chunk.window_size
        else:
            T = bucket_for(max_len, buckets) if pad_to_bucket else max_len
            T_lab = T
        feats = np.zeros((T, batch_size, chunk.feats.shape[1]), dtype=np.float32)
        labs = np.zeros((T_lab, batch_size, L), dtype=np.int64)
        for k in range(batch_size):
            ln = int(batch_lens[k])
            # offset ranges over the UNbucketed batch max (reference
            # core.py:586-590); frames past max_len are bucket padding and
            # masked out of the loss, so nothing may be placed there
            n_zeros = max_len - ln
            # random-left-zero regularization is incompatible with separate
            # label time axes (alignment would break)
            off = (
                int(rng.integers(0, n_zeros + 1))
                if rng is not None and not rates_differ
                else 0
            )
            row = slice(int(batch_starts[k]), int(batch_starts[k]) + ln)
            feats[off : off + ln, k, :] = chunk.feats[row]
            if L:
                lln = int(lab_lengths[sl][k]) if rates_differ else ln
                lrow = slice(
                    int(lab_starts[sl][k] if rates_differ else batch_starts[k]),
                    int(lab_starts[sl][k] if rates_differ else batch_starts[k])
                    + lln,
                )
                loff = 0 if rates_differ else off
                labs[loff : loff + lln, k, :] = chunk.labs[lrow]
        yield SeqBatch(
            feats=feats,
            labs=labs,
            names=chunk.names[sl],
            lengths=batch_lens,
            n_valid_t=max_lab if rates_differ else max_len,
        )


def iter_forward_utterances(chunk: ChunkData) -> Iterator[SeqBatch]:
    """Forward mode: whole utterances one at a time (core.py:605-608)."""
    starts = np.concatenate([[0], chunk.end_index[:-1]])
    lab_starts = np.concatenate([[0], chunk.lab_end_index[:-1]])
    for i, name in enumerate(chunk.names):
        row = slice(int(starts[i]), int(chunk.end_index[i]))
        feats = chunk.feats[row][:, None, :]
        if chunk.labs.size:
            lrow = slice(int(lab_starts[i]), int(chunk.lab_end_index[i]))
            labs = chunk.labs[lrow][:, None, :]
        else:
            labs = np.zeros((feats.shape[0], 1, 0), dtype=np.int64)
        yield SeqBatch(
            feats=feats,
            labs=labs,
            names=[name],
            lengths=np.array([feats.shape[0]]),
        )


def iter_forward_batches(
    chunk: ChunkData,
    batch_size: int = 8,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
) -> Iterator[SeqBatch]:
    """Bucketed batched forward: utterances grouped by padded length and
    emitted as (T_bucket, B<=batch_size, D) batches with true `lengths`.

    The reference parallelizes forwarding with one OS process per chunk on
    CPU (run_exp.py:45-50,478-498); on TPU the equivalent throughput lever
    is batching the jitted forward — exact for bidirectional models via
    lengths-aware reversal, with padding rows sliced off by the caller.
    """
    starts = np.concatenate([[0], chunk.end_index[:-1]])
    lab_starts = np.concatenate([[0], chunk.lab_end_index[:-1]])
    by_bucket = {}
    for i in range(chunk.n_sentences):
        T = bucket_for(int(chunk.sentence_lengths[i]), buckets)
        by_bucket.setdefault(T, []).append(i)
    L = chunk.labs.shape[1]
    for T, idxs in sorted(by_bucket.items()):
        for beg in range(0, len(idxs), batch_size):
            group = idxs[beg : beg + batch_size]
            # pad the batch axis to batch_size so XLA sees one (T, B) shape
            # per bucket; padded rows have length 0 and no name
            B = batch_size
            feats = np.zeros((T, B, chunk.feats.shape[1]), dtype=np.float32)
            labs = np.zeros((T, B, L), dtype=np.int64)
            lens = np.zeros(B, dtype=np.int64)
            names = []
            for k, i in enumerate(group):
                ln = int(chunk.sentence_lengths[i])
                feats[:ln, k] = chunk.feats[int(starts[i]) : int(starts[i]) + ln]
                if L and not chunk.rates_differ:
                    labs[:ln, k] = chunk.labs[
                        int(lab_starts[i]) : int(lab_starts[i]) + ln
                    ]
                lens[k] = ln
                names.append(chunk.names[i])
            yield SeqBatch(feats=feats, labs=labs, names=names, lengths=lens)


def n_seq_batches(chunk: ChunkData, batch_size: int) -> int:
    return chunk.n_sentences // batch_size


def n_frame_batches(chunk: ChunkData, batch_size: int) -> int:
    return chunk.n_frames // batch_size
