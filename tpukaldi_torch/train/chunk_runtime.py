"""Chunk runtime: process one planner task, train, valid or forward
(counterpart of tpukaldi's `train/chunk_runtime.py`, reference core.py:438
`run_nn`).

Per task it loads the chunk on the host (the shared
`tpukaldi.data.chunk_loader`) and runs the step batch by batch on the
runtime's device.  Train and valid tasks take tpukaldi's batches
(`iter_seq_batches` / `iter_frame_batches`, bucket-padded unless
`TPUKALDI_PAD_TO_BUCKET=0`), keep loss and err on the device until the
chunk ends, and a train task writes its checkpoints (synchronously) before
the `.info` ledger entry.  Forward tasks copy the packed posteriors to the
host and write the posterior arks.  Graph, weights and optimizer state stay
on the device across tasks; checkpoints are read only when a task's
pretrain pointer differs from what was last loaded or saved.
"""

from __future__ import annotations

import configparser
import logging
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from tpukaldi.config.cfg import ExperimentConfig
from tpukaldi.config.model_dsl import used_names
from tpukaldi.data.batching import (
    iter_forward_batches,
    iter_frame_batches,
    iter_seq_batches,
)
from tpukaldi.data.chunk_loader import ChunkData, load_chunk
from tpukaldi.forward.posteriors import PosteriorWriter
from tpukaldi.plan.planner import ChunkTask

from ..graph.compiler import build_graph, init_graph
from ..models.common import float_list
from . import checkpoint as ckpt
from .optimizers import make_all_optimizers
from .step import eval_step, forward_step, train_step

# batches run since the last reset, by task phase; chip_smoke.py holds the
# recurrence kernels' launch counts to them (liGRU, LSTM and GRU: forward
# kernel once per layer per batch, backward kernel once per layer per train
# batch)
train_batches = 0
valid_batches = 0
forward_batches = 0


# ChunkResult, write_info and read_info copy tpukaldi's: the originals live in
# a module that imports JAX.  The .info format is the ledger both share.
@dataclass
class ChunkResult:
    loss: float
    err: float
    elapsed: float
    n_batches: int
    frames: int = 0
    phases: Optional[Dict[str, float]] = None

    @property
    def frames_per_sec(self) -> float:
        return self.frames / self.elapsed if self.elapsed > 0 else 0.0


def write_info(path: str, result: Optional[ChunkResult]) -> None:
    """Ledger entry (reference core.py:729-736)."""
    with open(path, "w") as f:
        f.write("[results]\n")
        if result is not None and result.n_batches > 0:
            f.write(f"loss={result.loss}\n")
            f.write(f"err={result.err}\n")
        f.write(f"elapsed_time_chunk={result.elapsed if result else 0.0:f}\n")
        if result is not None and result.frames:
            f.write(f"frames={result.frames}\n")
            f.write(f"frames_per_sec={result.frames_per_sec:.1f}\n")
        if result is not None and result.phases:
            for k, v in result.phases.items():
                f.write(f"phase_{k}={v:.3f}\n")


def read_info(path: str) -> Dict[str, float]:
    cp = configparser.ConfigParser()
    cp.read(path)
    return {k: float(v) for k, v in cp["results"].items()}


def batch_seed(task_seed: int, batch_index: int) -> int:
    """The dropout generator's seed for one train batch: a function of the
    task's seed and the batch index only, so a replayed chunk draws the same
    masks (tpukaldi folds the batch index into the chunk's key)."""
    return (task_seed * 1_000_003 + batch_index) % (2**63)


class ChunkRuntime:
    """Holds the compiled graph, its weights and the optimizers on `device`
    for one run."""

    def __init__(self, exp: ExperimentConfig, device):
        self.exp = exp
        self.device = torch.device(device)
        # sequential iff any computed architecture is (reference
        # is_sequential_dict, utils.py:2006-2014)
        used = {s.arg1 for s in exp.model if s.op == "compute"}
        self.seq_model = any(exp.archs[a].seq_model for a in used)
        self.graph = None
        self.optimizers = None
        self.generator = torch.Generator(device=self.device)
        self._loaded_from: Dict[str, str] = {}

    # ---------------- data ----------------
    def load_task_chunk(self, task: ChunkTask,
                        max_seq_length=None) -> ChunkData:
        """Host path: the shared chunk loader, only the streams the [model]
        program references.  `max_seq_length` defaults to the cfg's for the
        task's phase and epoch."""
        ds = self.exp.datasets[task.dataset]
        forward = task.phase == "forward"
        fea_names = used_names(
            self.exp.model, list(ds.features), "input") or list(ds.features)
        lab_names = [] if self.exp.production and forward else (
            used_names(self.exp.model, list(ds.labels), "label")
            or list(ds.labels))
        if forward or max_seq_length is None:
            max_seq_length = self.exp.batches.msl_for_phase(task.phase,
                                                            task.epoch)
        task.write_lst_files()
        return load_chunk(
            ds, fea_names, lab_names, max_seq_length,
            fea_only=self.exp.production and forward,
            shuffle_frames=task.phase == "train" and not self.seq_model,
            seed=task.seed,
            fea_lst_override=task.lst_files,
        )

    # ---------------- state ----------------
    def ensure_initialized(self, chunk: ChunkData,
                           with_optimizers: bool = False) -> None:
        """Build and seed the graph once; the optimizers only for train and
        valid tasks (a valid task restores their state too), so a
        forward-only run never builds one: the first `torch.optim` optimizer
        of a process imports `torch._dynamo`, seconds of host time."""
        if self.graph is None:
            self.graph = build_graph(
                self.exp, chunk.fea_layout, chunk.lab_layout, self.device)
            init_graph(self.graph, self.exp.seed)
        if with_optimizers and self.optimizers is None:
            self.optimizers = make_all_optimizers(self.graph.archs,
                                                  self.graph.modules)
            # weights loaded without them are read again with their state
            self._loaded_from.clear()

    def apply_epoch_schedules(self, epoch: int) -> None:
        """Per-epoch scheduled dropout (reference utils.py:872-906): the
        epoch's rates go into the arch options and the modules' rates.
        Weights, batch stats and optimizer state carry over."""
        for name, arch in self.exp.archs.items():
            if not (arch.drop_schedules and arch.drop_field):
                continue
            ep = min(epoch, len(arch.drop_schedules[0]) - 1)
            arch.options[arch.drop_field] = ",".join(
                str(s[ep]) for s in arch.drop_schedules)
            if self.graph is not None and name in self.graph.modules:
                self.graph.modules[name].drop = float_list(
                    arch.options[arch.drop_field])

    def restore_from(self, pretrain_files: Dict[str, str]) -> None:
        """Load the per-arch checkpoints that exist and differ from what is
        already loaded or was last saved (weights and optimizer state)."""
        to_load = {
            a: p for a, p in pretrain_files.items()
            if p not in ("none", "") and self._loaded_from.get(a) != p
            and os.path.exists(p)
        }
        if to_load:
            ckpt.load_all(to_load, self.graph.modules, self.optimizers)
            self._loaded_from.update(to_load)

    # ---------------- phases ----------------
    def run_task(self, task: ChunkTask, epoch_lr: Optional[Dict[str, float]] = None,
                 max_seq_length=None, batch_size: int = 8,
                 chunk: Optional[ChunkData] = None) -> ChunkResult:
        if chunk is None:
            chunk = self.load_task_chunk(task, max_seq_length)
        self.apply_epoch_schedules(task.epoch)
        t0 = time.time()
        if task.phase in ("train", "valid"):
            result = self._run_train_valid(task, chunk, epoch_lr, batch_size)
        else:
            result = self._run_forward(task, chunk)
        result.elapsed = time.time() - t0
        write_info(task.info_file, result)
        return result

    def _batches(self, chunk: ChunkData, batch_size: int, train: bool,
                 seed: int):
        if not self.seq_model:
            return iter_frame_batches(chunk, batch_size)
        # random left zero-padding at train (reference core.py:586-590);
        # TPUKALDI_PAD_TO_BUCKET=0 pads to the batch max instead of a bucket
        rng = np.random.default_rng(seed) if train else None
        pad_to_bucket = os.environ.get("TPUKALDI_PAD_TO_BUCKET", "1") != "0"
        return iter_seq_batches(chunk, batch_size, rng=rng,
                                pad_to_bucket=pad_to_bucket)

    def _effective_bs(self, chunk: ChunkData, batch_size: int) -> int:
        """Batching drops the tail that does not fill a batch (reference
        core.py:118-127); a chunk smaller than one batch shrinks the batch
        to cover it, as tpukaldi does, instead of dividing by zero."""
        n = chunk.n_sentences if self.seq_model else chunk.n_frames
        if 0 < n < batch_size:
            logging.warning(
                "chunk has %d %s < batch_size %d; using batch_size=%d",
                n, "sentences" if self.seq_model else "frames", batch_size, n)
            return n
        return batch_size

    def _run_train_valid(self, task: ChunkTask, chunk: ChunkData,
                         epoch_lr: Optional[Dict[str, float]],
                         batch_size: int) -> ChunkResult:
        global train_batches, valid_batches
        if chunk.rates_differ:
            raise NotImplementedError(
                "raw-waveform chunks (feature and label rates differ) need "
                "the conv front-ends, which are not ported yet")
        if (chunk.n_sentences if self.seq_model else chunk.n_frames) == 0:
            return ChunkResult(0.0, 0.0, 0.0, 0)
        batch_size = self._effective_bs(chunk, batch_size)
        self.ensure_initialized(chunk, with_optimizers=True)
        tick = time.perf_counter
        t0 = tick()
        self.restore_from(task.pretrain_files)
        t_restore = tick() - t0
        train = task.phase == "train"
        if train and epoch_lr:
            # the cfg's (new-bob) lr overrides the checkpoint's
            for name, lr in epoch_lr.items():
                if name in self.optimizers:
                    self.optimizers[name].set_lr(lr)

        losses, errs = [], []
        n = frames = 0
        t_batch = t_h2d = t_disp = 0.0
        batches = self._batches(chunk, batch_size, train, task.seed)
        while True:
            t0 = tick()
            batch = next(batches, None)
            t_batch += tick() - t0
            if batch is None:
                break
            t0 = tick()
            feats = torch.from_numpy(batch.feats).to(self.device)
            labs = torch.from_numpy(batch.labs).to(self.device)
            n_valid = getattr(batch, "n_valid_t", None)
            t_h2d += tick() - t0
            t0 = tick()
            if train:
                self.generator.manual_seed(batch_seed(task.seed, n))
                loss, err = train_step(self.graph, self.optimizers, feats, labs,
                                       n_valid, self.generator)
                train_batches += 1
            else:
                loss, err = eval_step(self.graph, feats, labs, n_valid)
                valid_batches += 1
            t_disp += tick() - t0
            losses.append(loss)
            errs.append(err)
            n += 1
            # padded frames the device processed, as tpukaldi counts them
            frames += batch.feats.shape[0] * (
                batch.feats.shape[1] if batch.feats.ndim == 3 else 1)
        # one device-to-host fetch per chunk: the wait for the queued steps
        t0 = tick()
        loss_sum, err_sum = torch.stack(
            [torch.stack(losses).sum(), torch.stack(errs).sum()]).tolist()
        t_drain = tick() - t0
        t0 = tick()
        if train and task.ckpt_files:
            ckpt.save_all(task.ckpt_files, self.graph.modules, self.optimizers)
            self._loaded_from.update(task.ckpt_files)
        t_ckpt = tick() - t0
        return ChunkResult(
            loss_sum / n, err_sum / n, 0.0, n, frames,
            phases={"host_batch": t_batch, "h2d": t_h2d, "dispatch": t_disp,
                    "drain": t_drain, "ckpt_write": t_ckpt,
                    "restore_wait": t_restore},
        )

    def _run_forward(self, task: ChunkTask, chunk: ChunkData) -> ChunkResult:
        global forward_batches
        if chunk.n_sentences == 0:
            return ChunkResult(0.0, 0.0, 0.0, 0)
        if chunk.rates_differ:
            raise NotImplementedError(
                "raw-waveform chunks (feature and label rates differ) need "
                "the conv front-ends, which are not ported yet")
        self.ensure_initialized(chunk)
        self.restore_from(task.pretrain_files)
        # same knob and defaults as tpukaldi: 32 on the accelerator, 8 on CPU
        default_bs = "8" if self.device.type == "cpu" else "32"
        fwd_bs = int(os.environ.get("TPUKALDI_FORWARD_BATCH", default_bs))
        tick = time.perf_counter
        t_h2d = t_disp = t_d2h = t_ark = 0.0
        n, frames = 0, 0
        with PosteriorWriter(self.exp.forward, task.info_file,
                             subtract_on_write=False) as writer:
            # the prior subtraction runs on the device (forward_step)
            log_priors = {
                name: None if p is None else torch.as_tensor(
                    p, dtype=torch.float32, device=self.device)
                for name, p in writer.log_priors.items()
            }
            for batch in iter_forward_batches(chunk, fwd_bs):
                B = batch.feats.shape[1]
                lens = np.asarray(batch.lengths, np.int64)
                # pack each utterance's real frames contiguously: row
                # t*B + k of the flattened (T*B, C) output for t < len_k
                pack = np.concatenate([
                    np.arange(ln, dtype=np.int64) * B + k
                    for k, ln in enumerate(lens[: len(batch.names)])])
                offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
                t0 = tick()
                feats = torch.from_numpy(batch.feats).to(self.device)
                lengths = torch.from_numpy(lens).to(self.device)
                pack_idx = torch.from_numpy(pack).to(self.device)
                t_h2d += tick() - t0
                t0 = tick()
                outs = forward_step(self.graph, feats, lengths, log_priors,
                                    pack_idx)
                t_disp += tick() - t0
                forward_batches += 1
                t0 = tick()
                outs_np = {k: v.cpu().numpy() for k, v in outs.items()}
                t_d2h += tick() - t0
                t0 = tick()
                for out_name, post in outs_np.items():
                    for k, name in enumerate(batch.names):
                        o = int(offsets[k])
                        writer.write(out_name, name, post[o : o + int(lens[k])])
                t_ark += tick() - t0
                n += len(batch.names)
                frames += int(lens.sum())
        return ChunkResult(
            0.0, 0.0, 0.0, n, frames,
            phases={"h2d": t_h2d, "dispatch": t_disp, "d2h": t_d2h,
                    "ark_write": t_ark},
        )
