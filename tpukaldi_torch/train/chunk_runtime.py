"""Chunk runtime: process one planner task (counterpart of tpukaldi's
`train/chunk_runtime.py`, reference core.py:438 `run_nn`).

Only the forward task is ported: it loads the chunk on the host (the shared
`tpukaldi.data.chunk_loader`), runs the forward step batch by batch on the
runtime's device, copies the packed posteriors to the host and writes the
posterior arks and the `.info` ledger entry.  Train and valid tasks come
with the training step (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import configparser
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from tpukaldi.config.cfg import ExperimentConfig
from tpukaldi.config.model_dsl import used_names
from tpukaldi.data.batching import iter_forward_batches
from tpukaldi.data.chunk_loader import ChunkData, load_chunk
from tpukaldi.forward.posteriors import PosteriorWriter
from tpukaldi.plan.planner import ChunkTask

from ..graph.compiler import build_graph, init_graph
from . import checkpoint as ckpt
from .step import forward_step

# utterance batches run by forward tasks since the last reset; chip_smoke.py
# holds the liGRU kernel's launch count to it
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


class ChunkRuntime:
    """Holds the compiled graph and its weights on `device` for one run."""

    def __init__(self, exp: ExperimentConfig, device):
        self.exp = exp
        self.device = torch.device(device)
        self.graph = None
        self._loaded_from: Dict[str, str] = {}

    def load_task_chunk(self, task: ChunkTask) -> ChunkData:
        """Host path: the shared chunk loader, only the streams the [model]
        program references."""
        if task.phase != "forward":
            raise NotImplementedError(
                f"{task.phase} tasks are not ported yet (ROADMAP.md, queue 1)")
        ds = self.exp.datasets[task.dataset]
        fea_names = used_names(
            self.exp.model, list(ds.features), "input") or list(ds.features)
        lab_names = [] if self.exp.production else (
            used_names(self.exp.model, list(ds.labels), "label")
            or list(ds.labels))
        task.write_lst_files()
        return load_chunk(
            ds, fea_names, lab_names,
            self.exp.batches.msl_for_phase("forward", task.epoch),
            fea_only=self.exp.production,
            seed=task.seed,
            fea_lst_override=task.lst_files,
        )

    def ensure_initialized(self, chunk: ChunkData) -> None:
        if self.graph is None:
            self.graph = build_graph(
                self.exp, chunk.fea_layout, chunk.lab_layout, self.device)
            init_graph(self.graph, self.exp.seed)

    def restore_from(self, pretrain_files: Dict[str, str]) -> None:
        """Load the per-arch checkpoints that exist and differ from what is
        already loaded."""
        to_load = {
            a: p for a, p in pretrain_files.items()
            if p not in ("none", "") and self._loaded_from.get(a) != p
            and os.path.exists(p)
        }
        if to_load:
            ckpt.load_all(to_load, self.graph.modules)
            self._loaded_from.update(to_load)

    def run_task(self, task: ChunkTask,
                 chunk: Optional[ChunkData] = None) -> ChunkResult:
        if task.phase != "forward":
            raise NotImplementedError(
                f"{task.phase} tasks are not ported yet: they need the "
                "training step (costs, torch.optim, the liGRU backward "
                "kernel), ROADMAP.md queue 1")
        if chunk is None:
            chunk = self.load_task_chunk(task)
        t0 = time.time()
        result = self._run_forward(task, chunk)
        result.elapsed = time.time() - t0
        write_info(task.info_file, result)
        return result

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
