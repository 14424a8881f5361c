"""Experiment planner: epochs x datasets x chunks -> an ordered task list
with a file ledger for crash recovery.

Mirrors the reference's pre-materialized plan (utils.py:1159 `create_lists`,
:853 `create_configs`) but builds **in-memory task dataclasses** instead of
thousands of chunk .cfg files.  The on-disk ledger is kept: per-chunk `.lst`
feature lists, `.info` result files (existence = chunk done, the resume
mechanism of run_exp.py:253), and rolling checkpoint paths.

Determinism contract: chunk shuffles use `seed` exactly like the reference
(random.seed(seed) once; one train shuffle per epoch — utils.py:1186,1214 —
plus, also like the reference, a valid-list shuffle from the SAME stream at
every validation point, utils.py:1168 `_get_validation_data_for_chunks`, so
changing the validation cadence legitimately changes later shuffles), and
each chunk's runtime seed is `seed + ep + ck` (utils.py:1357).  Loop
nesting here is epoch-outer (the reference iterates dataset-outer,
utils.py:1192-1213): identical streams for the common single-train-set
cfgs, same-seed deterministic either way.
"""

from __future__ import annotations

import math
import os
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..config.cfg import ExperimentConfig


def split_chunks(seq: List, size: int) -> List[List]:
    """Evenly partition a list into `size` consecutive slices
    (same rounding as utils.py:748-753)."""
    out = []
    splitsize = 1.0 / size * len(seq)
    for i in range(size):
        out.append(seq[int(round(i * splitsize)) : int(round((i + 1) * splitsize))])
    return out


def validation_points(n_chunks: int, n_valid_per_epoch: int) -> List[int]:
    """After which train chunks to validate (utils.py:756-768)."""
    chunk_size = int(math.ceil(n_chunks / float(n_valid_per_epoch)))
    points = []
    for i in range(n_valid_per_epoch):
        part = range(n_chunks)[i * chunk_size : (i + 1) * chunk_size]
        if len(part):
            points.append(part[-1])
    return points


@dataclass
class ChunkTask:
    """One unit of work: process one chunk in one phase."""

    phase: str  # train | valid | forward
    dataset: str
    epoch: int
    chunk: int
    seed: int
    fea_lists: Dict[str, List[str]]  # stream -> scp lines
    lst_files: Dict[str, str]  # stream -> materialized .lst path
    info_file: str
    ckpt_files: Dict[str, str] = field(default_factory=dict)  # arch -> out ckpt
    pretrain_files: Dict[str, str] = field(default_factory=dict)  # arch -> in ckpt
    val_chunk: Optional[int] = None

    @property
    def done(self) -> bool:
        return os.path.exists(self.info_file)

    def write_lst_files(self) -> None:
        # atomic replace: the driver re-writes a task's .lst right before
        # dispatch (run_exp ledger) while the whole-schedule prefetch
        # feeder may be mid-read of the same file for the same task — a
        # plain open(path, "w") truncates and the reader can observe an
        # empty list (seen as a flaky "empty feature list" at full-suite
        # load). os.replace makes every observable state complete.
        for stream, path in self.lst_files.items():
            # unique per writer: the feeder thread and the driver thread
            # can both materialize the same task's lists concurrently
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            try:
                with open(tmp, "w") as f:
                    f.writelines(
                        line + "\n" for line in self.fea_lists[stream])
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise


@dataclass
class EpochPlan:
    epoch: int
    tasks: List[ChunkTask]  # train chunks with interleaved valid tasks


@dataclass
class ExperimentPlan:
    out_folder: str
    exp_files: str
    epochs: List[EpochPlan]
    forward_tasks: List[ChunkTask]
    final_ckpts: Dict[str, str]  # arch -> final checkpoint path

    def all_tasks(self):
        for ep in self.epochs:
            yield from ep.tasks
        yield from self.forward_tasks

    def shard_forward_tasks(self, host_id: int, n_hosts: int) -> List[ChunkTask]:
        """Multi-host work partition for the embarrassingly parallel forward
        stage: host k takes every n-th forward chunk; the `.info` ledger is
        the coordination mechanism (SURVEY.md §2.4 'scheduling parallelism'
        note — no RPC needed, resume semantics make the union complete)."""
        return [
            t for i, t in enumerate(self.forward_tasks) if i % n_hosts == host_id
        ]


def repair_resume_point(plan: "ExperimentPlan") -> List[str]:
    """Make the `.info` ledger consistent with the checkpoints on disk
    before resuming.

    With `ckpt_every > 1` (or after a crash between the `.info` write and
    the async checkpoint flush) the first pending task's pretrain
    checkpoints may not exist; in that case the completed-but-not-
    checkpointed tail is invalidated (its `.info` files removed) so the
    driver replays it from the latest train task whose checkpoint files all
    exist.  Replay is exact: chunk results depend only on (seed+ep+ck,
    chunk data, restored state) — the determinism contract.  Returns the
    removed info paths (for logging)."""
    tasks = [t for ep in plan.epochs for t in ep.tasks]
    first_pending = next((i for i, t in enumerate(tasks) if not t.done), None)
    if first_pending is None:
        # every .info exists — but a crash between the LAST train chunk's
        # .info write and its async checkpoint flush leaves a completed-
        # looking ledger whose final state is not on disk; the forward
        # stage would then run on freshly initialized params.  Two ways a
        # finished run legitimately resumes as a no-op: the promoted
        # final_*.ckpt files exist (rolling ckpts may have been deleted as
        # disk hygiene afterwards — run_exp re-promotes from rolling only
        # when finals are absent), or the last rolling checkpoints exist
        # (promotion hasn't happened yet).  Only when BOTH are missing is
        # the final state unreproducible and the tail replayed.
        if plan.final_ckpts and all(
            os.path.exists(p) for p in plan.final_ckpts.values()
        ):
            return []
        last_train = next(
            (t for t in reversed(tasks)
             if t.phase == "train" and t.ckpt_files), None,
        )
        if last_train is None or all(
            os.path.exists(p) for p in last_train.ckpt_files.values()
        ):
            return []
        first_pending = len(tasks)
    # the state a fresh process restores at the resume point is exactly the
    # last train task before it whose checkpoint files all exist; any DONE
    # task after that point holds ledger entries for state the restore
    # cannot reproduce — those must be replayed
    start = 0
    for i in range(first_pending - 1, -1, -1):
        t = tasks[i]
        if (
            t.phase == "train"
            and t.ckpt_files
            and all(os.path.exists(p) for p in t.ckpt_files.values())
        ):
            start = i + 1
            break
    removed = []
    for t in tasks[start:first_pending]:
        if t.done:
            os.remove(t.info_file)
            removed.append(t.info_file)
    return removed


def _fmt(n: int, total: int) -> str:
    width = max(math.ceil(math.log10(total)) if total > 1 else 1, 1)
    return format(n, f"0{width}d")


def _read_scp_lines(path: str) -> List[str]:
    with open(path) as f:
        return sorted(line.rstrip("\n") for line in f if line.strip())


def build_plan(
    exp: ExperimentConfig,
    n_valid_per_epoch: int = 1,
    ckpt_every: int = 1,
) -> ExperimentPlan:
    """`ckpt_every=N` writes rolling checkpoints only every N-th train chunk
    (the last chunk of each dataset always saves, so epoch boundaries and
    final-checkpoint promotion are unchanged).  Intermediate chunks carry
    empty ckpt_files and keep the previous pretrain pointer; crash resume
    then REPLAYS the un-checkpointed tail deterministically
    (`repair_resume_point`) — same results, chunk-determinism is the
    contract (seed+ep+ck, tested).  N=1 is the reference's per-chunk
    rolling-checkpoint behavior (core.py:710-722); higher N trades resume
    granularity for checkpoint D2H/IO bandwidth, which dominates epoch time
    when the device link is slow."""
    out_folder = exp.out_folder
    exp_files = os.path.join(out_folder, "exp_files")
    os.makedirs(exp_files, exist_ok=True)
    ckpt_every = max(int(ckpt_every), 1)

    n_ep = exp.n_epochs if not exp.production else 0
    rng = random.Random(exp.seed)
    arch_names = list(exp.archs)

    # each dataset's sorted scp lines are loop-invariant: read once instead
    # of re-reading per epoch / per validation point (Librispeech-scale
    # scps x 24 epochs x valid points is hundreds of redundant full-file
    # reads at every process start, including crash resume)
    _scp_cache: Dict[str, List[str]] = {}

    def read_streams(ds):
        out = {}
        for name, f in ds.features.items():
            if f.lst not in _scp_cache:
                _scp_cache[f.lst] = _read_scp_lines(f.lst)
            out[name] = _scp_cache[f.lst]
        return out

    # --- training epochs with interleaved validation
    epochs: List[EpochPlan] = []
    rolling_ckpt: Dict[str, str] = {
        a: exp.archs[a].pretrain_file for a in arch_names
    }
    for ep in range(n_ep):
        tasks: List[ChunkTask] = []
        for ds_name in exp.train_with:
            ds = exp.datasets[ds_name]
            streams = read_streams(ds)
            # consistent shuffle across streams: shuffle index order
            n_utts = len(next(iter(streams.values())))
            order = list(range(n_utts))
            rng.shuffle(order)
            chunk_idx = split_chunks(order, ds.n_chunks)
            chunk_idx.reverse()  # reference reverses chunk order (utils.py:1216)
            val_points = validation_points(ds.n_chunks, n_valid_per_epoch)
            for ck in range(ds.n_chunks):
                base = f"train_{ds_name}_ep{_fmt(ep, n_ep)}_ck{_fmt(ck, ds.n_chunks)}"
                lst_files = {
                    s: os.path.join(exp_files, f"{base}_{s}.lst") for s in streams
                }
                fea_lists = {
                    s: [streams[s][i] for i in chunk_idx[ck]] for s in streams
                }
                info = os.path.join(exp_files, base + ".info")
                saves = (ck + 1) % ckpt_every == 0 or ck == ds.n_chunks - 1
                ckpts = {
                    a: os.path.join(exp_files, f"{base}_{a}.ckpt")
                    for a in arch_names
                } if saves else {}
                task = ChunkTask(
                    phase="train",
                    dataset=ds_name,
                    epoch=ep,
                    chunk=ck,
                    seed=exp.seed + ep + ck,
                    fea_lists=fea_lists,
                    lst_files=lst_files,
                    info_file=info,
                    ckpt_files=ckpts,
                    pretrain_files=dict(rolling_ckpt),
                )
                tasks.append(task)
                if saves:
                    rolling_ckpt = dict(ckpts)

                if ck in val_points:
                    for val_ds_name in exp.valid_with:
                        vds = exp.datasets[val_ds_name]
                        vstreams = read_streams(vds)
                        n_vutts = len(next(iter(vstreams.values())))
                        vorder = list(range(n_vutts))
                        rng.shuffle(vorder)
                        vchunks = split_chunks(vorder, vds.n_chunks)
                        for vck in range(vds.n_chunks):
                            vbase = (
                                f"valid_{val_ds_name}_ep{_fmt(ep, n_ep)}"
                                f"_trCk{_fmt(ck, ds.n_chunks)}"
                                f"_ck{_fmt(vck, vds.n_chunks)}"
                            )
                            tasks.append(
                                ChunkTask(
                                    phase="valid",
                                    dataset=val_ds_name,
                                    epoch=ep,
                                    chunk=ck,
                                    val_chunk=vck,
                                    seed=exp.seed + ep + vck,
                                    fea_lists={
                                        s: [vstreams[s][i] for i in vchunks[vck]]
                                        for s in vstreams
                                    },
                                    lst_files={
                                        s: os.path.join(
                                            exp_files, f"{vbase}_{s}.lst"
                                        )
                                        for s in vstreams
                                    },
                                    info_file=os.path.join(
                                        exp_files, vbase + ".info"
                                    ),
                                    pretrain_files=dict(rolling_ckpt),
                                )
                            )
        epochs.append(EpochPlan(epoch=ep, tasks=tasks))

    final_ckpts = {
        a: os.path.join(exp_files, f"final_{a}.ckpt") for a in arch_names
    }

    # --- forward tasks
    forward_tasks: List[ChunkTask] = []
    for ds_name in exp.forward_with:
        ds = exp.datasets[ds_name]
        streams = read_streams(ds)
        n_utts = len(next(iter(streams.values())))
        chunk_idx = split_chunks(list(range(n_utts)), ds.n_chunks)
        for ck in range(ds.n_chunks):
            base = f"forward_{ds_name}_ep{_fmt(max(n_ep - 1, 0), max(n_ep, 1))}_ck{_fmt(ck, ds.n_chunks)}"
            forward_tasks.append(
                ChunkTask(
                    phase="forward",
                    dataset=ds_name,
                    epoch=max(n_ep - 1, 0),
                    chunk=ck,
                    seed=exp.seed,
                    fea_lists={
                        s: [streams[s][i] for i in chunk_idx[ck]] for s in streams
                    },
                    lst_files={
                        s: os.path.join(exp_files, f"{base}_{s}.lst")
                        for s in streams
                    },
                    info_file=os.path.join(exp_files, base + ".info"),
                    pretrain_files=dict(final_ckpts),
                )
            )

    return ExperimentPlan(
        out_folder=out_folder,
        exp_files=exp_files,
        epochs=epochs,
        forward_tasks=forward_tasks,
        final_ckpts=final_ckpts,
    )
