"""Experiment driver for the port (counterpart of `tpukaldi/tools/run_exp.py`,
reference run_exp.py:1-621).

  python -m tpukaldi_torch.tools.run_exp cfg/exp.cfg [--device cuda] \\
      [--mesh] [--check-data] [--section,field=value ...]

Drives: config load -> plan -> (train chunks with interleaved validation ->
new-bob lr annealing) x epochs -> res.res -> final checkpoints -> forward
posteriors -> Kaldi decode bridge, with tpukaldi's side outputs (model.svg
at start-up, the curves' txt exports and PNGs after the epochs), on the
port's copies of tpukaldi's config, planner, ledger and decode code.  Crash
recovery goes through the `.info` ledger as in tpukaldi: done tasks are
skipped on restart.  `--device cuda` without a CUDA
device is an error; there is no fallback to the CPU.

Data parallelism (`[exp] multi_gpu = True` or `--mesh`, tpukaldi's mesh):
under a process group already in place, or the one a `torchrun` launch
describes (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`), every process trains its
shard of each batch (`dist/mesh.py`); with no group and more than one
visible card, `run_experiment` starts one process per card (NCCL); else it
is world size 1.  Only rank 0 writes the ledger, the checkpoints and
res.res (the other ranks keep their chunk lists in a private temporary
directory, `ChunkRuntime._task_lists`).  The forward stage runs on rank 0
of each host, which takes every `TPUKALDI_NUM_HOSTS`-th forward task from
`TPUKALDI_HOST_ID` on.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import shutil
import socket
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ConfigError, load_config
from ..config.cfg import ExperimentConfig
from ..data.prefetch import ChunkPrefetcher
from ..decode.bridge import harvest_wer, run_decode
from ..dist import mesh as dp
from ..forward.counts import resolve_count_files
from ..plan import ChunkTask, build_plan, repair_resume_point
from ..plan.chunk_cfg import write_chunk_cfg
from ..train.chunk_runtime import (
    ChunkResult,
    ChunkRuntime,
    read_info,
    resolve_device,
)

# per-chunk phases summed into the `phases ep=` line of res.res, in
# tpukaldi's order (tools/run_exp.py:313-335)
_PHASES = ("h2d", "dispatch", "drain", "drain_compute", "drain_fetch",
           "ckpt_block", "restore_wait", "host_batch")


def _log(out_folder: str, msg: str, writes: bool = True) -> None:
    """Print `msg` and, where this process writes the run's files (rank 0),
    append it to log.log."""
    print(msg)
    if not writes:
        return
    with open(os.path.join(out_folder, "log.log"), "a") as f:
        f.write(msg + "\n")


# _aggregate, _result_from_info and dump_epoch_results copy tpukaldi's
# (tools/run_exp.py:39-83): that module imports JAX.
def _aggregate(results: List[ChunkResult]):
    if not results:
        return 0.0, 0.0, 0.0
    return (
        float(np.mean([r.loss for r in results])),
        float(np.mean([r.err for r in results])),
        float(np.sum([r.elapsed for r in results])),
    )


def _result_from_info(task: ChunkTask) -> ChunkResult:
    info = read_info(task.info_file)
    return ChunkResult(
        loss=info.get("loss", 0.0),
        err=info.get("err", 0.0),
        elapsed=info.get("elapsed_time_chunk", 0.0),
        n_batches=1,
    )


def dump_epoch_results(
    res_file: str,
    epoch: int,
    n_epochs: int,
    train_with: List[str],
    tr_loss: float,
    tr_err: float,
    valid_perf: Dict[str, ChunkResult],
    lr: Dict[str, List[float]],
    elapsed: float,
) -> None:
    """Append the reference-format epoch line (utils.py:2423-2476)."""
    width = max(len(str(n_epochs - 1)), 1)
    parts = [
        f"ep={epoch:0{width}d} tr={train_with} loss={tr_loss:0.3f} err={tr_err:0.3f}"
    ]
    for name, perf in valid_perf.items():
        parts.append(f"valid={name} loss={perf.loss:0.3f} err={perf.err:0.3f}")
    for arch, sched in lr.items():
        parts.append(f"lr_{arch}={sched[epoch]}")
    parts.append(f"time(s)={int(elapsed)}")
    line = " ".join(parts)
    with open(res_file, "a") as f:
        f.write(line + "\n")
    print(line)


class ChunkFeeder:
    """The chunk prefetch feeder (tpukaldi/tools/run_exp.py:176-225): loads
    the next task's chunk on a host thread while the device runs this one,
    across the whole schedule, every epoch's tasks then the forward tasks.
    `host_load` is the epoch loop's un-overlapped wait for chunks (reset per
    epoch by the caller); the prefetcher's `producer_seconds` is the
    loader thread's own time."""

    def __init__(self, exp: ExperimentConfig, plan, runtime: ChunkRuntime):
        self.exp, self.runtime = exp, runtime
        self.schedule = [t for ep_plan in plan.epochs for t in ep_plan.tasks]
        self.schedule += plan.forward_tasks
        self.schedule_index = {id(t): i for i, t in enumerate(self.schedule)}
        self.prefetcher = ChunkPrefetcher()
        self.for_task: Optional[ChunkTask] = None
        self.host_load = 0.0

    def _task_msl(self, task: ChunkTask):
        return self.exp.batches.msl_for_phase(task.phase, task.epoch)

    def _start_prefetch(self, after_index: int) -> None:
        """Start loading the first task after `after_index` not yet done."""
        for nxt in self.schedule[after_index + 1 :]:
            if not nxt.done:
                self.prefetcher.start(
                    lambda t=nxt: self.runtime.load_task_chunk(
                        t, self._task_msl(t)))
                self.for_task = nxt
                return
        self.for_task = None

    def get_chunk(self, task: ChunkTask):
        """`task`'s chunk: the prefetched one when it was loaded for this
        task, else loaded now; then the next task's load starts."""
        t0 = time.perf_counter()
        chunk = None
        if self.prefetcher.in_flight:
            prefetched = self.prefetcher.take()
            if self.for_task is task:
                chunk = prefetched
        if chunk is None:
            chunk = self.runtime.load_task_chunk(task, self._task_msl(task))
        self._start_prefetch(self.schedule_index[id(task)])
        self.host_load += time.perf_counter() - t0
        return chunk


def _train(exp: ExperimentConfig, plan, runtime: ChunkRuntime,
           feeder: ChunkFeeder, res_file: str) -> None:
    """The epoch loop (tpukaldi/tools/run_exp.py:167-337): train chunks in
    order, each validation point aggregating the valid tasks after it,
    new-bob halving of every auto-annealed arch's lr, and per epoch an
    `ep=` line and a `phases ep=` line in res.res.  Every rank runs it
    (the reduced valid err gives each the same lr schedule); only rank 0
    writes."""
    out_folder = exp.out_folder
    writes = runtime.writes
    # annealing is on iff the user gave a single-value schedule (reference
    # run_exp.py:151-161)
    lr: Dict[str, List[float]] = {a: list(s.lr) for a, s in exp.archs.items()}
    auto_anneal = {a: "|" not in exp.raw[s.section]["arch_lr"]
                   for a, s in exp.archs.items()}
    prev_valid_err: Optional[float] = None
    for ep_plan in plan.epochs:
        ep = ep_plan.epoch
        t_ep = time.time()
        feeder.host_load = 0.0
        producer_base = feeder.prefetcher.producer_seconds
        tr_results: List[ChunkResult] = []
        ep_valid_results: List[ChunkResult] = []
        valid_perf: Dict[str, ChunkResult] = {}
        pending_valid: List[ChunkResult] = []
        valid_names: List[str] = []
        _log(out_folder, f"------ Epoch {ep} / {exp.n_epochs - 1} ------",
             writes)

        def flush_valid_point():
            nonlocal prev_valid_err, pending_valid, valid_names
            if not pending_valid:
                return
            by_name: Dict[str, List[ChunkResult]] = {}
            for name, res in zip(valid_names, pending_valid):
                by_name.setdefault(name, []).append(res)
            for name, results in by_name.items():
                l, e, t = _aggregate(results)
                valid_perf[name] = ChunkResult(l, e, t, len(results))
            err_mean = float(np.mean([v.err for v in valid_perf.values()]))
            if prev_valid_err is not None:
                for arch in lr:
                    spec = exp.archs[arch]
                    improvement = (prev_valid_err - err_mean) / max(err_mean, 1e-12)
                    if (ep < exp.n_epochs - 1 and auto_anneal[arch]
                            and improvement < spec.improvement_threshold):
                        new_lr = lr[arch][ep] * spec.halving_factor
                        for i in range(ep + 1, exp.n_epochs):
                            lr[arch][i] = new_lr
                        _log(out_folder,
                             f"[new-bob] halving lr of {arch} -> {new_lr}",
                             writes)
            prev_valid_err = err_mean
            pending_valid, valid_names = [], []

        for task in ep_plan.tasks:
            if task.done:  # ledger resume (reference run_exp.py:253)
                res = _result_from_info(task)
            else:
                epoch_lr = {a: lr[a][ep] for a in lr}
                bs = (exp.batches.batch_size_train[ep] if task.phase == "train"
                      else exp.batches.batch_size_valid)
                msl = exp.batches.msl_for_phase(task.phase, task.epoch)
                if writes:
                    task.write_lst_files()
                    write_chunk_cfg(exp, task, lr=epoch_lr, batch_size=bs,
                                    max_seq_length=msl)
                res = runtime.run_task(task, epoch_lr=epoch_lr,
                                       max_seq_length=msl, batch_size=bs,
                                       chunk=feeder.get_chunk(task))
            if task.phase == "train":
                flush_valid_point()
                tr_results.append(res)
            else:
                pending_valid.append(res)
                valid_names.append(task.dataset)
                ep_valid_results.append(res)
        flush_valid_point()

        tr_loss, tr_err, tr_time = _aggregate(tr_results)
        epoch_wall = time.time() - t_ep
        if not writes:
            continue
        dump_epoch_results(res_file, ep, exp.n_epochs, exp.train_with,
                           tr_loss, tr_err, valid_perf, lr, epoch_wall)
        # where the epoch's wall time went (skipped by "ep="-prefixed
        # parsers).  host_load_producer: the loader thread's own seconds,
        # overlapped with device work and NOT additive with the rest;
        # host_load is the remainder the epoch loop waited on
        valid_wall = sum(r.elapsed for r in ep_valid_results)
        phases = "".join(
            f" {k}={sum((r.phases or {}).get(k, 0.0) for r in tr_results + ep_valid_results):.2f}"
            for k in _PHASES)
        producer = feeder.prefetcher.producer_seconds - producer_base
        other = max(epoch_wall - tr_time - valid_wall - feeder.host_load, 0.0)
        with open(res_file, "a") as rf:
            rf.write(f"phases ep={ep} host_load={feeder.host_load:.2f} "
                     f"train_wall={tr_time:.2f} valid_wall={valid_wall:.2f} "
                     f"host_load_producer={producer:.2f}"
                     f"{phases} driver_other={other:.2f} "
                     f"epoch_wall={epoch_wall:.2f}\n")


# TPUKALDI_MATMUL_PRECISION (tpukaldi/tools/run_exp.py:95-107 sets XLA's
# default matmul precision for the run with it) -> torch's float32 matmul
# precision and cuDNN's TF32 switch for the run: XLA's precision covers
# convolutions too, and TF32 is the least that cuDNN offers float32 convs.
# The hand kernels keep their own arithmetic under it.
MATMUL_PRECISIONS = {
    "float32": ("highest", False),
    "highest": ("highest", False),
    "tensorfloat32": ("high", True),
    "bfloat16": ("medium", True),
}


def matmul_precision_knob() -> Optional[Tuple[str, bool]]:
    """TPUKALDI_MATMUL_PRECISION as (torch's precision, cuDNN's TF32), or
    None where it is unset or empty (the port's float32: TF32 off); another
    name raises ValueError."""
    value = os.environ.get("TPUKALDI_MATMUL_PRECISION", "").strip().lower()
    if not value:
        return None
    if value not in MATMUL_PRECISIONS:
        raise ValueError(f"TPUKALDI_MATMUL_PRECISION must be one of "
                         f"{', '.join(MATMUL_PRECISIONS)}, got {value!r}")
    return MATMUL_PRECISIONS[value]


@contextlib.contextmanager
def matmul_precision():
    """TPUKALDI_MATMUL_PRECISION's setting for the run inside, and the
    previous one restored after it, as tpukaldi's `with
    jax.default_matmul_precision(...)` scopes it."""
    knob = matmul_precision_knob()
    if knob is None:
        yield
        return
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision(knob[0])
    torch.backends.cudnn.allow_tf32 = knob[1]
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def check_run_knobs(exp: ExperimentConfig) -> None:
    """The run-level knobs tpukaldi reads (tools/run_exp.py:95-120,
    :187-190), checked before any output: a TPUKALDI_MATMUL_PRECISION the
    port does not know raises ValueError, and TPUKALDI_NUM_HOSTS and
    TPUKALDI_HOST_ID must be integers with 0 <= host id < hosts."""
    matmul_precision_knob()
    n_hosts, host_id = forward_hosts()
    if n_hosts < 1 or not 0 <= host_id < n_hosts:
        raise ValueError(f"TPUKALDI_HOST_ID={host_id} is not a host of "
                         f"TPUKALDI_NUM_HOSTS={n_hosts}")


def forward_hosts() -> Tuple[int, int]:
    """(TPUKALDI_NUM_HOSTS, TPUKALDI_HOST_ID), by default (1, 0)."""
    return (int(os.environ.get("TPUKALDI_NUM_HOSTS", "1")),
            int(os.environ.get("TPUKALDI_HOST_ID", "0")))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned_rank(rank: int, world: int, port: int, cfg_file: str,
                  overrides: Optional[List[str]]) -> None:
    """One process of a run spread over the visible cards: joins the NCCL
    group as `rank` on `cuda:<rank>` and runs the experiment there."""
    device = f"cuda:{rank}"
    dp.init_distributed(f"localhost:{port}", world, rank, device=device)
    try:
        run_experiment(cfg_file, overrides, device=device, use_mesh=True)
    finally:
        torch.distributed.destroy_process_group()


def _join_mesh(device: torch.device) -> Tuple[Optional[dp.DataParallelMesh],
                                               bool]:
    """The data-parallel mesh of this process and whether it made the
    group: the group in place, else the one a torchrun launch describes
    (NCCL on `cuda:<LOCAL_RANK>` for a CUDA device, gloo for the CPU), else
    world size 1 (no group).  None where the run must be spread over the
    visible cards by `run_experiment` itself."""
    dist = torch.distributed
    if dist.is_initialized():
        return dp.data_parallel_mesh(device), False
    env = os.environ
    if all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        if device.type == "cuda":
            device = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", init_method="env://")
        return dp.data_parallel_mesh(device), True
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return None, False
    return dp.data_parallel_mesh(device), False


def run_experiment(
    cfg_file: str,
    overrides: Optional[List[str]] = None,
    device="cuda",
    use_mesh: bool = False,
) -> ExperimentConfig:
    """Run the cfg's experiment on `device`; `use_mesh` (`--mesh`) or
    `[exp] multi_gpu = True` makes it data-parallel (module docstring)."""
    device = resolve_device(device)
    # TPUKALDI_PROFILE_DIR: a profiler trace of the whole run, written when
    # it ends, by an exception too (tpukaldi/tools/run_exp.py:91-110)
    profile_dir = os.environ.get("TPUKALDI_PROFILE_DIR")
    if not profile_dir:
        return _run_experiment(cfg_file, overrides, device, use_mesh)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        return _run_experiment(cfg_file, overrides, device, use_mesh)
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"run_exp_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def _run_experiment(cfg_file: str, overrides: Optional[List[str]],
                    device, use_mesh: bool = False) -> ExperimentConfig:
    exp = load_config(cfg_file, overrides=overrides)
    # what the port cannot run raises before any output is written
    check_run_knobs(exp)
    mesh, made = None, False
    if use_mesh or exp.multi_gpu:
        mesh, made = _join_mesh(device)
        if mesh is None:
            # one process per visible card, each joining one NCCL group
            world = torch.cuda.device_count()
            logging.info("data-parallel run over %d cards", world)
            torch.multiprocessing.start_processes(
                _spawned_rank, args=(world, _free_port(), cfg_file,
                                     overrides),
                nprocs=world, start_method="spawn")
            return exp
        device = mesh.device
    try:
        runtime = ChunkRuntime(exp, device, mesh)
        # after the runtime, whose device resolution pins float32
        with matmul_precision():
            return _run(exp, runtime)
    finally:
        if made:
            torch.distributed.destroy_process_group()


def _run(exp: ExperimentConfig, runtime: ChunkRuntime) -> ExperimentConfig:
    out_folder = exp.out_folder
    mesh, writes = runtime.mesh, runtime.writes
    if writes:
        os.makedirs(os.path.join(out_folder, "exp_files"), exist_ok=True)
        # snapshot the resolved config (reference run_exp.py:122-124)
        with open(os.path.join(out_folder, "conf.cfg"), "w") as f:
            exp.raw.write(f)

        # model diagram (reference renders model.svg at startup,
        # utils.py:1703); as in tpukaldi, a failure is logged and never
        # stops training
        try:
            from .diagram import create_block_diagram

            create_block_diagram(exp, os.path.join(out_folder, "model.svg"))
        except Exception as e:
            _log(out_folder, f"[diagram] skipped: {e}")
    # the other ranks plan in the folders rank 0 made
    dp.barrier(mesh)

    # the same plan tpukaldi builds (same knobs), so the two share ledgers
    # and checkpoints
    n_valid = int(exp.raw["exp"].get("nr_of_valid_per_epoch", "1"))
    ckpt_every = int(os.environ.get(
        "TPUKALDI_CKPT_EVERY", exp.raw["exp"].get("ckpt_every_n_chunks", "1")))
    plan = build_plan(exp, n_valid_per_epoch=n_valid, ckpt_every=ckpt_every)
    if writes:
        for removed in repair_resume_point(plan):
            _log(out_folder, f"[resume] {removed} invalidated (no "
                 "restorable checkpoint); the chunk will be replayed "
                 "deterministically")
    # every rank reads the same ledger, as rank 0 left it
    dp.barrier(mesh)
    # multi-host: the forward stage split before the prefetch schedule is
    # built (tpukaldi/tools/run_exp.py:186-190), and run by rank 0 of each
    # host only
    n_hosts, host_id = forward_hosts()
    if n_hosts > 1:
        plan.forward_tasks = plan.shard_forward_tasks(host_id, n_hosts)
    if mesh.local_rank != 0:
        plan.forward_tasks = []
    res_file = os.path.join(out_folder, "res.res")
    if writes and not os.path.exists(res_file):
        open(res_file, "w").close()
    feeder = ChunkFeeder(exp, plan, runtime)
    _train(exp, plan, runtime, feeder, res_file)

    # training curves (reference utils.py:2495-2614): the txt exports, and
    # the PNGs where matplotlib is installed; a failure is logged only
    if plan.epochs and writes:
        try:
            from .metrics import create_curves, export_txt

            export_txt(res_file, out_folder)
            create_curves(res_file, out_folder)
        except Exception as e:
            _log(out_folder, f"[curves] skipped: {e}")

    # final checkpoints (reference run_exp.py:412-414): the asynchronous
    # writer finishes before the files are copied
    runtime.checkpointer.wait()
    if plan.epochs and writes:
        last_train = [t for t in plan.epochs[-1].tasks if t.phase == "train"][-1]
        for arch, final in plan.final_ckpts.items():
            src = last_train.ckpt_files[arch]
            if os.path.exists(src) and not os.path.exists(final):
                shutil.copyfile(src, final)
    # the forward ranks read the final checkpoints rank 0 wrote
    dp.barrier(mesh)
    if mesh.local_rank != 0:
        return exp

    # production mode consumes final checkpoints from a previous training
    # run (reference run_exp.py:168-174): never forward random weights
    if exp.production:
        missing = [p for p in plan.final_ckpts.values() if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                "production mode needs trained final checkpoints; missing: "
                + ", ".join(missing))

    resolve_count_files(exp, os.path.join(out_folder, "exp_files"))

    # ---------------- forward ----------------
    ark_files: Dict[str, List[str]] = {}
    for task in plan.forward_tasks:
        if not task.done:
            task.write_lst_files()
            write_chunk_cfg(exp, task)
            runtime.run_task(task, chunk=feeder.get_chunk(task))
        for i, out in enumerate(exp.forward.outs):
            suffix = "_to_decode.ark" if exp.forward.require_decoding[i] else ".ark"
            ark = task.info_file.replace(".info", f"_{out}{suffix}")
            if os.path.exists(ark):
                ark_files.setdefault(f"{task.dataset}|{out}", []).append(ark)

    # ---------------- decode (as tpukaldi/tools/run_exp.py:404-461) ----------
    log_file = os.path.join(out_folder, "log.log")
    for key, arks in ark_files.items():
        ds_name, out_name = key.split("|")
        i = exp.forward.outs.index(out_name)
        if not exp.forward.require_decoding[i]:
            continue
        ds = exp.datasets[ds_name]
        lab = next(iter(ds.labels.values())) if ds.labels else ds.prod_lab
        if lab is None:
            continue
        # decode-stage ledger: a restart after decoding never re-decodes
        dec_info = os.path.join(
            out_folder, "exp_files", f"decoding_{ds_name}_{out_name}.info")
        if os.path.exists(dec_info):
            continue
        dec_dir = run_decode(exp, lab, out_name, ds_name, arks, log_file)
        if not dec_dir:
            continue
        best = harvest_wer(dec_dir)
        if best is None:
            # keep the arks and no ledger, so a restart retries the decode
            _log(out_folder, f"[decode] no WER found under {dec_dir}; ledger "
                 "not written — decoding will re-run on restart")
            continue
        with open(res_file, "a") as f:
            f.write(best["line"] + "\n")
        _log(out_folder, best["line"])
        with open(dec_info, "w") as f:
            f.write("[decoding]\n")
            f.write(f"decode_folder={dec_dir}\n")
            f.write(f"wer={best['wer']}\n")
            f.write(f"wer_line={best['line']}\n")
        # save_out_file=False drops the arks once scoring succeeded
        if not exp.forward.save_out_file[i]:
            for ark in arks:
                if os.path.exists(ark):
                    os.remove(ark)
    return exp


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpukaldi_torch.tools.run_exp",
        description="Train, forward and decode a tpukaldi cfg on PyTorch.")
    parser.add_argument("cfg")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; no CPU fallback)")
    parser.add_argument("--mesh", action="store_true",
                        help="data-parallel training, as [exp] multi_gpu = "
                        "True")
    parser.add_argument("--check-data", action="store_true",
                        help="validate the data tree the cfg points at and "
                        "exit without training (rc 1 on errors)")
    args, overrides = parser.parse_known_args(argv)
    try:
        if args.check_data:
            from .check_data import run_check

            return run_check(args.cfg, overrides)
        run_experiment(args.cfg, overrides=overrides, device=args.device,
                       use_mesh=args.mesh)
    except ConfigError as e:
        print(f"config error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
