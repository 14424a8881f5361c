"""Experiment driver for the port (counterpart of `tpukaldi/tools/run_exp.py`,
reference run_exp.py:1-621).

  python -m tpukaldi_torch.tools.run_exp cfg/exp.cfg [--device cuda] \\
      [--section,field=value ...]

Drives: config load -> plan -> (train chunks with interleaved validation ->
new-bob lr annealing) x epochs -> res.res -> final checkpoints -> forward
posteriors -> Kaldi decode bridge, on the shared config, planner, ledger and
decode code.  Crash recovery goes through the `.info` ledger as in
tpukaldi: done tasks are skipped on restart.  `--device cuda` without a CUDA
device is an error; there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tpukaldi.config import ConfigError, load_config
from tpukaldi.config.cfg import ExperimentConfig
from tpukaldi.decode.bridge import harvest_wer, run_decode
from tpukaldi.forward.counts import resolve_count_files
from tpukaldi.plan import ChunkTask, build_plan, repair_resume_point
from tpukaldi.plan.chunk_cfg import write_chunk_cfg

from ..train.chunk_runtime import ChunkResult, ChunkRuntime, read_info

# per-chunk phases summed into the `phases ep=` line of res.res
_PHASES = ("host_batch", "h2d", "dispatch", "drain", "ckpt_write",
           "restore_wait")


def _log(out_folder: str, msg: str) -> None:
    print(msg)
    with open(os.path.join(out_folder, "log.log"), "a") as f:
        f.write(msg + "\n")


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch sees no CUDA device "
            f"(torch {torch.__version__}); pass --device cpu to run on the CPU")
    return device


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


def _train(exp: ExperimentConfig, plan, runtime: ChunkRuntime,
           res_file: str) -> None:
    """The epoch loop (tpukaldi/tools/run_exp.py:167-337): train chunks in
    order, each validation point aggregating the valid tasks after it,
    new-bob halving of every auto-annealed arch's lr, and per epoch an
    `ep=` line and a `phases ep=` line in res.res."""
    out_folder = exp.out_folder
    # annealing is on iff the user gave a single-value schedule (reference
    # run_exp.py:151-161)
    lr: Dict[str, List[float]] = {a: list(s.lr) for a, s in exp.archs.items()}
    auto_anneal = {a: "|" not in exp.raw[s.section]["arch_lr"]
                   for a, s in exp.archs.items()}
    prev_valid_err: Optional[float] = None
    for ep_plan in plan.epochs:
        ep = ep_plan.epoch
        t_ep = time.time()
        host_load = 0.0
        tr_results: List[ChunkResult] = []
        ep_valid_results: List[ChunkResult] = []
        valid_perf: Dict[str, ChunkResult] = {}
        pending_valid: List[ChunkResult] = []
        valid_names: List[str] = []
        _log(out_folder, f"------ Epoch {ep} / {exp.n_epochs - 1} ------")

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
                             f"[new-bob] halving lr of {arch} -> {new_lr}")
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
                task.write_lst_files()
                write_chunk_cfg(exp, task, lr=epoch_lr, batch_size=bs,
                                max_seq_length=msl)
                t0 = time.perf_counter()
                chunk = runtime.load_task_chunk(task, msl)
                host_load += time.perf_counter() - t0
                res = runtime.run_task(task, epoch_lr=epoch_lr,
                                       max_seq_length=msl, batch_size=bs,
                                       chunk=chunk)
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
        dump_epoch_results(res_file, ep, exp.n_epochs, exp.train_with,
                           tr_loss, tr_err, valid_perf, lr, epoch_wall)
        # where the epoch's wall time went (skipped by "ep="-prefixed parsers)
        valid_wall = sum(r.elapsed for r in ep_valid_results)
        phases = "".join(
            f" {k}={sum((r.phases or {}).get(k, 0.0) for r in tr_results + ep_valid_results):.2f}"
            for k in _PHASES)
        other = max(epoch_wall - tr_time - valid_wall - host_load, 0.0)
        with open(res_file, "a") as rf:
            rf.write(f"phases ep={ep} host_load={host_load:.2f} "
                     f"train_wall={tr_time:.2f} valid_wall={valid_wall:.2f}"
                     f"{phases} driver_other={other:.2f} "
                     f"epoch_wall={epoch_wall:.2f}\n")


def run_experiment(
    cfg_file: str,
    overrides: Optional[List[str]] = None,
    device="cuda",
) -> ExperimentConfig:
    device = resolve_device(device)
    exp = load_config(cfg_file, overrides=overrides)
    out_folder = exp.out_folder
    os.makedirs(os.path.join(out_folder, "exp_files"), exist_ok=True)
    # snapshot the resolved config (reference run_exp.py:122-124)
    with open(os.path.join(out_folder, "conf.cfg"), "w") as f:
        exp.raw.write(f)

    # the same plan tpukaldi builds (same knobs), so the two share ledgers
    # and checkpoints
    n_valid = int(exp.raw["exp"].get("nr_of_valid_per_epoch", "1"))
    ckpt_every = int(os.environ.get(
        "TPUKALDI_CKPT_EVERY", exp.raw["exp"].get("ckpt_every_n_chunks", "1")))
    plan = build_plan(exp, n_valid_per_epoch=n_valid, ckpt_every=ckpt_every)
    for removed in repair_resume_point(plan):
        _log(out_folder, f"[resume] {removed} invalidated (no restorable "
             "checkpoint); the chunk will be replayed deterministically")
    runtime = ChunkRuntime(exp, device)

    res_file = os.path.join(out_folder, "res.res")
    if not os.path.exists(res_file):
        open(res_file, "w").close()
    _train(exp, plan, runtime, res_file)

    # final checkpoints (reference run_exp.py:412-414)
    if plan.epochs:
        last_train = [t for t in plan.epochs[-1].tasks if t.phase == "train"][-1]
        for arch, final in plan.final_ckpts.items():
            src = last_train.ckpt_files[arch]
            if os.path.exists(src) and not os.path.exists(final):
                shutil.copyfile(src, final)

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
            runtime.run_task(task)
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
    args, overrides = parser.parse_known_args(argv)
    try:
        run_experiment(args.cfg, overrides=overrides, device=args.device)
    except ConfigError as e:
        print(f"config error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
