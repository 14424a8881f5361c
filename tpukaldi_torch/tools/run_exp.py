"""Experiment driver for the port (counterpart of `tpukaldi/tools/run_exp.py`,
reference run_exp.py:1-621).

  python -m tpukaldi_torch.tools.run_exp cfg/exp.cfg [--device cuda] \\
      [--section,field=value ...]

Drives: config load -> plan -> final checkpoints -> forward posteriors ->
Kaldi decode bridge, on the shared config, planner, ledger and decode code.
Training is not ported yet, so every training task of the plan must already
be done (its `.info` ledger entry exists, e.g. from a tpukaldi run) — in
production (transcription-only) mode the plan has none.  `--device cuda`
without a CUDA device is an error; there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Dict, List, Optional

import torch

from tpukaldi.config import ConfigError, load_config
from tpukaldi.config.cfg import ExperimentConfig
from tpukaldi.decode.bridge import harvest_wer, run_decode
from tpukaldi.forward.counts import resolve_count_files
from tpukaldi.plan import build_plan, repair_resume_point
from tpukaldi.plan.chunk_cfg import write_chunk_cfg

from ..train.chunk_runtime import ChunkRuntime


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

    # the same plan tpukaldi builds (same knobs), so the port picks up the
    # ledger and checkpoints of a tpukaldi training run
    n_valid = int(exp.raw["exp"].get("nr_of_valid_per_epoch", "1"))
    ckpt_every = int(os.environ.get(
        "TPUKALDI_CKPT_EVERY", exp.raw["exp"].get("ckpt_every_n_chunks", "1")))
    plan = build_plan(exp, n_valid_per_epoch=n_valid, ckpt_every=ckpt_every)
    for removed in repair_resume_point(plan):
        _log(out_folder, f"[resume] {removed} invalidated (no restorable "
             "checkpoint); the chunk will be replayed deterministically")
    pending = [t.info_file for ep in plan.epochs for t in ep.tasks if not t.done]
    if pending:
        raise NotImplementedError(
            f"{len(pending)} training/validation tasks are not done (first: "
            f"{pending[0]}); training is not ported to tpukaldi_torch yet — "
            "train with tpukaldi, or run a production cfg")

    res_file = os.path.join(out_folder, "res.res")
    if not os.path.exists(res_file):
        open(res_file, "w").close()

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
    runtime = ChunkRuntime(exp, device)
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
        description="Forward (posterior) stage of a tpukaldi cfg on PyTorch.")
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
