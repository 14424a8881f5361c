"""Standalone single-chunk runner: execute ONE planner-written chunk cfg on
PyTorch (counterpart of `tpukaldi/tools/run_chunk.py`).

    python -m tpukaldi_torch.tools.run_chunk out/exp_files/train_..._ck00.cfg \\
        [--device cuda]

The reference schedules chunks as separate processes (`run_exp.py` launches
`core.run_nn(config_chunk_file)` per chunk, optionally through the `cmd`
prefix); every chunk cfg the shared planner writes (`plan/chunk_cfg.py`) is
directly executable here too.  It loads the chunk's .lst feature lists,
restores the `arch_pretrain_file` checkpoints (weights and optimizer
state), runs the task (train/valid/forward per `to_do`) and writes the
`.info` ledger entry and, for train, the `<base>_<arch>.ckpt` files, as an
in-process run of the same task does.
"""

from __future__ import annotations

import argparse
import configparser
import os
import re
import sys
import tempfile
from typing import List, Optional

from tpukaldi.config.cfg import ExperimentConfig, load_config
from tpukaldi.plan.planner import ChunkTask

from ..train.chunk_runtime import ChunkRuntime
from .run_exp import resolve_device


# _globalize_chunk_cfg and _task_from_info copy tpukaldi's
# (tools/run_chunk.py:32-123): that module imports JAX.
def _globalize_chunk_cfg(chunk_cfg_path: str) -> tuple:
    """Rewrite a chunk cfg into an equivalent single-dataset global cfg so
    the standard loader/validator applies.  Returns (tmp_cfg_path, to_do,
    out_info, seed)."""
    src = configparser.ConfigParser()
    src.optionxform = str
    if not src.read(chunk_cfg_path):
        raise FileNotFoundError(chunk_cfg_path)
    if "data_chunk" not in src:
        raise ValueError(
            f"{chunk_cfg_path} is not a chunk cfg (no [data_chunk] section)")
    to_do = src["exp"]["to_do"]
    out_info = src["exp"]["out_info"]
    seed = int(src["exp"].get("seed", "1234"))

    out = configparser.ConfigParser()
    out.optionxform = str
    out["cfg_proto"] = {
        "cfg_proto": "proto/global.proto",
        "cfg_proto_chunk": "proto/global_chunk.proto",
    }
    exp_sec = {k: v for k, v in src["exp"].items()
               if k not in ("to_do", "out_info")}
    # exp_files/<...>.info -> experiment out_folder is its grandparent
    exp_sec["out_folder"] = os.path.dirname(os.path.dirname(out_info)) or "."
    out["exp"] = exp_sec
    out["dataset1"] = {
        "data_name": "chunk",
        "fea": src["data_chunk"]["fea"],
        "lab": src["data_chunk"].get("lab", ""),
        "n_chunks": "1",
    }
    out["data_use"] = {
        "train_with": "chunk",
        "valid_with": "chunk",
        "forward_with": "chunk",
    }
    for sec in src.sections():
        if sec in ("cfg_proto", "exp", "data_chunk", "data_use"):
            continue
        out[sec] = dict(src[sec])
    # chunk cfgs drop the curriculum fields (reference
    # proto/global_chunk.proto): the epoch's value is already baked into
    # max_seq_length_train
    out["batches"].setdefault("increase_seq_length_train", "False")
    out["batches"].setdefault("start_seq_len_train", "100")
    out["batches"].setdefault("multply_factor_seq_len_train", "2")

    fd, tmp = tempfile.mkstemp(suffix=".cfg", prefix="chunk_glob_")
    with os.fdopen(fd, "w") as f:
        out.write(f)
    return tmp, to_do, out_info, seed


def _task_from_info(exp: ExperimentConfig, to_do: str, out_info: str,
                    seed: int) -> ChunkTask:
    m = re.search(r"ep(\d+)", os.path.basename(out_info))
    epoch = int(m.group(1)) if m else 0
    m = re.search(r"_ck(\d+)", os.path.basename(out_info))
    chunk = int(m.group(1)) if m else 0
    base = out_info[: -len(".info")] if out_info.endswith(".info") else out_info
    ds = exp.datasets["chunk"]
    # the chunk cfg's fea_lst entries already point at materialized .lst
    # files: reuse them verbatim (write_lst_files is then idempotent)
    lst_files = {s: spec.lst for s, spec in ds.features.items()}
    fea_lists = {}
    for s, p in lst_files.items():
        with open(p) as f:
            fea_lists[s] = [line.rstrip("\n") for line in f]
    ckpt_files = ({a: f"{base}_{a}.ckpt" for a in exp.archs}
                  if to_do == "train" else {})
    pretrain = {name: arch.pretrain_file for name, arch in exp.archs.items()
                if arch.pretrain_file not in ("none", "")}
    return ChunkTask(
        phase=to_do, dataset="chunk", epoch=epoch, chunk=chunk, seed=seed,
        fea_lists=fea_lists, lst_files=lst_files, info_file=out_info,
        ckpt_files=ckpt_files, pretrain_files=pretrain,
    )


def run_chunk(chunk_cfg_path: str, device="cuda") -> str:
    """Execute one chunk cfg on `device`; returns the .info path written."""
    device = resolve_device(device)
    tmp, to_do, out_info, seed = _globalize_chunk_cfg(chunk_cfg_path)
    try:
        exp = load_config(tmp)
    finally:
        os.unlink(tmp)
    task = _task_from_info(exp, to_do, out_info, seed)
    b = exp.batches
    phase = "train" if to_do == "train" else "valid"
    ChunkRuntime(exp, device).run_task(
        task,
        epoch_lr={name: arch.lr[0] for name, arch in exp.archs.items()},
        max_seq_length=b.msl_for_phase(phase, 0),
        batch_size=(b.batch_size_train[0] if to_do == "train"
                    else b.batch_size_valid),
    )
    return task.info_file


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpukaldi_torch.tools.run_chunk",
        description="Run one planner-written chunk cfg on PyTorch.")
    parser.add_argument("chunk_cfg")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; no CPU fallback)")
    args = parser.parse_args(argv)
    print(f"wrote {run_chunk(args.chunk_cfg, args.device)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
