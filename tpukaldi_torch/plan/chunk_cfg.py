"""Chunk-cfg materialization: write the per-task `.cfg` files the reference
pre-generates for every (epoch, chunk) (utils.py:853 `create_configs`,
:1327 `write_cfg_chunk`; schema proto/global_chunk.proto).

tpukaldi executes from in-memory tasks, so these files are ledger artifacts
for inspection and external tooling — but they are faithful: to_do/out_info,
chunk-specific fea lists, scheduled lr/batch-size/seq-length/dropout and
rolling pretrain pointers are all resolved, and the result re-validates
against the chunk proto.

Standalone bit-identical re-execution (tools/run_chunk.py) holds at the
default `ckpt_every=1` (the reference's per-chunk checkpoint cadence).
With `ckpt_every>1`, tasks between checkpoint boundaries record the last
SAVED checkpoint as their pretrain pointer while the in-process run carries
un-checkpointed state — re-executing such a cfg standalone reproduces the
boundary state, not the mid-cadence ledger entry (crash resume handles
this by replaying the whole tail, plan/planner.py:repair_resume_point).
"""

from __future__ import annotations

import configparser
import re
from typing import Dict, Optional

from ..config.cfg import ExperimentConfig
from .planner import ChunkTask


def write_chunk_cfg(
    exp: ExperimentConfig,
    task: ChunkTask,
    lr: Optional[Dict[str, float]] = None,
    batch_size: Optional[int] = None,
    max_seq_length=None,
    drop_values: Optional[Dict[str, str]] = None,
) -> str:
    """Materialize one chunk cfg next to the task's .info file."""
    src = exp.raw
    cfg = configparser.ConfigParser()

    cfg["cfg_proto"] = {
        "cfg_proto": src.get("cfg_proto", "cfg_proto",
                             fallback="proto/global.proto"),
        "cfg_proto_chunk": src.get("cfg_proto", "cfg_proto_chunk",
                                   fallback="proto/global_chunk.proto"),
    }
    cfg["exp"] = {
        "cmd": src.get("exp", "cmd", fallback=""),
        "run_nn_script": exp.run_nn_script,
        "to_do": task.phase,
        "seed": str(task.seed),
        "use_cuda": src.get("exp", "use_cuda", fallback="False"),
        "multi_gpu": src.get("exp", "multi_gpu", fallback="False"),
        "save_gpumem": src.get("exp", "save_gpumem", fallback="False"),
        "out_info": task.info_file,
        "n_epochs_tr": str(exp.n_epochs),
    }
    # optional mixed-precision knob: a standalone run_chunk execution must
    # compute in the same dtype as the in-process run or its ledger entry
    # (loss/err) would not be bit-identical
    if src.has_option("exp", "compute_dtype"):
        cfg["exp"]["compute_dtype"] = src.get("exp", "compute_dtype")

    # [data_chunk]: the dataset's fea/lab blocks with the chunk's .lst files
    ds = exp.datasets[task.dataset]
    sec = exp.raw[ds.section]
    fea_block = sec["fea"]
    for stream, lst_path in task.lst_files.items():
        fea_block = re.sub(
            rf"(fea_name={stream}\n\s*fea_lst=)\S+",
            lambda m: m.group(1) + lst_path,
            fea_block,
        )
    cfg["data_chunk"] = {"fea": fea_block, "lab": sec.get("lab", "")}

    b = exp.batches
    ep = task.epoch
    msl = max_seq_length if max_seq_length is not None else (
        b.seq_length_for_epoch(ep) if task.phase == "train"
        else b.max_seq_length_valid
    )
    if isinstance(msl, (list, tuple)):
        msl = ",".join(str(v) for v in msl)
    cfg["batches"] = {
        "batch_size_train": str(
            batch_size if batch_size is not None else b.batch_size_train[ep]
        ),
        "max_seq_length_train": str(msl),
        "batch_size_valid": str(b.batch_size_valid),
        "max_seq_length_valid": str(b.max_seq_length_valid),
    }

    for name, arch in exp.archs.items():
        section = dict(exp.raw[arch.section])
        section["arch_lr"] = str((lr or {}).get(name, arch.lr[ep]))
        section["arch_pretrain_file"] = task.pretrain_files.get(name, "none")
        if drop_values and name in drop_values and arch.drop_field:
            section[arch.drop_field] = drop_values[name]
        elif arch.drop_schedules and arch.drop_field:
            section[arch.drop_field] = ",".join(
                str(s[ep]) for s in arch.drop_schedules
            )
        cfg[arch.section] = section

    cfg["model"] = dict(exp.raw["model"])
    cfg["forward"] = dict(exp.raw["forward"])

    path = task.info_file.replace(".info", ".cfg")
    with open(path, "w") as f:
        cfg.write(f)
    return path
