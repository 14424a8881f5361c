"""One rank of the port's data-parallel CPU tests
(tests/test_torch_port_dist.py): joins a gloo group, runs the train-step
cases the test wrote, then the data-parallel `run_experiment` runs it asks
for, and saves what each gave.  It imports torch and tpukaldi_torch only.

    python tests/torch_port_dist_worker.py <rank> <world> <port> <workdir>

Not a test module (pytest collects test_*.py only).  The test imports
`make_exp` and `CASES` from it, so both sides build the same graphs.
"""

import builtins
import json
import os
import sys
from types import SimpleNamespace

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tpukaldi_torch.config.model_dsl import parse_model  # noqa: E402

SEQ_PROGRAM = """
out_dnn1=compute(liGRU_layers,fmllr)
out_dnn2=compute(MLP_layers,out_dnn1)
out_dnn3=compute(MLP_layers2,out_dnn1)
loss_mono=cost_nll(out_dnn3,lab_mono)
loss_cd=cost_nll(out_dnn2,lab_cd)
loss_final=sum(loss_cd,loss_mono)
err_final=cost_err(out_dnn2,lab_cd)
"""
FRAME_PROGRAM = """
out_dnn1=compute(MLP_layers1,fmllr)
loss_final=cost_nll(out_dnn1,lab_cd)
err_final=cost_err(out_dnn1,lab_cd)
"""
FEA = {"fmllr": (0, 6)}
LAB = {"lab_cd": 0, "lab_mono": 1}
N_CD, N_MONO = 9, 3
# case -> (sequence model, batch columns or frame rows, compute dtype)
CASES = {
    "ligru": (True, 8, None),
    "ligru_uneven": (True, 3, None),
    "mlp_frames": (False, 16, None),
    "ligru_bf16": (True, 8, "bfloat16"),
}


def make_exp(case: str, parse=parse_model):
    """The case's experiment: a 2x16 bidirectional liGRU (batchnorm, relu,
    drop 0) under two softmax heads, or a frame MLP (16 units with
    batchnorm, then softmax), plain sgd as tpukaldi's synthetic cfgs have
    it.  `parse` parses the [model] program (either package's parser)."""
    sgd = SimpleNamespace(kind="sgd", options={
        "opt_momentum": 0.0, "opt_weight_decay": 0.0, "opt_dampening": 0.0,
        "opt_nesterov": False})
    seq = CASES[case][0]

    def arch(name, cls, is_seq, **opts):
        return SimpleNamespace(name=name, class_name=cls,
                               library="tpukaldi.models", seq_model=is_seq,
                               freeze=False, options=opts, optimizer=sgd,
                               lr=[0.08])

    def head(n):
        return dict(dnn_lay=str(n), dnn_drop="0.0", dnn_use_batchnorm="False",
                    dnn_use_laynorm="False", dnn_use_laynorm_inp="False",
                    dnn_use_batchnorm_inp="False", dnn_act="softmax")

    if seq:
        archs = {
            "liGRU_layers": arch(
                "liGRU_layers", "liGRU", True, ligru_lay="16,16",
                ligru_drop="0.0,0.0", ligru_use_batchnorm="True,True",
                ligru_use_laynorm="False,False", ligru_act="relu,relu",
                ligru_bidir="True", ligru_orthinit="True"),
            "MLP_layers": arch("MLP_layers", "MLP", False, **head(N_CD)),
            "MLP_layers2": arch("MLP_layers2", "MLP", False, **head(N_MONO)),
        }
    else:
        archs = {"MLP_layers1": arch(
            "MLP_layers1", "MLP", False, dnn_lay=f"16,{N_CD}",
            dnn_drop="0.0,0.0", dnn_use_batchnorm="True,False",
            dnn_use_laynorm="False,False", dnn_use_laynorm_inp="False",
            dnn_use_batchnorm_inp="False", dnn_act="relu,softmax")}
    return SimpleNamespace(
        model=parse(SEQ_PROGRAM if seq else FRAME_PROGRAM), archs=archs,
        forward=SimpleNamespace(outs=["out_dnn2" if seq else "out_dnn1"]))


def run_step_case(case: str, workdir: str, mesh) -> dict:
    """One data-parallel train step of `case` from the weights and batch
    the test saved: this rank's loss, err and stepped state dicts."""
    from tpukaldi_torch.dist import shard_batch, shard_weight
    from tpukaldi_torch.graph import compiler
    from tpukaldi_torch.train.optimizers import make_all_optimizers
    from tpukaldi_torch.train.step import train_step

    inp = torch.load(os.path.join(workdir, f"{case}.pt"))
    exp = make_exp(case)
    graph = compiler.build_graph(exp, FEA, LAB, "cpu")
    for name, module in graph.modules.items():
        module.load_state_dict(inp["state"][name])
    opts = make_all_optimizers(graph.archs, graph.modules)
    feats, labs = inp["feats"], inp["labs"]
    rows = feats.shape[1] if feats.ndim == 3 else feats.shape[0]
    dtype = CASES[case][2]
    loss, err = train_step(
        graph, opts, shard_batch(feats, mesh).contiguous(),
        shard_batch(labs, mesh).contiguous(), inp["n_valid"],
        compute_dtype=getattr(torch, dtype) if dtype else None,
        mesh=mesh, weight=shard_weight(rows, mesh))
    return {"loss": loss.item(), "err": err.item(),
            "state": {n: m.state_dict() for n, m in graph.modules.items()}}


def watch_writes(folder: str, seen: list) -> None:
    """Record every open for writing of a file under `folder`."""
    real_open = builtins.open
    folder = os.path.abspath(folder)

    def spy(file, mode="r", *args, **kwargs):
        if (isinstance(file, (str, os.PathLike))
                and os.path.abspath(file).startswith(folder)
                and any(c in mode for c in "wax+")):
            seen.append(os.fspath(file))
        return real_open(file, mode, *args, **kwargs)

    builtins.open = spy


def main(rank: int, world: int, port: int, workdir: str) -> None:
    from tpukaldi_torch.dist import (
        data_parallel_mesh,
        global_batch_from_host_shards,
        init_distributed,
        shard_batch,
    )
    from tpukaldi_torch.tools.run_exp import run_experiment

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = data_parallel_mesh("cpu")
    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    out = {case: run_step_case(case, workdir, mesh) for case in job["steps"]}
    # each rank's shard of an uneven batch, gathered back on every rank
    full = torch.arange(5 * 3 * 2, dtype=torch.float32).reshape(5, 3, 2)
    out["gathered"] = global_batch_from_host_shards(
        shard_batch(full, mesh), mesh)
    writes: list = []
    for run in job["runs"]:
        if rank != 0:
            watch_writes(run["out"], writes)
        os.environ.update(run["env"])
        run_experiment(run["cfg"], device="cpu",
                       use_mesh=run.get("mesh", False))
    out["rank_writes"] = writes
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    print(f"DIST_WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
