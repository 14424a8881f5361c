"""The port's data parallelism (`tpukaldi_torch/dist/`) on the CPU, against
tpukaldi's mesh (tests/test_dist.py, tests/test_multihost.py).

Two gloo worker processes (`torch_port_dist_worker.py`, started as
tests/test_multihost.py starts its two) run, in one launch:

- one train step of each case in `CASES` from weights that tpukaldi
  initialised (`from_jax_params`), each rank on its shard of the batch, at
  drop 0 (tpukaldi's threefry masks cannot be drawn in torch): a 2x16
  bidirectional liGRU with batchnorm on batch 8, held to tpukaldi's
  `make_train_step` on its 8-device virtual CPU mesh and on one device at
  tests/test_dist.py's tolerances (loss 1e-5, err 1e-6, parameters and
  batch statistics rtol 1e-4 / atol 1e-6); the same on batch 3, split 2/1,
  which tpukaldi's mesh cannot split, against its one-device step; a frame
  MLP with batchnorm on 16 rows; and the liGRU in bf16: its loss within
  1e-2 of tpukaldi's bf16 mesh step, its weights at test_dist.py's bf16
  tolerances (rtol 1e-2, atol 1e-4) of the port's one-process bf16 step
  (the packages round bf16 products apart; tests/test_torch_port_bf16.py
  holds that).  Both ranks end with the same weights.
- `run_experiment` of a tiny flagship liGRU cfg (drop 0) with
  `multi_gpu = True` under the 2-rank group, at TPUKALDI_MULTISTEP 1 and 2
  (as tests/test_dist.py's `test_multistep_with_mesh`): res.res within
  1e-3 of the one-process run, the same files, and rank 1 opens no file of
  the run's folder for writing.

In this process: the device cache's auto is off at world size 2, and
`TPUKALDI_NUM_HOSTS=2` splits the forward ledger into disjoint halves whose
union is the one-host set (tests/test_multihost.py's
`test_forward_stage_partitions_across_hosts`, on the port).

K6's hash-mask dropout (CNN_raw's layer 0) indexes windows within a rank's
shard, and its seed comes from the rank's generator, as every dropout mask
of a rank does (`chunk_runtime.batch_seed`): at drop > 0 two ranks draw
other masks than one process, independent across ranks;
`test_rank_seeds` holds that, and rank 0's seed to the one-process seed.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.config.model_dsl import parse_model as tpk_parse_model
from tpukaldi.dist import data_parallel_mesh as tpk_mesh
from tpukaldi.dist import replicate as tpk_replicate
from tpukaldi.dist import shard_batch as tpk_shard_batch
from tpukaldi.graph import compiler as jax_compiler
from tpukaldi.train.optimizers import make_optimizer
from tpukaldi.train.step import make_train_step
from tpukaldi_torch.compat.jax_params import from_jax_params, to_jax_params
from tpukaldi_torch.dist import DataParallelMesh, shard_batch, shard_bounds
from tpukaldi_torch.tools.flagship_tree import (
    train_plan,
    write_kaldi_tree,
    write_train_cfg,
)
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train.chunk_runtime import ChunkRuntime, batch_seed

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_dist_worker import (  # noqa: E402
    CASES,
    FEA,
    LAB,
    N_CD,
    N_MONO,
    make_exp,
    run_step_case,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_dist_worker.py")
T, N_VALID = 12, 9
DIM = 6
SPLITS = {"train": (8, 30, 50), "dev": (4, 30, 50), "test": (4, 30, 60)}
SHRINK = {
    "ligru_lay = 550,550,550,550,550": "ligru_lay = 16,16",
    "ligru_drop = 0.2,0.2,0.2,0.2,0.2": "ligru_drop = 0.0,0.0",
    "ligru_use_laynorm = False,False,False,False,False":
        "ligru_use_laynorm = False,False",
    "ligru_use_batchnorm = True,True,True,True,True":
        "ligru_use_batchnorm = True,True",
    "ligru_act = relu,relu,relu,relu,relu": "ligru_act = relu,relu",
    "n_epochs_tr = 24": "n_epochs_tr = 1",
    "n_chunks = 5": "n_chunks = 1",
    "batch_size_train = 8": "batch_size_train = 4",
    "batch_size_valid = 8": "batch_size_valid = 4",
}
# the one-process step: no group
ONE_PROCESS = DataParallelMesh(0, 1, 0, torch.device("cpu"), "")
RUNS = {"k1": {"TPUKALDI_MULTISTEP": "1"}, "k2": {"TPUKALDI_MULTISTEP": "2"}}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _case_inputs(case):
    """tpukaldi's init of the case's graph and a seeded batch: (params,
    stats, feats, labs) as numpy."""
    seq, rows, _ = CASES[case]
    rng = np.random.default_rng(5)
    if seq:
        feats = rng.standard_normal((T, rows, DIM)).astype(np.float32)
        labs = np.stack([rng.integers(0, N_CD, (T, rows)),
                         rng.integers(0, N_MONO, (T, rows))], axis=-1)
    else:
        feats = rng.standard_normal((rows, DIM)).astype(np.float32)
        labs = np.stack([rng.integers(0, N_CD, rows),
                         rng.integers(0, N_MONO, rows)], axis=-1)
    exp = make_exp(case, tpk_parse_model)
    graph = jax_compiler.build_graph(exp, FEA, LAB)
    params, stats = jax_compiler.init_graph(graph, jax.random.key(3),
                                            jnp.asarray(feats))
    return (exp, graph, jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, stats), feats,
            labs.astype(np.int32))


def _tpk_step(exp, graph, params, stats, feats, labs, n_valid, mesh, dtype):
    """tpukaldi's train step, on `mesh` (the batch sharded over its 'data'
    axis) or on one device: (params, stats, loss, err) as numpy."""
    optimizers = {n: make_optimizer(exp.archs[n]) for n in graph.arch_names}
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s = jax.tree_util.tree_map(jnp.asarray, stats)
    opt = {n: optimizers[n].init(p[n]) for n in graph.arch_names}
    step = make_train_step(graph, optimizers, mesh=mesh, donate=False,
                           compute_dtype=dtype)
    f, lab = jnp.asarray(feats), jnp.asarray(labs)
    if mesh is not None:
        p, s = tpk_replicate(p, mesh), tpk_replicate(s, mesh)
        axis = 1 if feats.ndim == 3 else 0
        f = tpk_shard_batch(feats, mesh, batch_axis=axis)
        lab = tpk_shard_batch(labs, mesh, batch_axis=axis)
    new_p, new_s, _, loss, err = step(p, s, opt, f, lab, jax.random.key(7),
                                      jnp.asarray(n_valid))
    return (jax.tree_util.tree_map(np.asarray, jax.device_get(new_p)),
            jax.tree_util.tree_map(np.asarray, jax.device_get(new_s)),
            float(loss), float(err))


def _flagship_cfg(tree, root, name, multi_gpu):
    out = os.path.join(root, name)
    os.makedirs(out)
    shrink = dict(SHRINK)
    if multi_gpu:
        shrink["multi_gpu = False"] = "multi_gpu = True"
    return write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                           shrink), out


def _res_numbers(out):
    """Every number of res.res's `ep=` lines but the wall time."""
    with open(os.path.join(out, "res.res")) as f:
        text = "\n".join(line for line in f.read().splitlines()
                         if line.startswith("ep="))
    text = re.sub(r"time\(s\)=\d+", "", text)
    return [float(x) for x in re.findall(r"=(-?\d+\.\d+(?:e-?\d+)?)", text)]


def _files(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, names in os.walk(out) for f in names)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_kaldi_tree(str(tmp_path_factory.mktemp("timit")), DIM,
                            n_phones=3, n_pdfs=9, splits=SPLITS)


@pytest.fixture(scope="module")
def launched(tmp_path_factory, tree):
    """The two gloo ranks' results (rank0.pt, rank1.pt), the cases' inputs
    and the one-process runs' folders."""
    work = str(tmp_path_factory.mktemp("dist"))
    inputs = {}
    for case in CASES:
        exp, graph, params, stats, feats, labs = _case_inputs(case)
        inputs[case] = (exp, graph, params, stats, feats, labs)
        state = {n: from_jax_params(exp.archs[n].class_name, params[n],
                                    stats.get(n, {}))
                 for n in graph.arch_names}
        torch.save({"state": state, "feats": torch.from_numpy(feats),
                    "labs": torch.from_numpy(labs), "n_valid": N_VALID},
                   os.path.join(work, f"{case}.pt"))
    runs, single = [], {}
    for name, env in RUNS.items():
        cfg, out = _flagship_cfg(tree, work, f"dist_{name}", True)
        runs.append({"cfg": cfg, "out": out, "env": env})
        single[name] = _flagship_cfg(tree, work, f"one_{name}", False)
    with open(os.path.join(work, "job.json"), "w") as f:
        json.dump({"steps": list(CASES), "runs": runs}, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", str(port), work],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for r in range(2)]
    # the one-process runs meanwhile, in this process
    saved = os.environ.get("TPUKALDI_MULTISTEP")
    try:
        for name, (cfg, _) in single.items():
            os.environ.update(RUNS[name])
            run_experiment(cfg, device="cpu")
    finally:
        if saved is None:
            os.environ.pop("TPUKALDI_MULTISTEP", None)
        else:
            os.environ["TPUKALDI_MULTISTEP"] = saved
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "DIST_WORKER_OK" in log, log[-4000:]
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    return ranks, inputs, runs, single, work


def _state_tree(exp, state):
    return {n: to_jax_params(sd, exp.archs[n].class_name)
            for n, sd in state.items()}


def _assert_close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_step_matches_tpukaldi(launched, case):
    """Each case's two-rank step against tpukaldi's mesh step (its
    one-device step where the mesh cannot split the batch), and rank 1's
    weights equal to rank 0's."""
    ranks, inputs, _, _, work = launched
    exp, graph, params, stats, feats, labs = inputs[case]
    bf16 = CASES[case][2] == "bfloat16"
    mesh = None if feats.shape[-2 if feats.ndim == 3 else 0] % 8 else tpk_mesh()
    want_p, want_s, want_loss, want_err = _tpk_step(
        exp, graph, params, stats, feats, labs, N_VALID, mesh,
        jnp.bfloat16 if bf16 else None)
    got = ranks[0][case]
    trees = _state_tree(exp, got["state"])
    if bf16:
        # the loss within 1e-2 of tpukaldi's bf16 mesh step; the weights at
        # tests/test_dist.py's bf16 tolerances of the port's own one-process
        # bf16 step (the two packages round bf16 products apart, which
        # tests/test_torch_port_bf16.py holds)
        assert abs(got["loss"] - want_loss) < 1e-2
        one = run_step_case(case, work, ONE_PROCESS)
        assert abs(got["loss"] - one["loss"]) < 1e-2
        for name, (got_p, got_s) in trees.items():
            want_one = _state_tree(exp, one["state"])[name]
            _assert_close(got_p, want_one[0], 1e-2, 1e-4, name)
            _assert_close(got_s, want_one[1], 1e-2, 1e-4, name)
        return
    assert abs(got["loss"] - want_loss) < 1e-5
    assert abs(got["err"] - want_err) < 1e-6
    for name in graph.arch_names:
        got_p, got_s = trees[name]
        _assert_close(got_p, want_p[name], 1e-4, 1e-6, name)
        _assert_close(got_s, want_s.get(name, {}), 1e-4, 1e-6,
                      f"{name} stats")
    assert ranks[1][case]["loss"] == got["loss"]
    for name, sd in ranks[1][case]["state"].items():
        for k, v in sd.items():
            assert torch.equal(v, got["state"][name][k]), (name, k)


def test_two_rank_step_matches_one_device_tpukaldi(launched):
    """The liGRU's two-rank step against tpukaldi's one-device step too:
    the mesh's psum and the ranks' sum are both the global gradient."""
    ranks, inputs, _, _, work = launched
    exp, graph, params, stats, feats, labs = inputs["ligru"]
    want_p, want_s, want_loss, want_err = _tpk_step(
        exp, graph, params, stats, feats, labs, N_VALID, None, None)
    got = ranks[0]["ligru"]
    assert abs(got["loss"] - want_loss) < 1e-5
    assert abs(got["err"] - want_err) < 1e-6
    for name, (got_p, got_s) in _state_tree(exp, got["state"]).items():
        _assert_close(got_p, want_p[name], 1e-4, 1e-6, name)
        _assert_close(got_s, want_s.get(name, {}), 1e-4, 1e-6, name)


@pytest.mark.parametrize("run", list(RUNS))
def test_multi_gpu_run_matches_one_process(launched, run):
    """run_experiment with multi_gpu = True under the 2-rank group: the
    one-process res.res within 1e-3, the same files in the run's folder,
    and no file of it opened for writing by rank 1."""
    ranks, _, runs, single, _ = launched
    dist_out = next(r["out"] for r in runs if r["env"] == RUNS[run])
    one_out = single[run][1]
    got, want = _res_numbers(dist_out), _res_numbers(one_out)
    assert got and len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert _files(dist_out) == _files(one_out)
    assert not [p for p in ranks[1]["rank_writes"]
                if p.startswith(dist_out)], ranks[1]["rank_writes"]


def test_host_shards_gather_to_the_global_batch(launched):
    """`global_batch_from_host_shards`: each rank's columns of a (5, 3, 2)
    batch (2 and 1) give every rank the whole batch back."""
    full = torch.arange(5 * 3 * 2, dtype=torch.float32).reshape(5, 3, 2)
    for rank in launched[0]:
        assert torch.equal(rank["gathered"], full)


def test_device_cache_auto_is_off_at_world_size_2(tree, tmp_path):
    """TPUKALDI_DEVICE_CACHE=auto takes the cache on a card at world size
    1 and not at world size 2 (tpukaldi: `self.mesh is None`); forced on,
    it stays on."""
    cfg, _ = _flagship_cfg(tree, str(tmp_path), "cache", True)
    exp, plan = train_plan(cfg)
    task = next(t for t in plan.epochs[0].tasks if t.phase == "train")
    rt = ChunkRuntime(exp, "cpu")
    # the auto rule reads only the device's type and the world size
    rt.device = torch.device("cuda")
    seen = {}
    for world in (1, 2):
        rt.mesh = DataParallelMesh(0, world, 0, torch.device("cpu"),
                                   "gloo" if world > 1 else "")
        for mode in ("auto", "1"):
            os.environ["TPUKALDI_DEVICE_CACHE"] = mode
            try:
                seen[(world, mode)] = rt._use_device_cache(task)
            finally:
                del os.environ["TPUKALDI_DEVICE_CACHE"]
    assert seen == {(1, "auto"): True, (1, "1"): True,
                    (2, "auto"): False, (2, "1"): True}


def test_shards_split_as_tensor_split():
    """Each rank's rows are torch.tensor_split's, B = 3 over 2 ranks too;
    a batch with fewer rows than ranks raises."""
    x = torch.arange(5 * 3 * 2).reshape(5, 3, 2)
    for world in (1, 2, 3):
        parts = torch.tensor_split(x, world, dim=1)
        for rank in range(world):
            mesh = DataParallelMesh(rank, world, rank, torch.device("cpu"),
                                    "gloo")
            assert torch.equal(shard_batch(x, mesh), parts[rank])
            assert torch.equal(shard_batch(x[0], mesh),
                               torch.tensor_split(x[0], world)[rank])
    with pytest.raises(ValueError, match="cannot be split"):
        shard_bounds(1, DataParallelMesh(0, 2, 0, torch.device("cpu"), "gloo"))


def test_rank_seeds():
    """Rank 0's dropout seed is the one-process seed; the other ranks'
    differ from it and from each other (independent masks per shard)."""
    for seed, index in ((0, 0), (17, 3), (2**40, 9)):
        seeds = [batch_seed(seed, index, r) for r in range(4)]
        assert seeds[0] == batch_seed(seed, index)
        assert len(set(seeds)) == 4
        assert all(0 <= s < 2**63 for s in seeds)


def test_forward_stage_partitions_across_hosts(tree, tmp_path, monkeypatch):
    """TPUKALDI_NUM_HOSTS=2: host 0 and host 1 write disjoint forward
    ledgers whose union is the one-host set."""
    monkeypatch.delenv("TPUKALDI_NUM_HOSTS", raising=False)
    monkeypatch.delenv("TPUKALDI_HOST_ID", raising=False)
    cfg, out = _flagship_cfg(tree, str(tmp_path), "hosts", False)
    with open(cfg) as f:
        head, sep, tail = f.read().partition("[dataset3]")
    with open(cfg, "w") as f:
        f.write(head + sep + tail.replace("n_chunks = 1", "n_chunks = 4", 1))
    run_experiment(cfg, device="cpu")
    ef = os.path.join(out, "exp_files")
    all_fwd = {f for f in os.listdir(ef)
               if f.startswith("forward_") and f.endswith(".info")}
    assert len(all_fwd) == 4
    for f in os.listdir(ef):
        if f.startswith("forward_") and f.endswith((".info", ".ark")):
            os.remove(os.path.join(ef, f))
    monkeypatch.setenv("TPUKALDI_NUM_HOSTS", "2")
    by_host = {}
    for host in (0, 1):
        monkeypatch.setenv("TPUKALDI_HOST_ID", str(host))
        run_experiment(cfg, device="cpu")
        done = {f for f in os.listdir(ef)
                if f.startswith("forward_") and f.endswith(".info")}
        by_host[host] = done - set().union(*by_host.values())
    assert by_host[0] and by_host[1], by_host
    assert not by_host[0] & by_host[1]
    assert by_host[0] | by_host[1] == all_fwd
