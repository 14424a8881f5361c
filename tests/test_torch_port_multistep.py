"""The port's K-step fused dispatch (`TPUKALDI_MULTISTEP`) on the CPU,
mirroring tests/test_e2e.py's `test_multistep_fusion_reproduces_unfused`
and `test_host_prefetch_reproduces_inline`.

On the CPU a group of K same-shape batches runs K eager steps; what runs
here is the grouping, the counters and the bookkeeping around them.  The
CUDA graph that runs a group on a card is held to the eager steps by
`chip_smoke.py`'s multistep phase, and by the `cuda`-marked case below
where a card exists.

- The port at K = 4 against K = 1 on a frame model (MLP, tpukaldi's
  synthetic corpus), and at K = 3 against K = 1 on a sequence model (liGRU
  over the synthetic Kaldi tree, a mix of groups and singles): the same
  `res.res` lines, the same `.info` loss and err (compared exactly, as
  written), byte-equal checkpoints.
- tpukaldi at K = 3 against the port at K = 3 from one `save_seeded_init`,
  at drop 0: each `.info` loss and err within 1e-5.
- `_row_mask` with `n_valid_t` a 0-d tensor gives the int version's mask
  bitwise; the knob's default is 1 on the CPU and a non-integer raises;
  a group advances each optimizer's count by the steps it ran.
"""

import contextlib
import glob
import os
import re

import numpy as np
import pytest
import torch

from tpukaldi.data.synth import generate_corpus, write_cfg
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi_torch.graph import compiler
from tpukaldi_torch.tools.flagship_tree import (
    save_seeded_init,
    train_plan,
    write_kaldi_tree,
    write_train_cfg,
)
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train import chunk_runtime
from tpukaldi_torch.train.chunk_runtime import (
    ChunkRuntime,
    group_batches,
    multistep_k,
    read_info,
)

# tpukaldi's ledger against the port's, as tests/test_torch_port_pipeline.py
# holds the recipes at drop 0
TPK_ATOL = 1e-5
DIM = 10
SPLITS = {"train": (24, 40, 70), "dev": (8, 52, 74), "test": (4, 30, 50)}
# 2 epochs of 2 chunks, batches of 2 utterances: 6 train batches a chunk
# over buckets 50 and 75, 4 valid batches in bucket 75
LIGRU_SHRINK = {
    "ligru_lay = 550,550,550,550,550": "ligru_lay = 16,16",
    "ligru_drop = 0.2,0.2,0.2,0.2,0.2": "ligru_drop = 0.2,0.2",
    "ligru_use_laynorm = False,False,False,False,False":
        "ligru_use_laynorm = False,False",
    "ligru_use_batchnorm = True,True,True,True,True":
        "ligru_use_batchnorm = True,True",
    "ligru_act = relu,relu,relu,relu,relu": "ligru_act = relu,relu",
    "n_epochs_tr = 24": "n_epochs_tr = 2",
    "increase_seq_length_train = True": "increase_seq_length_train = False",
    "n_chunks = 5": "n_chunks = 2",
    "batch_size_train = 8": "batch_size_train = 2",
    "batch_size_valid = 8": "batch_size_valid = 2",
}
NO_DROP = {**LIGRU_SHRINK, "ligru_drop = 0.2,0.2,0.2,0.2,0.2":
           "ligru_drop = 0.0,0.0"}


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _res_lines(out):
    """res.res without its timings (`time(s)=`, the `phases ep=` lines)."""
    with open(os.path.join(out, "res.res")) as f:
        lines = [line for line in f.read().strip().splitlines()
                 if not line.startswith("phases ")]
    return [re.sub(r"time\(s\)=\d+", "", line) for line in lines]


def _infos(out, forward=False):
    paths = sorted(glob.glob(os.path.join(out, "exp_files", "*.info")))
    return [p for p in paths
            if forward or not os.path.basename(p).startswith("forward_")]


def _ckpts(out):
    return sorted(glob.glob(os.path.join(out, "exp_files", "*.ckpt")))


def _assert_runs_equal(a, b):
    """The same res.res lines, the same .info loss and err, byte-equal
    checkpoints."""
    assert _res_lines(a) == _res_lines(b)
    infos = _infos(a)
    assert infos and [os.path.basename(p) for p in infos] == [
        os.path.basename(p) for p in _infos(b)]
    for p in infos:
        x, y = read_info(p), read_info(p.replace(a, b))
        assert (x["loss"], x["err"]) == (y["loss"], y["err"]), p
    ckpts = _ckpts(a)
    assert ckpts and [os.path.basename(p) for p in ckpts] == [
        os.path.basename(p) for p in _ckpts(b)]
    for p in ckpts:
        assert _read(p) == _read(p.replace(a, b)), p


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_corpus(str(tmp_path_factory.mktemp("synth")), n_utts=12,
                           feat_dim=13, n_classes=5)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_kaldi_tree(str(tmp_path_factory.mktemp("timit")), DIM,
                            n_phones=3, n_pdfs=9, splits=SPLITS)


def _mlp_run(corpus, out, k):
    with _env(TPUKALDI_MULTISTEP=str(k)):
        cfg = write_cfg(corpus, out, arch="MLP", hidden=16, n_epochs=2,
                        n_chunks=2, batch_size=16, lr=0.2)
        run_experiment(cfg, device="cpu")
    return out


def _ligru_run(tree, root, side, k, shrink=LIGRU_SHRINK, init=None):
    out = os.path.join(root, side)
    os.makedirs(out)
    cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"), shrink)
    if init is None:
        init = save_seeded_init(cfg, DIM, os.path.join(root, "init"))
    with _env(TPUKALDI_MULTISTEP=str(k)):
        if side.startswith("tpk"):
            tpk_run_experiment(cfg, overrides=init)
        else:
            run_experiment(cfg, overrides=init, device="cpu")
    return out, init, cfg


def test_frame_model_at_k4_equals_k1(corpus, tmp_path):
    """MLP frame batches, grouped 4 at a time, against one at a time."""
    unfused = _mlp_run(corpus, str(tmp_path / "k1"), 1)
    fused = _mlp_run(corpus, str(tmp_path / "k4"), 4)
    _assert_runs_equal(unfused, fused)


def test_sequence_model_at_k3_equals_k1(tree, tmp_path):
    """liGRU at recipe dropout, K = 3: groups and singles, against K = 1,
    from one seeded init."""
    unfused, init, cfg = _ligru_run(tree, str(tmp_path), "k1", 1)
    fused, _, _ = _ligru_run(tree, str(tmp_path), "k3", 3, init=init)
    _assert_runs_equal(unfused, fused)
    # the first train chunk's batches come as a mix of groups and singles
    exp, plan = train_plan(cfg)
    task = [t for t in plan.epochs[0].tasks if t.phase == "train"][0]
    rt = ChunkRuntime(exp, "cpu")
    chunk = rt.load_task_chunk(task)
    kinds = [kind for kind, _ in group_batches(
        rt._batches(chunk, 2, True, task.seed), 3)]
    assert "group" in kinds and "single" in kinds, kinds
    valid = [t for t in plan.epochs[0].tasks if t.phase == "valid"][0]
    chunk = rt.load_task_chunk(valid)
    kinds = [kind for kind, _ in group_batches(
        rt._batches(chunk, 2, False, valid.seed), 3)]
    assert kinds == ["group", "single"], kinds


def test_tpukaldi_and_port_agree_at_k3(tree, tmp_path):
    """tpukaldi at TPUKALDI_MULTISTEP=3 against the port at 3, from one
    seeded init, at drop 0: each .info loss and err within 1e-5."""
    port, init, _ = _ligru_run(tree, str(tmp_path), "port", 3, NO_DROP)
    tpk, _, _ = _ligru_run(tree, str(tmp_path), "tpk", 3, NO_DROP, init)
    want, got = _infos(tpk), _infos(port)
    assert want and [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    for w, g in zip(want, got):
        a, b = read_info(w), read_info(g)
        assert abs(a["loss"] - b["loss"]) <= TPK_ATOL, g
        assert abs(a["err"] - b["err"]) <= TPK_ATOL, g


@pytest.mark.parametrize("T,B,n_valid", [(25, 3, 1), (50, 2, 37), (75, 4, 75),
                                         (100, 1, 60)])
def test_row_mask_takes_a_tensor_n_valid(T, B, n_valid):
    """The graphed path's 0-d int32 `n_valid_t` gives the int's mask bit
    for bit."""
    x = torch.zeros(T, B, 1)
    want = compiler._row_mask(x, n_valid)
    got = compiler._row_mask(x, torch.tensor(n_valid, dtype=torch.int32))
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_knob_default_and_parse():
    """1 on the CPU, 8 on a card (tpukaldi's 8 on the accelerator, 1
    elsewhere); the environment overrides; a non-integer raises, as int()
    does in tpukaldi."""
    with _env(TPUKALDI_MULTISTEP=""):
        os.environ.pop("TPUKALDI_MULTISTEP")
        assert multistep_k("cpu") == 1
        assert multistep_k("cuda") == 8
    with _env(TPUKALDI_MULTISTEP="3"):
        assert multistep_k("cpu") == 3
    with _env(TPUKALDI_MULTISTEP="four"), pytest.raises(ValueError):
        multistep_k("cpu")


@pytest.mark.parametrize("k", [1, 3])
def test_optimizer_count_advances_by_the_steps_run(tree, tmp_path, k):
    """After a train chunk, each optimizer's count is the chunk's number of
    batches, grouped or not; the batch counter moves as much."""
    out = str(tmp_path / "run")
    os.makedirs(out)
    cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                          LIGRU_SHRINK)
    exp, plan = train_plan(cfg)
    task = [t for t in plan.epochs[0].tasks if t.phase == "train"][0]
    with _env(TPUKALDI_MULTISTEP=str(k)):
        rt = ChunkRuntime(exp, "cpu")
    assert rt.multistep_k == k
    before = chunk_runtime.train_batches
    result = rt.run_task(task, batch_size=2)
    assert result.n_batches == 6
    assert chunk_runtime.train_batches - before == 6
    assert {name: o.count for name, o in rt.optimizers.items()} == dict.fromkeys(
        rt.optimizers, 6)


def test_a_restore_that_loads_drops_the_step_graphs(tree, tmp_path):
    """A restore that loads a checkpoint drops the runtime's step graphs
    (a load replaces the optimizer state a captured step holds); one that
    loads nothing keeps them."""
    out = str(tmp_path / "run")
    os.makedirs(out)
    cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                          LIGRU_SHRINK)
    exp, plan = train_plan(cfg)
    task = [t for t in plan.epochs[0].tasks if t.phase == "train"][0]
    writer = ChunkRuntime(exp, "cpu")
    writer.run_task(task, batch_size=2)
    writer.checkpointer.wait()
    rt = ChunkRuntime(exp, "cpu")
    rt.ensure_initialized(rt.load_task_chunk(task), with_optimizers=True)
    key = (True, (2, 50, DIM), (2, 50), torch.float32, torch.int64)
    rt._step_graphs[key] = "captured"
    rt.restore_from(task.ckpt_files)
    assert rt._step_graphs == {}
    rt._step_graphs[key] = "captured"
    rt.restore_from(task.ckpt_files)
    assert rt._step_graphs == {key: "captured"}


def test_grouping_is_tpukaldis():
    """Windows of K: a same-shape window is a group, else its first batch
    is a single and the window moves on by one."""
    class Batch:
        def __init__(self, t):
            self.feats = np.zeros((t, 2, 3), np.float32)
            self.labs = np.zeros((t, 2, 1), np.int64)

    shapes = [50, 50, 50, 75, 50, 50, 75, 75, 75, 100]
    got = [(kind, [b.feats.shape[0] for b in group]) for kind, group in
           group_batches(iter([Batch(t) for t in shapes]), 3)]
    assert got == [("group", [50, 50, 50]), ("single", [75]),
                   ("single", [50]), ("single", [50]),
                   ("group", [75, 75, 75]), ("single", [100])]
    assert [kind for kind, _ in group_batches(
        iter([Batch(50)] * 4), 1)] == ["single"] * 4


@pytest.mark.cuda
def test_graphed_chunk_equals_eager_chunk_on_card(tree, tmp_path):
    """On a card, K = 3 (groups on CUDA graphs) against K = 1 at recipe
    dropout: the same .info loss and err and byte-equal checkpoints."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    runs = {}
    init = None
    for k in (1, 3):
        out = os.path.join(str(tmp_path), f"k{k}")
        os.makedirs(out)
        cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                              LIGRU_SHRINK)
        if init is None:
            init = save_seeded_init(cfg, DIM, os.path.join(str(tmp_path),
                                                           "init"))
        captures = chunk_runtime.graph_captures
        with _env(TPUKALDI_MULTISTEP=str(k)):
            run_experiment(cfg, overrides=init, device="cuda")
        runs[k] = out
        assert (chunk_runtime.graph_captures > captures) == (k > 1)
    _assert_runs_equal(runs[1], runs[3])
