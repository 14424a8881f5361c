"""The port's host pipeline around a chunk against tpukaldi's, on the CPU.

- `ChunkPrefetcher` and `_prefetch_iter`: the same cases run on both
  packages' own classes (the `_prefetch_iter` cases mirror
  tests/test_prefetch_iter.py).
- `AsyncCheckpointer`: files byte-equal to the synchronous `save_all`, the
  state taken at the save, the depth-2 queue, writer errors re-raised.
- `ChunkRuntime.restore_from`: no wait on the writer in the rolling flow, a
  wait before any read otherwise.
- Small training runs through `run_experiment`: the `.info` and
  `phases ep=` keys against tpukaldi's run, inline batch assembly against
  the prefetch thread, forward pipeline depth 1 against 6, and an ark
  writer that fails mid-stage.

Inputs come from numpy with a seed.  Everything compared here is
compared exactly (keys, bytes, loss and err as written).
"""

import contextlib
import glob
import os
import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpukaldi.data.prefetch import ChunkPrefetcher as TpkPrefetcher
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi.train.chunk_runtime import _prefetch_iter as tpk_prefetch_iter
from tpukaldi_torch.data import ChunkPrefetcher as PortPrefetcher
from tpukaldi_torch.dist import DataParallelMesh
from tpukaldi_torch.forward.posteriors import PosteriorWriter
from tpukaldi_torch.graph import compiler
from tpukaldi_torch.tools.flagship_tree import (
    save_seeded_finals,
    save_seeded_init,
    write_kaldi_tree,
    write_prod_cfg,
    write_train_cfg,
)
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train import checkpoint as ckpt
from tpukaldi_torch.train import chunk_runtime
from tpukaldi_torch.train.chunk_runtime import ChunkRuntime
from tpukaldi_torch.train.optimizers import make_all_optimizers
from tpukaldi_torch.train.step import train_step
from torch_port_helpers import FEA, LAB, N_CD, N_MONO, recipe_exp

PREFETCHERS = pytest.mark.parametrize(
    "cls", [TpkPrefetcher, PortPrefetcher], ids=["tpukaldi", "port"])
PREFETCH_ITERS = pytest.mark.parametrize(
    "prefetch_iter", [tpk_prefetch_iter, chunk_runtime._prefetch_iter],
    ids=["tpukaldi", "port"])


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


# ------------------------------------------------------- ChunkPrefetcher
@PREFETCHERS
def test_prefetcher_returns_the_loaders_result(cls):
    pf = cls()
    assert not pf.in_flight
    pf.start(lambda: "chunk")
    assert pf.in_flight
    assert pf.take() == "chunk"
    assert not pf.in_flight


@PREFETCHERS
def test_prefetcher_reraises_loader_error_at_take(cls):
    pf = cls()

    def loader():
        raise OSError("unreadable ark")

    pf.start(loader)
    with pytest.raises(OSError, match="unreadable ark"):
        pf.take()
    assert not pf.in_flight
    with pytest.raises(RuntimeError, match="no prefetch in flight"):
        pf.take()


@PREFETCHERS
def test_prefetcher_second_start_before_take_raises(cls):
    pf = cls()
    gate = threading.Event()
    pf.start(gate.wait)
    with pytest.raises(RuntimeError, match="already in flight"):
        pf.start(lambda: None)
    gate.set()
    pf.take()


@PREFETCHERS
def test_prefetcher_counts_the_loaders_seconds(cls):
    pf = cls()
    assert pf.producer_seconds == 0.0
    for _ in range(2):
        pf.start(lambda: time.sleep(0.05))
        pf.take()
    assert 0.1 <= pf.producer_seconds < 5.0


# ------------------------------------------------------- _prefetch_iter
@PREFETCH_ITERS
def test_prefetch_iter_preserves_order(prefetch_iter):
    assert list(prefetch_iter(iter(range(50)), depth=2)) == list(range(50))


@PREFETCH_ITERS
def test_prefetch_iter_empty(prefetch_iter):
    assert list(prefetch_iter(iter(()), depth=2)) == []


@PREFETCH_ITERS
def test_prefetch_iter_reraises_producer_error(prefetch_iter):
    def gen():
        yield 1
        yield 2
        raise RuntimeError("assembly failed")

    it = prefetch_iter(gen(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="assembly failed"):
        list(it)


@PREFETCH_ITERS
def test_prefetch_iter_early_exit_unblocks_producer(prefetch_iter):
    produced = []
    done = threading.Event()

    def gen():
        try:
            for i in range(1000):
                produced.append(i)
                yield i
        finally:
            done.set()

    it = prefetch_iter(gen(), depth=2)
    assert next(it) == 0
    it.close()  # the stop flag must release the producer
    assert done.wait(5), "producer thread stayed blocked after close()"
    assert len(produced) < 1000


# ------------------------------------------------------- AsyncCheckpointer
def _trained_graph():
    """The recipe program over a 2x8 liGRU and two MLP heads after one
    rmsprop step, so every architecture has batch statistics and moments."""
    rng = np.random.default_rng(5)
    T, B = 12, 3
    feats = rng.standard_normal((T, B, 6)).astype(np.float32)
    labs = np.stack([rng.integers(0, N_CD, (T, B)),
                     rng.integers(0, N_MONO, (T, B))], axis=-1)
    exp = recipe_exp("liGRU", "relu")
    graph = compiler.build_graph(exp, FEA, LAB, "cpu")
    compiler.init_graph(graph, 7)
    opts = make_all_optimizers(graph.archs, graph.modules)
    train_step(graph, opts, torch.from_numpy(feats), torch.from_numpy(labs), 9)
    return graph.modules, opts


def _paths(folder, modules):
    os.makedirs(folder, exist_ok=True)
    return {a: os.path.join(folder, f"{a}.ckpt") for a in modules}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_async_checkpoint_bytes_equal_save_all(tmp_path):
    """Every file of an asynchronous save equals the synchronous writer's
    from the same state, byte for byte (liGRU and MLP params, batch
    statistics, rmsprop moments, count and lr)."""
    modules, opts = _trained_graph()
    want = _paths(str(tmp_path / "sync"), modules)
    got = _paths(str(tmp_path / "async"), modules)
    ckpt.save_all(want, modules, opts)
    cp = ckpt.AsyncCheckpointer()
    cp.save_all_async(got, modules, opts)
    cp.wait()
    for arch in modules:
        assert _read(got[arch]) == _read(want[arch]), arch
    params, opt_state, stats = ckpt.read_checkpoint(got["liGRU_layers"])
    assert stats and int(opt_state["count"]) == 1
    assert opt_state["inner_state"]["0"]["nu"]


def test_async_checkpoint_takes_the_state_at_the_save(tmp_path, monkeypatch):
    """The live weights, statistics and moments modified in place right
    after `save_all_async` (as the next chunk's steps do) leave the files as
    they were at the save."""
    modules, opts = _trained_graph()
    want = _paths(str(tmp_path / "sync"), modules)
    got = _paths(str(tmp_path / "async"), modules)
    ckpt.save_all(want, modules, opts)
    gate = threading.Event()
    real = ckpt.write_checkpoint

    def gated(*args):
        gate.wait(10)
        real(*args)

    monkeypatch.setattr(ckpt, "write_checkpoint", gated)
    cp = ckpt.AsyncCheckpointer()
    cp.save_all_async(got, modules, opts)
    with torch.no_grad():
        for module in modules.values():
            for t in module.state_dict().values():
                t.add_(1)
        for opt in opts.values():
            for st in opt.opt.state.values():
                for v in st.values():
                    v.add_(1)
            opt.count += 5
            opt.lr *= 2
    gate.set()
    cp.wait()
    for arch in modules:
        assert _read(got[arch]) == _read(want[arch]), arch


def test_async_checkpoint_third_save_waits_for_the_oldest_write(tmp_path,
                                                               monkeypatch):
    """With a slow writer, two saves return at once and a third blocks
    until the oldest write is done."""
    modules, opts = _trained_graph()
    gate = threading.Event()
    real = ckpt.write_checkpoint

    def slow(*args):
        gate.wait(10)
        real(*args)

    monkeypatch.setattr(ckpt, "write_checkpoint", slow)
    cp = ckpt.AsyncCheckpointer()
    for i in range(2):
        cp.save_all_async(_paths(str(tmp_path / str(i)), modules), modules,
                          opts)
    third = threading.Thread(target=cp.save_all_async, args=(
        _paths(str(tmp_path / "2"), modules), modules, opts))
    third.start()
    third.join(0.5)
    assert third.is_alive(), "a third save did not wait"
    gate.set()
    third.join(10)
    assert not third.is_alive()
    cp.wait()
    for i in range(3):
        assert len(glob.glob(str(tmp_path / str(i) / "*.ckpt"))) == 3


def test_async_checkpoint_writer_error_reraises(tmp_path, monkeypatch):
    """A failed write re-raises at `wait()`, and at the next save when no
    wait came first."""
    modules, opts = _trained_graph()

    def full(*args):
        raise OSError("No space left on device")

    monkeypatch.setattr(ckpt, "write_checkpoint", full)
    cp = ckpt.AsyncCheckpointer()
    cp.save_all_async(_paths(str(tmp_path / "a"), modules), modules, opts)
    with pytest.raises(OSError, match="No space"):
        cp.wait()
    cp.wait()  # raised once
    cp.save_all_async(_paths(str(tmp_path / "b"), modules), modules, opts)
    cp._queue.join()  # the failed write has run
    with pytest.raises(OSError, match="No space"):
        cp.save_all_async(_paths(str(tmp_path / "c"), modules), modules, opts)


# ------------------------------------------------------- restore_from
class _Recorder:
    def __init__(self, events, creates=None):
        self.events, self.creates = events, creates

    def wait(self):
        self.events.append("wait")
        if self.creates:  # the pending write lands
            open(self.creates, "w").close()


@pytest.mark.parametrize("case", ["rolling", "reload", "written_by_wait"])
def test_restore_from_waits_only_before_a_read(case, tmp_path, monkeypatch):
    """The pointer last saved: no wait, no read.  Another pointer: the wait
    comes first, then the existence filter, then the read, so a file that
    the pending write is still making is read complete; a read drops the
    captured step graphs after it."""
    events = []
    path = str(tmp_path / "ep0_ck0_arch.ckpt")
    if case == "reload":
        open(path, "w").close()
    rt = SimpleNamespace(
        _loaded_from={"arch": path if case == "rolling" else "old.ckpt"},
        checkpointer=_Recorder(events, path if case == "written_by_wait"
                               else None),
        graph=SimpleNamespace(modules={}), optimizers=None,
        mesh=DataParallelMesh(0, 1, 0, torch.device("cpu"), ""),
        drop_step_graphs=lambda: events.append("drop"))
    monkeypatch.setattr(chunk_runtime.ckpt, "load_all",
                        lambda paths, *a: events.append(("load", paths)))
    ChunkRuntime.restore_from(rt, {"arch": path})
    if case == "rolling":
        assert events == []
    else:
        assert events == ["wait", ("load", {"arch": path}), "drop"]
        assert rt._loaded_from == {"arch": path}


# ------------------------------------------------------- runs
DIM = 10
SPLITS = {"train": (16, 40, 80), "dev": (4, 40, 60), "test": (12, 30, 90)}
TRAIN_SHRINK = {
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
}
PROD_SHRINK = {k: v for k, v in TRAIN_SHRINK.items() if "ligru" in k}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_kaldi_tree(str(tmp_path_factory.mktemp("timit")), DIM,
                            n_phones=3, n_pdfs=9, splits=SPLITS)


def _train_run(tree, root, side, init=None, **env):
    out = os.path.join(root, side)
    os.makedirs(out)
    cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                          TRAIN_SHRINK)
    if init is None:
        init = save_seeded_init(cfg, DIM, os.path.join(root, "init"))
    with _env(**env):
        if side == "tpk":
            tpk_run_experiment(cfg, overrides=init)
        else:
            run_experiment(cfg, overrides=init, device="cpu")
    return out, init


@pytest.fixture(scope="module")
def port_run(tree, tmp_path_factory):
    """A 2-epoch run of the port with the prefetchers on (the default)."""
    return _train_run(tree, str(tmp_path_factory.mktemp("runs")), "port")


def _infos(out):
    return sorted(glob.glob(os.path.join(out, "exp_files", "*.info")))


def _phase_keys(path):
    with open(path) as f:
        return [line.split("=")[0] for line in f if line.startswith("phase_")]


def _phases_line_keys(out):
    with open(os.path.join(out, "res.res")) as f:
        lines = [line for line in f if line.startswith("phases ep=")]
    return [re.findall(r"(\w+)=", line) for line in lines]


def test_ledger_phase_keys_equal_tpukaldis(tree, port_run, tmp_path):
    """The train, valid and forward `.info` files carry tpukaldi's
    `phase_*` keys in tpukaldi's order, and each `phases ep=` line of
    res.res tpukaldi's keys: the two ledgers now count alike."""
    out_port, init = port_run
    out_tpk, _ = _train_run(tree, str(tmp_path), "tpk", init)
    want, got = _infos(out_tpk), _infos(out_port)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    kinds = set()
    for w, g in zip(want, got):
        kinds.add(os.path.basename(w).split("_")[0])
        assert _phase_keys(g) == _phase_keys(w), os.path.basename(g)
    assert kinds == {"train", "valid", "forward"}
    assert "phase_ckpt_block" in _phase_keys(
        [p for p in got if "train_" in p][0])
    lines_tpk, lines_port = _phases_line_keys(out_tpk), _phases_line_keys(
        out_port)
    assert len(lines_port) == len(lines_tpk) == 2
    assert lines_port == lines_tpk
    assert "host_load_producer" in lines_port[0]


def test_inline_assembly_equals_prefetch(tree, port_run, tmp_path):
    """TPUKALDI_HOST_PREFETCH=0 (inline batch assembly, inline chunk loads
    still prefetched) writes the same loss and err in every `.info` and
    byte-equal checkpoints."""
    out_on, init = port_run
    out_off, _ = _train_run(tree, str(tmp_path), "port_inline", init,
                            TPUKALDI_HOST_PREFETCH="0")
    on = [p for p in _infos(out_on) if not os.path.basename(p).startswith(
        "forward_")]
    assert len(on) == 2 * (2 + 1)
    for p in on:
        a = chunk_runtime.read_info(p)
        b = chunk_runtime.read_info(p.replace(out_on, out_off))
        assert (a["loss"], a["err"]) == (b["loss"], b["err"]), p
    ckpts = sorted(glob.glob(os.path.join(out_on, "exp_files", "*.ckpt")))
    # (2 epochs x 2 chunks + the finals) x 3 archs
    assert len(ckpts) == (2 * 2 + 1) * 3
    for p in ckpts:
        assert _read(p) == _read(p.replace(out_on, out_off)), p


def _serve(tree, out, **env):
    """A production forward of the test split from seeded final
    checkpoints, one utterance a batch (12 batches through the pipeline)."""
    os.makedirs(out)
    cfg = write_prod_cfg(tree, out, os.path.join(out, "run.cfg"), PROD_SHRINK)
    save_seeded_finals(cfg, DIM)
    with _env(TPUKALDI_FORWARD_BATCH="1", **env):
        run_experiment(cfg, device="cpu")
    arks = sorted(glob.glob(os.path.join(out, "exp_files", "*.ark")))
    assert arks
    return {os.path.basename(p): _read(p) for p in arks}


def test_forward_pipeline_depth_does_not_change_the_arks(tree, tmp_path):
    """Depth 1 (each batch written before the next is queued behind it)
    and tpukaldi's default 6 give byte-equal arks."""
    one = _serve(tree, str(tmp_path / "d1"),
                 TPUKALDI_FORWARD_PIPELINE_DEPTH="1")
    six = _serve(tree, str(tmp_path / "d6"),
                 TPUKALDI_FORWARD_PIPELINE_DEPTH="6")
    assert one == six


def test_failing_ark_writer_fails_the_forward_task(tree, tmp_path,
                                                  monkeypatch):
    """An ark write that raises mid-stage ends the forward task with that
    error, within a time limit, instead of hanging on the bounded queue."""
    calls = []
    real = PosteriorWriter.write

    def write(self, *args):
        calls.append(args[1])
        if len(calls) == 3:
            raise OSError("No space left on device")
        real(self, *args)

    monkeypatch.setattr(PosteriorWriter, "write", write)
    result = []

    def serve():
        try:
            _serve(tree, str(tmp_path / "fail"))
        except BaseException as e:
            result.append(e)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), "the forward task hung after a writer error"
    assert len(result) == 1 and isinstance(result[0], OSError), result
    assert len(calls) == 3
