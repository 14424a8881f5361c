"""The port's device-resident corpus cache (`tpukaldi_torch/data/
device_cache.py`) on the CPU, with the cache forced on
(TPUKALDI_DEVICE_CACHE=1) where a run takes it.

- Against the port's own host path, the five cases of
  `tests/test_device_cache.py`: the chunk's metadata, sequence batches with
  the seeded random left offsets, shuffled frame batches, split sentences,
  and a 2-epoch run with the cache on and off.
- Against tpukaldi's cache on the same cfg and chunk: every field of the
  index-space chunk exactly, and each batch the port assembles against
  tpukaldi's jitted `assemble`.
- The port's run against tpukaldi's, both with the cache forced on, from
  the same initial weights.
- `ChunkRuntime._use_device_cache`'s decision table, the budget's host
  path, and that only `CacheUnavailable` leads to the host path.

The same batch parity on the card is
`tests/test_torch_port_device_cache_cuda.py` (no JAX there).

Inputs come from `tpukaldi/data/synth.py`'s seeded corpus; each tolerance
is stated where it is used.
"""

import logging
import os
import re

import numpy as np
import pytest
import torch

from tpukaldi.config import load_config as tpk_load_config
from tpukaldi.data import device_cache as tpk_cache
from tpukaldi.data.synth import generate_corpus, load_corpus, write_cfg
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi.train.chunk_runtime import read_info as tpk_read_info
from tpukaldi_torch.config import load_config
from tpukaldi_torch.data import device_cache
from tpukaldi_torch.data.batching import iter_frame_batches, iter_seq_batches
from tpukaldi_torch.data.chunk_loader import ChunkData, load_chunk
from tpukaldi_torch.data.device_cache import (
    CacheUnavailable,
    ChunkIndexData,
    DeviceCorpusCache,
    iter_frame_index_batches,
    iter_seq_index_batches,
)
from tpukaldi_torch.plan import build_plan
from tpukaldi_torch.tools.flagship_tree import save_seeded_init
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train import chunk_runtime
from tpukaldi_torch.train.chunk_runtime import ChunkRuntime

# the host and cache batches: CMVN statistics accumulate in another order
# (tpukaldi's own bound, tests/test_device_cache.py)
HOST_TOL = 2e-6
# the port's gather and affine against tpukaldi's jitted one: the same
# float32 operations
TPK_ATOL = 1e-6
# res.res loss and err with the cache on and off (tests/test_device_cache.py)
RUN_TOL = 5e-3
# the port's .info loss and err against tpukaldi's from the same weights
# (tests/test_torch_port_train.py::test_training_run_matches_tpukaldi)
TPK_RUN_ATOL = 1e-3

FEAT_DIM = 12


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("devcache")
    corp = os.path.join(str(root), "corpus")
    generate_corpus(corp, n_utts=18, feat_dim=FEAT_DIM, n_classes=16,
                    min_len=40, max_len=140, seed=9)
    return write_cfg(load_corpus(corp), os.path.join(str(root), "exp"),
                     arch="MLP", n_epochs=1, n_chunks=1, batch_size=8, cw=3,
                     lr=0.02)


def _names(exp):
    ds = exp.datasets[exp.train_with[0]]
    return ds, list(ds.features), list(ds.labels)


def _host_and_cache_chunks(cfg, msl, shuffle, seed):
    ds, fea_names, lab_names = _names(load_config(cfg, []))
    host = load_chunk(ds, fea_names, lab_names, msl, shuffle_frames=shuffle,
                      seed=seed)
    cache = DeviceCorpusCache("cpu")
    cm = cache.load_chunk_index(ds, fea_names, lab_names, msl,
                                shuffle_frames=shuffle, seed=seed)
    return host, cache, cm


def _check_batch(cache, cm, h, c):
    feats, labs = cache.assemble(cm, c.fea_idx, c.lab_idx)
    assert feats.dtype == torch.float32 and labs.dtype == torch.int32
    np.testing.assert_allclose(feats.numpy(), h.feats, rtol=HOST_TOL,
                               atol=HOST_TOL)
    np.testing.assert_array_equal(labs.numpy(), h.labs)


# ------------------------------------------------- the port's host path
def test_metadata_matches_host(cfg):
    host, _, cm = _host_and_cache_chunks(cfg, 100, False, 0)
    assert cm.names == host.names
    np.testing.assert_array_equal(cm.end_index, host.end_index)
    assert cm.fea_layout == host.fea_layout
    assert cm.lab_layout == host.lab_layout
    assert cm.n_frames == host.n_frames
    assert cm.n_sentences == host.n_sentences
    assert not cm.rates_differ


def test_seq_batches_match_host(cfg):
    host, cache, cm = _host_and_cache_chunks(cfg, 100, False, 0)
    hb = list(iter_seq_batches(host, 4, rng=np.random.default_rng(7)))
    cb = list(iter_seq_index_batches(cm, 4, rng=np.random.default_rng(7)))
    assert len(hb) == len(cb) > 0
    for h, c in zip(hb, cb):
        assert h.names == c.names
        assert h.n_valid_t == c.n_valid_t
        np.testing.assert_array_equal(h.lengths, c.lengths)
        _check_batch(cache, cm, h, c)


def test_frame_batches_with_shuffle_match_host(cfg):
    host, cache, cm = _host_and_cache_chunks(cfg, 100, True, 5)
    hb = list(iter_frame_batches(host, 16))
    cb = list(iter_frame_index_batches(cm, 16))
    assert len(hb) == len(cb) > 0
    for h, c in zip(hb, cb):
        _check_batch(cache, cm, h, c)


def test_split_sentences_match_host(cfg):
    # max_seq_length small enough for the min-tail splitting rule
    host, cache, cm = _host_and_cache_chunks(cfg, 48, False, 0)
    assert cm.names == host.names
    assert any("_split" in n for n in cm.names)
    np.testing.assert_array_equal(cm.end_index, host.end_index)
    hb = list(iter_seq_batches(host, 4))
    cb = list(iter_seq_index_batches(cm, 4))
    assert len(hb) == len(cb) > 0
    for h, c in zip(hb, cb):
        _check_batch(cache, cm, h, c)


def _res_values(out):
    vals = []
    with open(os.path.join(out, "res.res")) as f:
        for line in f:
            if line.startswith("ep="):
                vals += [float(v) for v in
                         re.findall(r"(?:loss|err)=([\d.]+)", line)]
    return np.asarray(vals)


@pytest.fixture(scope="module")
def run_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("devcache_run")
    corp = str(root / "corpus")
    generate_corpus(corp, n_utts=16, feat_dim=10, n_classes=12, min_len=30,
                    max_len=80, seed=3)
    return root, load_corpus(corp)


def _port_run(run_corpus, mode, sub, monkeypatch, **env):
    root, corpus = run_corpus
    out = str(root / sub)
    cfg = write_cfg(corpus, out, arch="MLP", n_epochs=2, n_chunks=2,
                    batch_size=16, cw=2, lr=0.05)
    monkeypatch.setenv("TPUKALDI_DEVICE_CACHE", mode)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    run_experiment(cfg, device="cpu")
    return out


def test_e2e_trajectory_matches_host_path(run_corpus, monkeypatch):
    """The port's driver with the cache forced on and off: the same batches
    give the same loss and err trajectory in res.res."""
    on = _res_values(_port_run(run_corpus, "1", "on", monkeypatch))
    off = _res_values(_port_run(run_corpus, "0", "off", monkeypatch))
    assert on.size == off.size > 0
    np.testing.assert_allclose(on, off, rtol=RUN_TOL, atol=RUN_TOL)


def test_budget_takes_the_host_path(run_corpus, monkeypatch, caplog):
    """A budget of one byte: every stream is over it, the runtime logs why
    and loads through the host path, and the run gives the res.res of the
    cache turned off."""
    caplog.set_level(logging.INFO)
    budget = _res_values(_port_run(run_corpus, "1", "budget", monkeypatch,
                                   TPUKALDI_DEVICE_CACHE_MAX_BYTES="1"))
    assert any("device cache unavailable" in r.getMessage()
               and "exceeds the device cache budget" in r.getMessage()
               and r.getMessage().endswith("; host path")
               for r in caplog.records)
    off = _res_values(_port_run(run_corpus, "0", "budget_off", monkeypatch))
    np.testing.assert_array_equal(budget, off)


# --------------------------------------------------------- against tpukaldi
CHUNKS = [(100, False, 0), (100, True, 5), (48, False, 0), (48, True, 11)]


@pytest.mark.parametrize("msl,shuffle,seed", CHUNKS)
def test_chunk_index_equals_tpukaldi(cfg, msl, shuffle, seed):
    """Every field of the port's `ChunkIndexData` equals tpukaldi's on the
    same chunk, and each batch the port assembles (sequence batches with
    the seeded offsets, frame batches) equals tpukaldi's jitted `assemble`
    to TPK_ATOL, labels exactly."""
    ds, fea_names, lab_names = _names(load_config(cfg, []))
    tds = tpk_load_config(cfg, []).datasets[ds.name]
    cache = DeviceCorpusCache("cpu")
    cm = cache.load_chunk_index(ds, fea_names, lab_names, msl,
                                shuffle_frames=shuffle, seed=seed)
    tcache = tpk_cache.DeviceCorpusCache()
    tcm = tcache.load_chunk_index(tds, fea_names, lab_names, msl,
                                  shuffle_frames=shuffle, seed=seed)
    assert cm.names == tcm.names
    for name in ("end_index", "lab_end_index", "lab_full_idx", "lab_min"):
        got, want = getattr(cm, name), getattr(tcm, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("full_idx", "mu", "sig"):
        got, want = getattr(cm, name), getattr(tcm, name)
        assert list(got) == list(want), name
        for s in want:
            assert got[s].dtype == want[s].dtype, (name, s)
            np.testing.assert_array_equal(got[s], want[s], err_msg=name)
    for name in ("fea_layout", "lab_layout", "streams", "dataset",
                 "shuffled", "window_shift", "window_size"):
        assert getattr(cm, name) == getattr(tcm, name), name

    batches = [
        (list(iter_seq_index_batches(cm, 4, rng=np.random.default_rng(3))),
         list(tpk_cache.iter_seq_index_batches(
             tcm, 4, rng=np.random.default_rng(3)))),
        (list(iter_frame_index_batches(cm, 32)),
         list(tpk_cache.iter_frame_index_batches(tcm, 32))),
    ]
    for ours, theirs in batches:
        assert len(ours) == len(theirs) > 0
        for c, t in zip(ours, theirs):
            for s in t.fea_idx:
                np.testing.assert_array_equal(c.fea_idx[s], t.fea_idx[s])
            np.testing.assert_array_equal(c.lab_idx, t.lab_idx)
            feats, labs = cache.assemble(cm, c.fea_idx, c.lab_idx)
            tfeats, tlabs = tcache.assemble(tcm, t.fea_idx, t.lab_idx)
            np.testing.assert_allclose(feats.numpy(), np.asarray(tfeats),
                                       rtol=0, atol=TPK_ATOL)
            np.testing.assert_array_equal(labs.numpy(), np.asarray(tlabs))


def test_run_matches_tpukaldi_with_cache(run_corpus, monkeypatch):
    """The port's `run_experiment` and tpukaldi's, both with the cache
    forced on, from the same initial weights at dropout 0: each .info's loss, err and
    frames within TPK_RUN_ATOL, and the same res.res lr entries."""
    root, corpus = run_corpus
    monkeypatch.setenv("TPUKALDI_DEVICE_CACHE", "1")
    outs, init = {}, None
    # write_cfg writes each cfg to one path in the corpus: run it at once
    for side in ("tpk", "port"):
        out = str(root / f"vs_{side}")
        cfg = write_cfg(corpus, out, arch="MLP", n_epochs=2, n_chunks=2,
                        batch_size=16, cw=2, lr=0.05)
        if init is None:
            # dropout 0: torch cannot draw JAX's threefry masks
            init = save_seeded_init(cfg, 10, str(root / "vs_init")) + [
                "--architecture1,dnn_drop=0.0,0.0"]
            tpk_run_experiment(cfg, overrides=init)
        else:
            run_experiment(cfg, overrides=init, device="cpu")
        outs[side] = (out, cfg)

    def infos(out):
        ef = os.path.join(out, "exp_files")
        return {f: os.path.join(ef, f) for f in sorted(os.listdir(ef))
                if f.endswith(".info") and not f.startswith("forward_")}

    want, got = infos(outs["tpk"][0]), infos(outs["port"][0])
    assert list(got) == list(want) and len(want) == 2 * (2 + 1)
    for name in want:
        w, g = tpk_read_info(want[name]), chunk_runtime.read_info(got[name])
        for key in ("loss", "err", "frames"):
            np.testing.assert_allclose(g[key], w[key], rtol=0,
                                       atol=TPK_RUN_ATOL,
                                       err_msg=f"{name} {key}")
    lrs = [[[f for f in line.split() if f.startswith("lr_")]
            for line in open(os.path.join(out, "res.res"))
            if line.startswith("ep=")] for out, _ in outs.values()]
    assert lrs[0] == lrs[1] and len(lrs[0]) == 2


# ----------------------------------------------------------- the runtime
def _runtime_and_tasks(cfg):
    exp = load_config(cfg, [])
    plan = build_plan(exp)
    tasks = {t.phase: t for t in plan.epochs[0].tasks}
    tasks["forward"] = plan.forward_tasks[0]
    return exp, tasks


@pytest.mark.parametrize("mode,device,phase,production,expected", [
    (None, "cpu", "train", False, False),       # auto: a CUDA device only
    ("auto", "cpu", "valid", False, False),
    ("0", "cpu", "train", False, False),
    ("off", "cpu", "valid", False, False),
    ("1", "cpu", "train", False, True),
    ("force", "cpu", "valid", False, True),
    ("true", "cpu", "forward", False, False),   # never a forward task
    ("1", "cpu", "forward", True, False),       # never production
    ("1", "cpu", "train", True, False),
    (None, "cuda", "train", False, True),
    (None, "cuda", "valid", False, True),
    (None, "cuda", "forward", False, False),
    ("0", "cuda", "train", False, False),
])
def test_use_device_cache_decisions(cfg, monkeypatch, mode, device, phase,
                                    production, expected):
    """TPUKALDI_DEVICE_CACHE as tpukaldi reads it, with auto on for a CUDA
    device (the runtime's device is set directly, so that the table runs
    without a card)."""
    if mode is None:
        monkeypatch.delenv("TPUKALDI_DEVICE_CACHE", raising=False)
    else:
        monkeypatch.setenv("TPUKALDI_DEVICE_CACHE", mode)
    exp, tasks = _runtime_and_tasks(cfg)
    rt = ChunkRuntime(exp, "cpu")
    rt.device = torch.device(device)
    exp.production = production
    assert rt._use_device_cache(tasks[phase]) is expected


def test_runtime_takes_the_cache_and_forward_the_host_path(cfg, monkeypatch):
    monkeypatch.setenv("TPUKALDI_DEVICE_CACHE", "1")
    exp, tasks = _runtime_and_tasks(cfg)
    rt = ChunkRuntime(exp, "cpu")
    assert isinstance(rt.load_task_chunk(tasks["train"]), ChunkIndexData)
    assert isinstance(rt.load_task_chunk(tasks["valid"]), ChunkIndexData)
    assert isinstance(rt.load_task_chunk(tasks["forward"]), ChunkData)
    assert rt.device_cache.resident_bytes > 0


def test_cache_unavailable_takes_the_host_path(cfg, monkeypatch, caplog):
    """`CacheUnavailable` from the cache gives the host chunk and tpukaldi's
    log line."""
    monkeypatch.setenv("TPUKALDI_DEVICE_CACHE", "1")
    exp, tasks = _runtime_and_tasks(cfg)

    def unavailable(*a, **k):
        raise CacheUnavailable("for the test")

    caplog.set_level(logging.INFO)
    monkeypatch.setattr(DeviceCorpusCache, "load_chunk_index", unavailable)
    rt = ChunkRuntime(exp, "cpu")
    assert isinstance(rt.load_task_chunk(tasks["train"]), ChunkData)
    assert any(r.getMessage() == "device cache unavailable (for the test); "
               "host path" for r in caplog.records)


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.OutOfMemoryError("CUDA out of memory"),
    ValueError("end indexes differ across streams"),
])
def test_other_cache_errors_propagate(cfg, monkeypatch, error):
    """Any error of the cache but `CacheUnavailable` reaches the caller: no
    silent host path."""
    monkeypatch.setenv("TPUKALDI_DEVICE_CACHE", "1")
    exp, tasks = _runtime_and_tasks(cfg)

    def broken(*a, **k):
        raise error

    monkeypatch.setattr(DeviceCorpusCache, "load_chunk_index", broken)
    with pytest.raises(type(error)):
        ChunkRuntime(exp, "cpu").load_task_chunk(tasks["train"])


def test_wav_stream_is_unavailable(tmp_path):
    """A RIFF stream is tpukaldi's documented host-path case."""
    wav = tmp_path / "a.wav"
    wav.write_bytes(b"RIFF" + bytes(60))
    lst = tmp_path / "wav.lst"
    lst.write_text(f"a {wav}\n")

    class Fea:
        opts = ""

    Fea.lst = str(lst)
    with pytest.raises(CacheUnavailable, match="wav"):
        device_cache._read_stream_utterances(Fea)
