"""The port's rate-differing raw-wave path against tpukaldi's, on the CPU at
small sizes: logMelFb and channel_averaging (tpukaldi_torch/models/cnn.py),
the rate-differing chunks of the runtime (train/valid on rate-aware
batches, forward one utterance a batch with its lengths in label frames),
and the bf16 refusal.

1. logMelFb (20 mels, window 400, shift 160, two utterances, one with a
   stretch of exact zeros that reaches the 1e-20 clamp) within 1e-4 in
   log10 units of tpukaldi's; channel_averaging within 1e-7 of its largest
   output.
2. logMelFb -> a 2x16 liGRU -> the flagship's heads, and channel_averaging
   -> logMelFb -> the heads, through both packages' `run_experiment` from
   one init at drop 0 (2 epochs of 2 chunks, max_seq_length_train =
   32000,32000,199,199,160,400): res.res's loss and err within 1e-3, the
   same ark keys and shapes (one row per label frame), values within 1e-3.
3. The forward stage's lengths in label frames at batch 1 (the port's copy
   of tests/test_rawwave.py::test_forward_converts_lengths_to_frame_rate),
   the device cache's refusal of rate-differing chunks, and bf16: tpukaldi
   fails in its FFT, the port raises NotImplementedError before any output.

Inputs come from numpy with a seed.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.models.cnn import channel_averaging as JaxChAvg
from tpukaldi.models.cnn import logMelFb as JaxLogMel
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi_torch.config.cfg import DatasetSpec, FeatureSpec
from tpukaldi_torch.data import load_chunk
from tpukaldi_torch.io import ArkScpWriter
from tpukaldi_torch.models import channel_averaging, logMelFb, resolve
from tpukaldi_torch.tools.flagship_tree import (
    forward_outputs,
    save_seeded_init,
    train_plan,
    write_kaldi_tree,
    write_rate_cfg,
)
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train import chunk_runtime

SHIFT, WIN = 160, 400
MEL_OPTS = {"logmelfb_nr_filt": "20", "logmelfb_stft_window_size": str(WIN),
            "logmelfb_stft_window_shift": str(SHIFT)}


def test_logmelfb_matches_tpukaldi():
    rng = np.random.default_rng(0)
    n_samp = (30 - 1) * SHIFT + WIN
    x = rng.standard_normal((n_samp, 2, 1)).astype(np.float32)
    x[1000:2000, 1] = 0.0  # whole frames of zeros: log10 of the clamp
    want = np.asarray(JaxLogMel(options=MEL_OPTS, inp_dim=1).apply(
        {}, jnp.asarray(x)))
    got = logMelFb(MEL_OPTS, 1)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (30, 2, 20) and got.dtype == np.float32
    assert (want[:, 1] == -20.0).all(axis=-1).sum() >= 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # a float64 input is framed, transformed and logged in float64
    x64 = torch.from_numpy(x.astype(np.float64))
    got64 = logMelFb(MEL_OPTS, 1).double()(x64)
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), want, rtol=0, atol=1e-4)


def test_channel_averaging_matches_tpukaldi():
    opts = {"chavg_channelweights": "1,2,3,0.5"}
    x = np.random.default_rng(1).standard_normal((37, 3, 4)).astype(
        np.float32)
    want = np.asarray(JaxChAvg(options=opts, inp_dim=4).apply(
        {}, jnp.asarray(x)))
    got = channel_averaging(opts, 4)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (37, 3, 1)
    # a weighted sum of 4 float32 terms in another order: an ulp apart
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-7 * np.abs(want).max())
    with pytest.raises(ValueError, match="4 channel weights"):
        channel_averaging(opts, 4)(torch.zeros(5, 2, 3))


def test_registry_resolves_the_rate_front_ends():
    from tpukaldi_torch.models import PASE

    for lib in ("tpukaldi.models", "tpukaldi_torch.models", "neural_networks"):
        assert resolve("logMelFb", lib) is logMelFb
        assert resolve("channel_averaging", lib) is channel_averaging
        assert resolve("PASE", lib) is PASE


# ------------------------------------------------ 2. through run_experiment
# short utterances in one length bucket: few batch shapes, few compiles
SPLITS = {"train": (4, 20, 24), "dev": (2, 20, 24), "test": (2, 20, 24)}
RUN_CUTS = {"n_epochs_tr = 24": "n_epochs_tr = 2", "n_chunks = 5": "n_chunks = 2"}
LIGRU_SHRINK = {
    "ligru_lay = 550,550,550,550,550": "ligru_lay = 16,16",
    "ligru_drop = 0.2,0.2,0.2,0.2,0.2": "ligru_drop = 0.0,0.0",
    "ligru_use_laynorm = False,False,False,False,False":
        "ligru_use_laynorm = False,False",
    "ligru_use_batchnorm = True,True,True,True,True":
        "ligru_use_batchnorm = True,True",
    "ligru_act = relu,relu,relu,relu,relu": "ligru_act = relu,relu",
}
# name -> the front end, the liGRU or not, the wave stream's channels
CHAINS = {"logMelFb_liGRU": ("logMelFb", True, 1),
          "chavg_logMelFb": ("chavg_logMelFb", False, 6)}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("rates")
    return root, {ch: write_kaldi_tree(str(root / f"tree{ch}"), 4,
                                       n_phones=3, n_pdfs=9, splits=SPLITS,
                                       wave_window=WIN, wave_channels=ch)
                  for ch in (1, 6)}


def _cfg(trees, name, tag):
    root, by_channels = trees
    front, recurrent, ch = CHAINS[name]
    return write_rate_cfg(by_channels[ch], str(root / f"{name}_{tag}"),
                          str(root / f"{name}_{tag}.cfg"), front,
                          {**RUN_CUTS, **(LIGRU_SHRINK if recurrent else {})},
                          recurrent=recurrent)


def _ep_numbers(out):
    """The loss and err values of res.res's `ep=` lines."""
    with open(os.path.join(out, "res.res")) as f:
        return [float(v) for line in f if line.startswith("ep=")
                for v in re.findall(r"(?:loss|err)=([\d.]+)", line)]


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_rate_run_matches_tpukaldi(name, trees):
    cfgs = {side: _cfg(trees, name, side) for side in ("tpk", "port")}
    init = save_seeded_init(cfgs["tpk"], CHAINS[name][2],
                            str(trees[0] / f"{name}_init"))
    tpk_run_experiment(cfgs["tpk"], overrides=init)
    before = chunk_runtime.train_batches
    run_experiment(cfgs["port"], overrides=init, device="cpu")
    assert chunk_runtime.train_batches > before
    outs = {side: os.path.splitext(cfg)[0] for side, cfg in cfgs.items()}
    want, got = _ep_numbers(outs["tpk"]), _ep_numbers(outs["port"])
    assert len(want) == len(got) == 2 * 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    a, b = (dict(forward_outputs(outs[s])[0]) for s in ("tpk", "port"))
    assert sorted(a) == sorted(b) and len(a) == SPLITS["test"][0]
    for key, w in a.items():
        assert b[key].shape == w.shape and w.shape[1] == 9
        np.testing.assert_allclose(b[key], w, rtol=0, atol=1e-3, err_msg=key)


def test_rate_chunks_take_the_host_path(trees, monkeypatch):
    """TPUKALDI_DEVICE_CACHE forced on: a rate-differing chunk is refused
    by the cache (`CacheUnavailable`) and counted as a host chunk with its
    reason."""
    monkeypatch.setenv("TPUKALDI_DEVICE_CACHE", "1")
    exp, plan = train_plan(_cfg(trees, "logMelFb_liGRU", "cache"))
    rt = chunk_runtime.ChunkRuntime(exp, "cpu")
    chunk_runtime.cache_chunks = chunk_runtime.host_chunks = 0
    chunk = rt.load_task_chunk(plan.epochs[0].tasks[0])
    assert chunk.rates_differ and rt.device_cache is not None
    assert (chunk_runtime.cache_chunks, chunk_runtime.host_chunks) == (0, 1)
    assert "rate-differing" in chunk_runtime.host_reason


def test_bf16_raises_in_both(trees, monkeypatch):
    """In bf16 compute mode tpukaldi's logMelFb fails in its FFT; the port
    refuses with NotImplementedError, the class and the dtype named,
    before any output is written (the out folder is never made), and the
    module itself refuses a bf16 input."""
    monkeypatch.setenv("TPUKALDI_COMPUTE_DTYPE", "bfloat16")
    with pytest.raises(ValueError, match="RFFT input must be float32"):
        tpk_run_experiment(_cfg(trees, "chavg_logMelFb", "bf16_tpk"))
    cfg = _cfg(trees, "chavg_logMelFb", "bf16_port")
    with pytest.raises(NotImplementedError,
                       match=r"logMelFb has no torch.bfloat16 compute mode"):
        run_experiment(cfg, device="cpu")
    assert not os.path.exists(os.path.splitext(cfg)[0])
    with pytest.raises(NotImplementedError, match="logMelFb has no"):
        logMelFb(MEL_OPTS, 1)(torch.zeros(800, 1, 1, dtype=torch.bfloat16))


# ------------------------------------------------ 3. forward lengths
@pytest.fixture(scope="module")
def raw_corpus(tmp_path_factory):
    """tests/test_rawwave.py's corpus: class-dependent tones."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(0)
    with ArkScpWriter(str(root / "feats.ark"), str(root / "feats.scp")) as w:
        for i in range(6):
            n_lab = int(rng.integers(40, 120))
            n_samp = (n_lab - 1) * SHIFT + WIN
            labels = rng.integers(0, 4, n_lab)
            t = np.arange(n_samp) / 16000.0
            freq = 200.0 + 400.0 * labels[np.minimum(
                (np.arange(n_samp) // SHIFT), n_lab - 1)]
            w.write(f"utt{i}", np.sin(2 * np.pi * freq * t)[:, None].astype(
                np.float32))
    return root


def test_forward_converts_lengths_to_frame_rate(raw_corpus, monkeypatch):
    """Bidirectional reversal runs at the output's frame rate: a
    rate-differing forward gives the step each utterance's label frames,
    (samples - window) // shift + 1, not its samples, one utterance a
    batch whatever TPUKALDI_FORWARD_BATCH says and unpacked, and the writer
    keeps that many rows."""
    ds = DatasetSpec(
        name="raw", section="dataset1",
        features={"wave": FeatureSpec("wave", str(raw_corpus / "feats.scp"),
                                      "", 0, 0)},
        labels={}, n_chunks=1)
    msl = [-1, -1, -1, -1, SHIFT, WIN]
    chunk = load_chunk(ds, ["wave"], [], msl, fea_only=True)
    assert chunk.rates_differ
    monkeypatch.setenv("TPUKALDI_FORWARD_BATCH", "8")
    captured, written = [], {}

    def fake_step(graph, feats, lengths, log_priors, pack_idx, dtype):
        captured.append((tuple(feats.shape), lengths.tolist(), pack_idx))
        return {"out": torch.zeros(feats.shape[0] * feats.shape[1], 4)}

    class NullWriter:
        log_priors = {}

        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def write(self, out_name, name, post):
            written[name] = post.shape

    class FakeRuntime(chunk_runtime.ChunkRuntime):
        def __init__(self):  # bypass the exp-requiring constructor
            self.device, self.compute_dtype = torch.device("cpu"), None
            self.graph = None
            self.exp = type("E", (), {"forward": None})()

        def ensure_initialized(self, *a, **k):
            pass

        def restore_from(self, *a, **k):
            pass

    monkeypatch.setattr(chunk_runtime, "forward_step", fake_step)
    monkeypatch.setattr(chunk_runtime, "PosteriorWriter", NullWriter)
    task = type("T", (), {"info_file": "/dev/null", "pretrain_files": {}})()
    res = FakeRuntime()._run_forward(task, chunk)
    assert len(captured) == chunk.n_sentences
    frames = (chunk.sentence_lengths - WIN) // SHIFT + 1
    for (shape, lens, pack), n in zip(captured, frames):
        assert shape[1] == 1 and pack is None and lens == [int(n)]
    assert sorted(written.values()) == sorted((int(n), 4) for n in frames)
    assert res.frames == int(frames.sum())
