"""The port's serving export (`tpukaldi_torch/tools/export_model.py`) on
the CPU, mirroring tests/test_export.py: a trained experiment exports to a
`torch.export` artifact with symbolic T and B whose reloaded forward
matches the live posteriors (1e-4), and tpukaldi's StableHLO artifact of
the same trained weights (1e-4).  Every recurrent family that tpukaldi
serves does so, the `*_cudnn` family and fusionRNN included, on a batch
with uneven lengths and a row of length 0 (the forward batches' padding).
The custom ops that keep T symbolic (`kernels/ops.py`) give, under fake
tensors, their real outputs' shapes, dtypes and strides
(`torch.library.opcheck`)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpukaldi.data.synth import generate_corpus, write_cfg
from tpukaldi_torch.config import load_config
from tpukaldi_torch.graph.compiler import build_graph, init_graph
from tpukaldi_torch.tools.export_model import (
    _sample_chunk,
    export_forward,
    load_exported,
    main,
)
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train import checkpoint as ckpt
from tpukaldi_torch.train.step import forward_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train(root, arch, **kw):
    corpus = generate_corpus(str(root / "c"), n_utts=8, feat_dim=12, seed=13,
                             noise=0.4, min_len=30, max_len=60)
    out = str(root / "e")
    cfg = write_cfg(corpus, out, arch=arch, hidden=16, n_epochs=1,
                    n_chunks=1, batch_size=kw.pop("batch_size", 4), cw=0,
                    lr=kw.pop("lr", 0.05))
    return cfg, out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg, out = _train(tmp_path_factory.mktemp("exp0"), "liGRU")
    run_experiment(cfg, device="cpu")
    return cfg, out


def _live_forward(cfg, feats, lengths):
    """The same forward through the live runtime path (`forward_step` over
    the graph with the final checkpoints)."""
    exp = load_config(cfg)
    chunk = _sample_chunk(exp)
    graph = build_graph(exp, chunk.fea_layout, chunk.lab_layout, "cpu")
    init_graph(graph, exp.seed)
    ef = os.path.join(exp.out_folder, "exp_files")
    ckpt.load_all({a: os.path.join(ef, f"final_{a}.ckpt")
                   for a in graph.arch_names}, graph.modules)
    return forward_step(graph, torch.from_numpy(feats),
                        torch.as_tensor(lengths, dtype=torch.int32))


def _assert_posteriors(got, want, tol):
    assert set(got) == set(want)
    for k in got:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)
        # log-softmax posteriors normalise in probability space
        np.testing.assert_allclose(np.exp(g.astype(np.float64)).sum(axis=1),
                                   1.0, atol=1e-3)


def test_export_roundtrip_matches_live(trained, tmp_path):
    """One artifact serves two lengths at two batch sizes, each within 1e-4
    of the live forward."""
    cfg, _ = trained
    model = load_exported(export_forward(cfg, str(tmp_path / "art")),
                          device="cpu")
    assert model.meta["seq_model"] is True and model.meta["outs"]
    assert model.meta["batch"] == 0  # symbolic T and B
    assert model.meta["platforms"] == ["cpu", "cuda"]
    assert model.meta["compute_dtype"] == "float32"
    rng = np.random.default_rng(3)
    for T, B in ((23, 1), (57, 3)):
        feats = rng.standard_normal((T, B, model.meta["inp_dim"])).astype(
            np.float32)
        lengths = np.asarray([T] * B, np.int32)
        got = {k: v.numpy() for k, v in model.call(feats, lengths).items()}
        want = {k: v.numpy() for k, v in
                _live_forward(cfg, feats, lengths).items()}
        _assert_posteriors(got, want, 1e-4)


def test_export_uneven_lengths_match_live(trained, tmp_path):
    """A padded batch (lengths below T) goes through the length-aware
    reversal with B symbolic: the live forward's posteriors, within 1e-4."""
    cfg, _ = trained
    model = load_exported(export_forward(cfg, str(tmp_path / "art")),
                          device="cpu")
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((31, 4, model.meta["inp_dim"])).astype(
        np.float32)
    lengths = np.asarray([31, 12, 25, 1], np.int32)
    got = {k: v.numpy() for k, v in model.call(feats, lengths).items()}
    want = {k: v.numpy() for k, v in
            _live_forward(cfg, feats, lengths).items()}
    _assert_posteriors(got, want, 1e-4)


def test_export_normalized_bakes_priors(trained, tmp_path):
    cfg, _ = trained
    model = load_exported(export_forward(cfg, str(tmp_path / "artn"),
                                         normalize=True), device="cpu")
    assert model.meta["normalized"], "priors should be baked"
    rng = np.random.default_rng(5)
    T = 31
    feats = rng.standard_normal((T, 1, model.meta["inp_dim"])).astype(
        np.float32)
    raw = load_exported(export_forward(cfg, str(tmp_path / "artr")),
                        device="cpu").call(feats, [T])
    normed = model.call(feats, [T])
    name = model.meta["normalized"][0]
    diff = (raw[name] - normed[name]).numpy()
    # the difference is exactly the (row-constant) log-prior vector
    np.testing.assert_allclose(
        diff, np.broadcast_to(diff[0:1], diff.shape), rtol=1e-5, atol=1e-5)
    assert np.abs(diff[0]).max() > 1e-3


def test_export_cli(trained, tmp_path):
    """`python -m tpukaldi_torch.tools.export_model <cfg> --out <dir>` in a
    fresh process, and `main` in this one with a pinned batch."""
    cfg, _ = trained
    art = str(tmp_path / "cli_art")
    r = subprocess.run(
        [sys.executable, "-m", "tpukaldi_torch.tools.export_model", cfg,
         "--out", art], capture_output=True, text=True, cwd=REPO,
        timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(os.path.join(art, "forward.pt2"))
    assert os.path.exists(os.path.join(art, "meta.json"))
    pinned = str(tmp_path / "pinned")
    assert main([cfg, "--out", pinned, "--batch", "2",
                 "--platforms", "cpu"]) == 0
    with open(os.path.join(pinned, "meta.json")) as f:
        meta = json.load(f)
    assert meta["batch"] == 2 and meta["platforms"] == ["cpu"]
    out = load_exported(pinned, device="cpu").call(
        np.zeros((7, 2, meta["inp_dim"]), np.float32))
    assert all(v.shape[0] == 14 for v in out.values())


# the *_cudnn classes over `write_cfg`'s LSTM cfg, its [architecture1]
# given the keys of cfg/TIMIT/LSTM_fmllr_cudnn.cfg:134-157 at hidden 16 and
# 2 layers: family -> (class, the options it changes)
CUDNN = {
    "LSTM_cudnn": ("LSTM_cudnn", {}),
    "LSTM_cudnn_unidir": ("LSTM_cudnn", {"bidirectional": "False"}),
    "GRU_cudnn": ("GRU_cudnn", {}),
    "RNN_cudnn_tanh": ("RNN_cudnn", {"nonlinearity": "tanh"}),
    "RNN_cudnn_relu": ("RNN_cudnn", {"nonlinearity": "relu"}),
}
CUDNN_KEYS = dict(hidden_size="16", num_layers="2", bias="True",
                  batch_first="True", dropout="0.2", bidirectional="True")
# the families that did not export before the `*_cudnn` layers and
# fusionRNN's recurrence ran custom ops, and RNN and minimalGRU, which no
# test held
NEW_FAMILIES = ["RNN", "minimalGRU", "fusionRNN", *CUDNN]
# a serving batch: uneven lengths, one row of length 0
T_SERVE, LENGTHS = 19, [19, 11, 0]


def _cudnn_cfg(cfg, cls, options):
    """Rewrite the synthetic LSTM cfg's [architecture1] into `cls` with
    CUDNN_KEYS updated by `options` (tpukaldi's `write_cfg` has no
    `*_cudnn` branch)."""
    with open(cfg) as f:
        lines = f.read().split("\n")
    start = lines.index("[architecture1]")
    end = next(i for i in range(start + 1, len(lines))
               if lines[i].startswith("["))
    section = []
    for line in lines[start:end]:
        key = line.split(" = ", 1)[0]
        if key == "arch_proto":
            line = f"{key} = proto/{cls}.proto"
        elif key == "arch_class":
            line = f"{key} = {cls}"
        elif key.startswith("lstm_"):
            # the LSTM's keys give way to the *_cudnn ones, in their place
            if key == "lstm_lay":
                section += [f"{k} = {v}" for k, v in
                            {**CUDNN_KEYS, **options}.items()]
            continue
        section.append(line)
    with open(cfg, "w") as f:
        f.write("\n".join(lines[:start] + section + lines[end:]))
    return cfg


def _train_family(root, family):
    """`family` trained by the port on the CPU: (cfg, out)."""
    cls, options = CUDNN.get(family, (None, None))
    cfg, out = _train(root, "LSTM" if cls else family)
    if cls:
        _cudnn_cfg(cfg, cls, options)
    run_experiment(cfg, device="cpu")
    return cfg, out


def _serving_batch(inp_dim, seed):
    """(feats (T_SERVE, 3, inp_dim), LENGTHS, the valid frames' mask over
    the T*B output rows): zeros past each row's length, as the forward
    batches pad."""
    feats = np.random.default_rng(seed).standard_normal(
        (T_SERVE, len(LENGTHS), inp_dim)).astype(np.float32)
    valid = np.arange(T_SERVE)[:, None] < np.asarray(LENGTHS)[None, :]
    feats[~valid] = 0.0
    return feats, np.asarray(LENGTHS, np.int32), valid.reshape(-1)


@pytest.mark.parametrize("arch", ["GRU", "LSTM", "SRU", "QLSTM",
                                  *NEW_FAMILIES])
def test_export_zoo_family(arch, tmp_path):
    """Every recurrent family exports with a symbolic batch and serves the
    live forward's posteriors (1e-4) on a batch with uneven lengths and a
    row of length 0, every frame finite."""
    cfg, _ = _train_family(tmp_path, arch)
    model = load_exported(export_forward(cfg, str(tmp_path / "art")),
                          device="cpu")
    assert model.meta["batch"] == 0
    feats, lengths, _ = _serving_batch(model.meta["inp_dim"], 7)
    got = {k: v.numpy() for k, v in model.call(feats, lengths).items()}
    for v in got.values():
        assert v.shape[0] == feats.shape[0] * feats.shape[1]
        assert np.isfinite(v).all()
    want = {k: v.numpy() for k, v in
            _live_forward(cfg, feats, lengths).items()}
    _assert_posteriors(got, want, 1e-4)


@pytest.mark.parametrize("family", NEW_FAMILIES)
def test_port_family_artifact_matches_tpukaldis(family, tmp_path):
    """tpukaldi's `export_forward` over the same trained checkpoints serves
    the port artifact's posteriors within 1e-4 on the valid frames of a
    batch with uneven lengths and a row of length 0."""
    from tpukaldi.tools.export_model import export_forward as tpk_export
    from tpukaldi.tools.export_model import load_exported as tpk_load

    cfg, _ = _train_family(tmp_path, family)
    port = load_exported(export_forward(cfg, str(tmp_path / "port")),
                         device="cpu")
    tpk = tpk_load(tpk_export(cfg, str(tmp_path / "tpk")))
    assert port.meta["batch"] == tpk.meta["batch"] == 0
    feats, lengths, valid = _serving_batch(port.meta["inp_dim"], 11)
    got = {k: v.numpy()[valid] for k, v in port.call(feats, lengths).items()}
    want = {k: np.asarray(v)[valid] for k, v in
            tpk.call(feats, lengths).items()}
    _assert_posteriors(got, want, 1e-4)


def test_export_bf16_experiment_records_dtype(tmp_path):
    """A bf16 cfg exports in the compute dtype its ledger and decode
    posteriors used (meta.compute_dtype = bfloat16), float32 out."""
    cfg, _ = _train(tmp_path, "MLP", batch_size=32, lr=0.2)
    with open(cfg) as f:
        text = f.read().replace("[exp]", "[exp]\ncompute_dtype = bfloat16", 1)
    with open(cfg, "w") as f:
        f.write(text)
    run_experiment(cfg, device="cpu")
    model = load_exported(export_forward(cfg, str(tmp_path / "art")),
                          device="cpu")
    assert model.meta["compute_dtype"] == "bfloat16"
    assert "per-chunk CMVN" in model.meta["input_contract"]["preprocessing"]
    feats = np.random.default_rng(1).standard_normal(
        (9, 2, model.meta["inp_dim"])).astype(np.float32)
    for v in model.call(feats, [9, 9]).values():
        v = v.numpy()
        assert v.dtype == np.float32 and np.isfinite(v).all()
        np.testing.assert_allclose(np.exp(v.astype(np.float64)).sum(axis=1),
                                   1.0, atol=1e-2)


def test_export_bf16_fusion_chooses_k1_where_served(tmp_path, monkeypatch):
    """A bf16 fusionRNN artifact traced on the CPU leaves the choice of its
    recurrence to the op where it runs: its graph holds one
    `tpukaldi::fusion_recurrence` node a layer with tensor inputs only; on
    the CPU the op runs the plain loop carrying bf16, never K1's wrapper;
    where the op sees a card's tensor it calls K1's wrapper (K1f there) on
    float32 inputs, once a layer."""
    from tpukaldi_torch.kernels import ligru, ops

    cfg, _ = _train(tmp_path, "fusionRNN")
    with open(cfg) as f:
        text = f.read().replace("[exp]", "[exp]\ncompute_dtype = bfloat16", 1)
    with open(cfg, "w") as f:
        f.write(text)
    run_experiment(cfg, device="cpu")
    model = load_exported(export_forward(cfg, str(tmp_path / "art")),
                          device="cpu")
    assert model.meta["compute_dtype"] == "bfloat16"
    assert model.meta["batch"] == 0
    # the forward sits in a grad-mode wrapper's submodule
    nodes = [n for gm in model.program.graph_module.modules()
             if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
             if n.target is torch.ops.tpukaldi.fusion_recurrence.default]
    assert nodes and all(isinstance(a, torch.fx.Node)
                         for n in nodes for a in n.args)
    k1_inputs = []
    wrapper = ligru.ligru_recurrence

    def spy(ff, u, mask):
        k1_inputs.append((ff.dtype, u.dtype, mask.dtype))
        return wrapper(ff, u, mask)

    monkeypatch.setattr(ligru, "ligru_recurrence", spy)
    feats, lengths, _ = _serving_batch(model.meta["inp_dim"], 5)
    on_cpu = model.call(feats, lengths)
    assert k1_inputs == []
    monkeypatch.setattr(ops, "_fusion_on_k1", lambda ff: True)
    as_served = model.call(feats, lengths)
    assert k1_inputs == [(torch.float32,) * 3] * len(nodes)
    for posteriors in (on_cpu, as_served):
        for v in posteriors.values():
            assert torch.isfinite(v).all()


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_export_sincnet_251_matches_live(impl, tmp_path, monkeypatch):
    """cfg/TIMIT/SincNet_raw.cfg at SincNet's published filter lengths
    (`sinc_len_filt = 251,5,5`), shrunk to 16-filter convs and a 32-wide
    MLP over 400-sample windows, from seeded final checkpoints: it exports
    at batch 0 and the artifact serves the live forward's posteriors within
    1e-4 on a batch with a row of length 0, every frame finite.  Under
    `pallas` layer 0 is the `tpukaldi::conv_pool` op (K5's no-grad entry)
    in the exported graph, its fake at K = 251; under `auto` the CPU's
    composed path."""
    from tpukaldi_torch.tools.flagship_tree import (
        recipe_cfg,
        save_seeded_finals,
        write_kaldi_tree,
        write_prod_cfg,
    )

    monkeypatch.setenv("TPUKALDI_CONV_IMPL", impl)
    L = 400
    tree = write_kaldi_tree(str(tmp_path / "tree"), 10, n_phones=3, n_pdfs=9,
                            splits={"train": (2, 20, 30), "dev": (2, 20, 30),
                                    "test": (3, 20, 30)}, raw_wlen=L)
    cfg = write_prod_cfg(tree, str(tmp_path / "out"), str(tmp_path / "run.cfg"),
                         {"sinc_n_filt = 80,60,60": "sinc_n_filt = 16,8,8",
                          "sinc_len_filt = 129,5,3": "sinc_len_filt = 251,5,5",
                          "dnn_lay = 2048,2048,N_out_lab_cd":
                          "dnn_lay = 32,32,N_out_lab_cd"},
                         recipe=recipe_cfg("SincNet"))
    save_seeded_finals(cfg, L)
    model = load_exported(export_forward(cfg, str(tmp_path / "art")),
                          device="cpu")
    assert model.meta["batch"] == 0 and model.meta["inp_dim"] == L
    # (the forward's no_grad region is a submodule of the exported graph)
    ops = [n for gm in model.program.graph_module.modules()
           if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
           if n.op == "call_function"
           and n.target == torch.ops.tpukaldi.conv_pool.default]
    assert len(ops) == (1 if impl == "pallas" else 0)
    if ops:
        assert tuple(ops[0].args[1].meta["val"].shape) == (251, 16)
    feats, lengths, _ = _serving_batch(L, 5)
    got = {k: v.numpy() for k, v in model.call(feats, lengths).items()}
    for v in got.values():
        assert v.shape[0] == feats.shape[0] * feats.shape[1]
        assert np.isfinite(v).all()
    want = {k: v.numpy() for k, v in
            _live_forward(cfg, feats, lengths).items()}
    _assert_posteriors(got, want, 1e-4)


def test_export_requires_trained_checkpoints(tmp_path):
    corpus = generate_corpus(str(tmp_path / "c"), n_utts=6, seed=1)
    cfg = write_cfg(corpus, str(tmp_path / "e"), arch="MLP", n_epochs=1,
                    n_chunks=1)
    with pytest.raises(FileNotFoundError, match="final checkpoints"):
        export_forward(cfg, str(tmp_path / "a"))


def test_port_artifact_matches_tpukaldis(trained, tmp_path):
    """tpukaldi's `export_forward` over the same trained checkpoints (the
    ledger format both packages write) serves the port artifact's
    posteriors within 1e-4."""
    from tpukaldi.tools.export_model import export_forward as tpk_export
    from tpukaldi.tools.export_model import load_exported as tpk_load

    cfg, _ = trained
    port = load_exported(export_forward(cfg, str(tmp_path / "port")),
                         device="cpu")
    tpk = tpk_load(tpk_export(cfg, str(tmp_path / "tpk")))
    rng = np.random.default_rng(11)
    for T, B in ((17, 1), (40, 3)):
        feats = rng.standard_normal((T, B, port.meta["inp_dim"])).astype(
            np.float32)
        got = {k: v.numpy() for k, v in port.call(feats, [T] * B).items()}
        want = {k: np.asarray(v) for k, v in tpk.call(feats, [T] * B).items()}
        _assert_posteriors(got, want, 1e-4)


def _op_cases():
    """(op, args) for every custom op at small shapes, the plain loops in
    float32 and bf16, with and without a layer norm."""
    from tpukaldi_torch.kernels import ops  # noqa: F401

    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    T, B, H = 5, 3, 4
    ln = (r(H).abs() + 0.5, r(H), 1e-6)
    no_ln = (None, None, 0.0)
    mask = torch.ones(B, H)
    t = torch.ops.tpukaldi
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [
            (t.ligru_recurrence, (r(T, B, 2 * H, dtype=dtype),
                                  r(H, 2 * H, dtype=dtype),
                                  mask.to(dtype), True, "relu", *no_ln)),
            (t.ligru_recurrence, (r(T, B, 2 * H, dtype=dtype),
                                  r(H, 2 * H, dtype=dtype),
                                  mask.to(dtype), False, "tanh", *ln)),
            (t.lstm_recurrence, (r(T, B, 4 * H, dtype=dtype),
                                 r(H, 4 * H, dtype=dtype), mask.to(dtype),
                                 dtype == torch.float32, "tanh", *no_ln)),
            (t.fusion_recurrence, (r(T, B, 2 * H, dtype=dtype),
                                   r(H, 2 * H, dtype=dtype),
                                   mask.to(dtype))),
            (t.lstm_recurrence_lean, (r(T, B, 4 * H, dtype=dtype),
                                      r(H, 4 * H), mask, "pallas")),
            (t.gru_recurrence, (r(T, B, 3 * H, dtype=dtype),
                                r(H, 2 * H, dtype=dtype), r(H, H, dtype=dtype),
                                mask.to(dtype), True, "tanh", *no_ln)),
            (t.minimalgru_recurrence, (r(T, B, 2 * H, dtype=dtype),
                                       r(H, H, dtype=dtype),
                                       r(H, H, dtype=dtype), mask.to(dtype),
                                       "relu", *ln)),
            (t.rnn_recurrence, (r(T, B, H, dtype=dtype), r(H, H, dtype=dtype),
                                mask.to(dtype), "tanh", *no_ln)),
            (t.sru_recurrence, (r(T, B, H, dtype=dtype), r(T, B, H),
                                r(T, B, H), r(T, B, H), r(H), r(H), r(H),
                                r(H), "selu", 1.5)),
            (t.conv_pool, (r(4, 50, dtype=dtype), r(7, 5, dtype=dtype), 3)),
            (t.conv_pool_ln_act, (r(4, 50, dtype=dtype), r(7, 5), r(5),
                                  r(14, 5), r(14, 5), 3, 1e-6, True)),
        ]
    # the *_cudnn layer: each mode, bidirectional with lengths (one of
    # them 0) and without, unidirectional, with and without biases,
    # widened to float32 out
    lengths = torch.tensor([5, 2, 0], dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        for mode, G, bidir, lens, bias in (
                ("LSTM", 4, True, lengths, True),
                ("GRU", 3, False, None, True),
                ("RNN_TANH", 1, True, None, False),
                ("RNN_RELU", 1, True, lengths, True)):
            weights = []
            for _ in range(2 if bidir else 1):
                weights += [r(G * H, 6, dtype=dtype), r(G * H, H, dtype=dtype)]
                if bias:
                    weights += [r(G * H, dtype=dtype), r(G * H, dtype=dtype)]
            cases.append((t.cudnn_rnn_layer, (
                r(T, B, 6, dtype=dtype), lens, weights, bias, mode, bidir)))
    # the conv ops at SincNet's published 251 taps, and with a pool of 16
    # (past the forwards' run of 12 conv positions)
    for K, pool in ((251, 3), (251, 16)):
        M = (300 - K + 1) // pool
        cases += [(t.conv_pool, (r(2, 300), r(K, 5), pool)),
                  (t.conv_pool_ln_act, (r(2, 300), r(K, 5), r(5), r(M, 5),
                                        r(M, 5), pool, 1e-6, True))]
    return cases


@pytest.mark.parametrize("index", range(34))
def test_custom_op_fakes_match_real_outputs(index):
    """Each op's fake (the shape torch.export traces with) has the real
    output's shape, dtype and strides, and its schema holds."""
    op, args = _op_cases()[index]
    torch.library.opcheck(op.default, args,
                          test_utils=("test_schema", "test_faketensor"))
