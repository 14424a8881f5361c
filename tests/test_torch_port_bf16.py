"""The port's bf16 compute mode (`[exp] compute_dtype = bfloat16`,
`TPUKALDI_COMPUTE_DTYPE`; tpukaldi_torch/train/step.py) against tpukaldi's
(tpukaldi/train/step.py).

1. tests/test_bf16.py case for case on the port: the cast set and its
   exemptions, a bf16 step that keeps float32 masters, optimizer state and
   batchnorm statistics, float32 eval and forward outputs, posteriors close
   to float32's, `run_experiment` converging on an MLP, the zoo training
   end to end, a bad dtype rejected.
2. The port held to tpukaldi with the same weights at drop 0, on one batch
   (sequence models T = 12, B = 3, 9 valid frames; frame models 36 rows):
   liGRU, LSTM and GRU through their kernels (tpukaldi's Pallas kernels in
   interpret mode at `*_impl = pallas`; the port's autograd Functions at
   `auto`, which on a CPU tensor run the kernels' plain versions) and
   through the scan on both sides, the QLSTM likewise (K4's bf16-ff path,
   and the scan), an MLP and SincNet; 2 layers of 16 (the MLP 24):
   - loss: the port's bf16 loss within max(2 |tpk bf16 - tpk f32|, 1e-3)
     of tpukaldi's bf16 loss;
   - gradients: per parameter, the port's bf16 master gradient no further
     from tpukaldi's float32 gradient (the L2 norm of the difference) than
     2x tpukaldi's own bf16 gradient is (the repo's factor-2 rule);
   - posteriors: within 0.05 in probability space of tpukaldi's bf16 ones
     (tests/test_bf16.py's bound against float32).
   The cast set, in tpukaldi's naming through `to_jax_params`, is
   tpukaldi's for each of these models.
3. K4's plain version with a bf16 ff: h and c bitwise the float32 entry's
   on ff.float(), dff bitwise the float32 dff rounded to bf16, du from the
   rounded dff; and tpukaldi's lean kernel (interpret mode) on the same bf16
   ff.  The float32-only entries refuse a bf16 tensor.
4. Checkpoints of a bf16 run keep float32 masters: tpukaldi's read by the
   port, the port's by tpukaldi, bit for bit.
"""

import glob
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.config.model_dsl import parse_model
from tpukaldi.data.synth import generate_corpus, write_cfg
from tpukaldi.graph import compiler as jax_compiler
from tpukaldi.kernels import lstm as jax_lstm
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi.train.checkpoint import load_checkpoint
from tpukaldi.train.step import _cast_compute as tpk_cast_compute
from tpukaldi.train.step import _loss_fn, make_forward_step
from tpukaldi_torch.compat.jax_params import from_jax_params, to_jax_params
from tpukaldi_torch.config import load_config
from tpukaldi_torch.data import iter_seq_batches, load_chunk
from tpukaldi_torch.graph import compiler
from tpukaldi_torch.kernels import conv1d, gru, ligru, lstm
from tpukaldi_torch.models import SincNet
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train.checkpoint import load_all, read_checkpoint
from tpukaldi_torch.train.chunk_runtime import ChunkRuntime, compute_dtype
from tpukaldi_torch.train.optimizers import make_all_optimizers
from tpukaldi_torch.train.step import (
    _cast_compute,
    eval_step,
    forward_step,
    train_step,
)
from test_torch_port_zoo import CASES as ZOO_CASES
from test_torch_port_zoo import _setup as _zoo_setup
from torch_port_helpers import assert_trees_close, port_tree

BF16 = torch.bfloat16
KNOBS = ("TPUKALDI_COMPUTE_DTYPE", "TPUKALDI_MATMUL_PRECISION",
         "TPUKALDI_CONV_IMPL")


@pytest.fixture(autouse=True)
def no_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


# ------------------------------------------- 1. tests/test_bf16.py's cases
@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_bf16.py's corpus and cfg (a liGRU of 24), read by the port:
    (exp, chunk)."""
    root = tmp_path_factory.mktemp("bf16")
    corpus = generate_corpus(str(root / "corpus"), n_utts=12, seed=5,
                             noise=0.4)
    cfg = write_cfg(corpus, str(root / "exp"), arch="liGRU", hidden=24,
                    n_epochs=2, n_chunks=2, batch_size=4, lr=0.1)
    exp = load_config(cfg)
    os.makedirs(exp.out_folder, exist_ok=True)
    ds = exp.datasets["synth_tr"]
    chunk = load_chunk(ds, ["mfcc"], ["lab_cd"], 1000, seed=1)
    return exp, chunk


def _graph_state(exp, chunk):
    """The graph from seed 0, its first batch and its optimizers."""
    graph = compiler.build_graph(exp, chunk.fea_layout, chunk.lab_layout,
                                 "cpu")
    compiler.init_graph(graph, 0)
    batch = next(iter_seq_batches(chunk, 4))
    return graph, batch, make_all_optimizers(graph.archs, graph.modules)


def _tensors(batch):
    return (torch.from_numpy(batch.feats), torch.from_numpy(batch.labs),
            batch.n_valid_t)


def test_bf16_step_tracks_f32_and_keeps_f32_masters(setup):
    """Four bf16 train steps end within 0.05 of the float32 steps' loss;
    the weights, the batchnorm statistics, the optimizer state and the loss
    stay float32."""
    exp, chunk = setup
    results = {}
    for mode, cdt in (("f32", None), ("bf16", BF16)):
        graph, batch, optimizers = _graph_state(exp, chunk)
        feats, labs, n_valid = _tensors(batch)
        for i in range(4):
            loss, _ = train_step(graph, optimizers, feats, labs, n_valid,
                                 torch.Generator().manual_seed(i), cdt)
        results[mode] = loss.item()
        assert loss.dtype == torch.float32
        for module in graph.modules.values():
            for name, t in module.state_dict().items():
                if t.is_floating_point():
                    assert t.dtype == torch.float32, name
        for opt in optimizers.values():
            for state in opt.opt.state.values():
                for key, t in state.items():
                    if torch.is_tensor(t) and t.is_floating_point():
                        assert t.dtype == torch.float32, key
    assert abs(results["f32"] - results["bf16"]) < 0.05, results


def test_bf16_eval_and_forward_outputs_f32(setup):
    """bf16 eval gives a finite float32 loss; bf16 forward gives float32
    log-posteriors whose rows sum to 1 within 1e-3 in probability space."""
    exp, chunk = setup
    graph, batch, _ = _graph_state(exp, chunk)
    feats, labs, n_valid = _tensors(batch)
    loss, _ = eval_step(graph, feats, labs, n_valid, BF16)
    assert loss.dtype == torch.float32 and np.isfinite(loss.item())
    outs = forward_step(graph, feats, torch.from_numpy(batch.lengths),
                        compute_dtype=BF16)
    for v in outs.values():
        assert v.dtype == torch.float32
        assert torch.isfinite(v).all()
        np.testing.assert_allclose(v.double().exp().sum(dim=1).numpy(), 1.0,
                                   atol=1e-3)


def test_bf16_close_to_f32_posteriors(setup):
    """The same weights and input: bf16 posteriors within 0.05 of float32's
    in probability space."""
    exp, chunk = setup
    graph, batch, _ = _graph_state(exp, chunk)
    feats, lengths = torch.from_numpy(batch.feats), torch.from_numpy(
        batch.lengths)
    f32 = forward_step(graph, feats, lengths)
    b16 = forward_step(graph, feats, lengths, compute_dtype=BF16)
    for k in f32:
        np.testing.assert_allclose(b16[k].exp().numpy(), f32[k].exp().numpy(),
                                   atol=0.05)


def _valid_errs(res_file):
    with open(res_file) as f:
        return [float(m.group(1)) for m in re.finditer(
            r"valid=\S+ loss=\S+ err=(\d+\.\d+)", f.read())]


def test_bf16_e2e_run_exp_converges(tmp_path):
    """`run_experiment` with `[exp] compute_dtype = bfloat16` on an MLP:
    three epochs, the last valid error below 0.15."""
    corpus = generate_corpus(str(tmp_path / "corpus"), n_utts=16, seed=9,
                             noise=0.3)
    cfg = write_cfg(corpus, str(tmp_path / "exp"), arch="MLP", n_epochs=3,
                    n_chunks=2, batch_size=64, lr=0.2)
    with open(cfg) as f:
        text = f.read().replace("[exp]", "[exp]\ncompute_dtype = bfloat16", 1)
    with open(cfg, "w") as f:
        f.write(text)
    run_experiment(cfg, device="cpu")
    errs = _valid_errs(str(tmp_path / "exp" / "res.res"))
    assert len(errs) == 3
    assert errs[-1] < 0.15, f"bf16 e2e did not converge: {errs}"


@pytest.mark.parametrize("arch", ["GRU", "LSTM", "RNN", "minimalGRU", "SRU",
                                  "QLSTM", "fusionRNN"])
def test_bf16_zoo_trains_e2e(arch, tmp_path, monkeypatch):
    """Every recurrent family trains through `run_experiment` under
    TPUKALDI_COMPUTE_DTYPE=bfloat16: valid error in (0, 0.85)."""
    monkeypatch.setenv("TPUKALDI_COMPUTE_DTYPE", "bfloat16")
    corpus = generate_corpus(str(tmp_path / "c"), n_utts=10, feat_dim=12,
                             seed=31, min_len=40, max_len=120, noise=0.3)
    out = str(tmp_path / "exp")
    cfg = write_cfg(corpus, out, arch=arch, hidden=16, n_epochs=1,
                    n_chunks=1, batch_size=4, cw=0, lr=0.05)
    run_experiment(cfg, device="cpu")
    (verr,) = _valid_errs(os.path.join(out, "res.res"))
    assert 0.0 < verr < 0.85, f"{arch} bf16 bogus valid err: {verr}"


def test_sinc_cutoff_params_exempt_from_bf16_cast():
    """SincNet's cut-offs stay float32 through `_cast_compute` (tpukaldi's
    `_CAST_EXEMPT`); its other parameters and the features are cast."""
    module = SincNet(SINC_OPTS, L_RAW)
    graph = SimpleNamespace(modules={"SincNet_layers": module})
    cast, feats = _cast_compute(graph, torch.ones(3, L_RAW), BF16)
    cast = cast["SincNet_layers"]
    assert cast["conv.0.low_hz_"].dtype == torch.float32
    assert cast["conv.0.band_hz_"].dtype == torch.float32
    assert cast["conv.1.weight"].dtype == BF16
    assert cast["ln.0.gamma"].dtype == BF16
    assert feats.dtype == BF16
    # float32 casts nothing
    assert _cast_compute(graph, feats, None)[0] is None


def test_bad_compute_dtype_rejected(setup):
    """The cfg field as the runtime reads it (`chunk_runtime.compute_dtype`,
    tpukaldi's `ChunkRuntime._compute_dtype`): float16 raises ValueError,
    bfloat16 is torch.bfloat16, none is None (float32)."""
    exp, _ = setup
    exp.raw["exp"]["compute_dtype"] = "float16"
    with pytest.raises(ValueError, match="compute_dtype"):
        ChunkRuntime(exp, "cpu")
    exp.raw["exp"]["compute_dtype"] = "bfloat16"
    assert compute_dtype(exp) == BF16
    assert ChunkRuntime(exp, "cpu").compute_dtype == BF16
    del exp.raw["exp"]["compute_dtype"]
    assert compute_dtype(exp) is None


# -------------------------------------------- 2. the port against tpukaldi
T, B, N_VALID, N_FRAMES, D_SEQ, N_CD = 12, 3, 9, 36, 8, 9
L_RAW = 400
RMS = SimpleNamespace(kind="rmsprop", options={
    "opt_alpha": 0.95, "opt_eps": 1e-8, "opt_momentum": 0.0,
    "opt_centered": False, "opt_weight_decay": 0.0})
HEAD = dict(dnn_lay=str(N_CD), dnn_drop="0.0", dnn_use_batchnorm="False",
            dnn_use_laynorm="False", dnn_use_laynorm_inp="False",
            dnn_use_batchnorm_inp="False", dnn_act="softmax")
SINC_OPTS = dict(
    sinc_n_filt="16,8", sinc_len_filt="129,5", sinc_max_pool_len="3,3",
    sinc_sample_rate="16000", sinc_min_low_hz="50", sinc_min_band_hz="50",
    sinc_use_laynorm_inp="True", sinc_use_batchnorm_inp="False",
    sinc_use_laynorm="True,True", sinc_use_batchnorm="False,True",
    sinc_act="leaky_relu,leaky_relu", sinc_drop="0.0,0.0")


def _cell(prefix, act):
    return {f"{prefix}_lay": "16,16", f"{prefix}_drop": "0.0,0.0",
            f"{prefix}_use_batchnorm": "True,True",
            f"{prefix}_use_laynorm": "False,False",
            f"{prefix}_act": f"{act},{act}", f"{prefix}_bidir": "True",
            f"{prefix}_orthinit": "True"}


QLSTM_OPTS = dict(lstm_lay="16,16", lstm_drop="0.0,0.0", lstm_bidir="True",
                  lstm_act="tanh,tanh", quaternion_init="quaternion",
                  autograd="False")
MLP_OPTS = dict(dnn_lay=f"24,{N_CD}", dnn_drop="0.0,0.0",
                dnn_use_batchnorm="True,False", dnn_use_laynorm="False,False",
                dnn_use_laynorm_inp="False", dnn_use_batchnorm_inp="False",
                dnn_act="relu,softmax")
# name -> (class, options, tpukaldi's impl option and value, the port's
# value, sequence model): tpukaldi's `pallas` (interpret mode off a TPU) is
# the port's kernel route, which `auto` takes on a CPU tensor for the
# TIMIT cells (`pallas` refuses one there) and `pallas` for the QLSTM
CASES = {
    "liGRU-kernel": ("liGRU", _cell("ligru", "relu"), "ligru_impl", "pallas",
                     "auto", True),
    "liGRU-scan": ("liGRU", _cell("ligru", "relu"), "ligru_impl", "scan",
                   "scan", True),
    "LSTM-kernel": ("LSTM", _cell("lstm", "tanh"), "lstm_impl", "pallas",
                    "auto", True),
    "LSTM-scan": ("LSTM", _cell("lstm", "tanh"), "lstm_impl", "scan", "scan",
                  True),
    "GRU-kernel": ("GRU", _cell("gru", "tanh"), "gru_impl", "pallas", "auto",
                   True),
    "GRU-scan": ("GRU", _cell("gru", "tanh"), "gru_impl", "scan", "scan",
                 True),
    "QLSTM-kernel": ("QLSTM", QLSTM_OPTS, "qlstm_impl", "pallas", "pallas",
                     True),
    "QLSTM-scan": ("QLSTM", QLSTM_OPTS, "qlstm_impl", "scan", "scan", True),
    "MLP": ("MLP", MLP_OPTS, None, None, None, False),
    "SincNet": ("SincNet", SINC_OPTS, None, None, None, False),
}


def _exp(case, side):
    """The case's program (the model, then a softmax head but for the MLP,
    which ends in its own), rmsprop, with `side`'s impl option."""
    cls, opts, knob, tpk_impl, port_impl, seq = CASES[case]
    opts = dict(opts)
    if knob:
        opts[knob] = tpk_impl if side == "tpk" else port_impl

    def arch(name, cls, seq, **o):
        return SimpleNamespace(name=name, class_name=cls,
                               library="tpukaldi.models", seq_model=seq,
                               freeze=False, options=o, optimizer=RMS,
                               lr=[4e-4])

    archs = {"net": arch("net", cls, seq, **opts)}
    program = "out=compute(net,fea)\n"
    if cls != "MLP":
        archs["head"] = arch("head", "MLP", False, **HEAD)
        program = "hid=compute(net,fea)\nout=compute(head,hid)\n"
    program += ("loss_final=cost_nll(out,lab_cd)\n"
                "err_final=cost_err(out,lab_cd)\n")
    return SimpleNamespace(model=parse_model(program), archs=archs,
                           forward=SimpleNamespace(outs=["out"]))


def _batch(case):
    seq = CASES[case][-1]
    rng = np.random.default_rng(11)
    width = L_RAW if CASES[case][0] == "SincNet" else D_SEQ
    shape = (T, B) if seq else (N_FRAMES,)
    feats = rng.standard_normal((*shape, width)).astype(np.float32)
    labs = rng.integers(0, N_CD, shape)[..., None]
    return feats, labs, {"fea": (0, width)}, (N_VALID if seq else None)


def _graphs(case):
    """tpukaldi's graph and init (batchnorm parameters as initialised,
    statistics at their init), and the port's graph loaded from it."""
    feats, labs, fea, n_valid = _batch(case)
    lab = {"lab_cd": 0}
    jg = jax_compiler.build_graph(_exp(case, "tpk"), fea, lab)
    params, stats = jax_compiler.init_graph(jg, jax.random.key(3),
                                            jnp.asarray(feats))
    params = jax.tree_util.tree_map(np.asarray, params)
    stats = jax.tree_util.tree_map(np.asarray, stats)
    pg = compiler.build_graph(_exp(case, "port"), fea, lab, "cpu")
    for name, module in pg.modules.items():
        module.load_state_dict(from_jax_params(
            type(module).__name__, params[name], stats.get(name, {})))
    return jg, params, stats, pg, feats, labs, n_valid


def _distance(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64)))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_matches_tpukaldi(case, monkeypatch):
    """Loss, every gradient and the posteriors of one bf16 step, port
    against tpukaldi, by the bounds of the module docstring."""
    if CASES[case][0] == "SincNet":
        # layer 0 through the kernels' entries on both sides (tpukaldi's
        # interpret mode, the port's plain versions behind its boundary cast)
        monkeypatch.setenv("TPUKALDI_CONV_IMPL", "pallas")
    jg, params, stats, pg, feats, labs, n_valid = _graphs(case)
    params, stats = (jax.tree_util.tree_map(jnp.asarray, t)
                     for t in (params, stats))
    jn_valid = None if n_valid is None else jnp.asarray(n_valid)
    tpk = {}
    for mode, cdt in (("f32", None), ("bf16", jnp.bfloat16)):
        (loss, _), grads = jax.value_and_grad(_loss_fn, has_aux=True)(
            params, jg, stats, jnp.asarray(feats), jnp.asarray(labs), None,
            jn_valid, cdt)
        tpk[mode] = (float(loss), jax.tree_util.tree_map(np.asarray, grads))
    seq = n_valid is not None
    lengths = np.full(B, T, np.int32) if seq else None
    want = make_forward_step(jg, compute_dtype=jnp.bfloat16)(
        params, stats, jnp.asarray(feats),
        None if lengths is None else jnp.asarray(lengths))
    got = forward_step(pg, torch.from_numpy(feats),
                       None if lengths is None else torch.from_numpy(lengths),
                       compute_dtype=BF16)
    post_gap = max(float(np.abs(np.exp(got[k].numpy())
                                - np.exp(np.asarray(want[k]))).max())
                   for k in want)
    assert post_gap <= 0.05, (case, post_gap)

    loss, _ = train_step(pg, make_all_optimizers(pg.archs, pg.modules),
                         torch.from_numpy(feats), torch.from_numpy(labs),
                         n_valid, None, BF16)
    own = abs(tpk["bf16"][0] - tpk["f32"][0])
    gap = abs(loss.item() - tpk["bf16"][0])
    assert gap <= max(2 * own, 1e-3), (case, gap, own)
    worst = 0.0
    for name, module in pg.modules.items():
        got_grads, _ = port_tree(module, grads=True)
        want32 = dict(_leaves(tpk["f32"][1][name]))
        want16 = dict(_leaves(tpk["bf16"][1][name]))
        for path, g in _leaves(got_grads):
            d_port = _distance(g, want32[path])
            d_tpk = _distance(want16[path], want32[path])
            assert d_port <= 2 * d_tpk, (case, name, path, d_port, d_tpk)
            worst = max(worst, d_port / max(d_tpk, 1e-30))
    print(f"{case}: loss gap {gap:.3e} (tpukaldi's bf16-f32 {own:.3e}), "
          f"gradient distance ratio <= {worst:.3f}, posterior gap "
          f"{post_gap:.3e}")


@pytest.mark.parametrize("case", list(ZOO_CASES))
def test_zoo_classes_end_in_tpukaldis_dtype(case):
    """Each class of the rest of the zoo (tests/test_torch_port_zoo.py's
    cases, at their recurrent dropout: eval mode scales by the bf16-rounded
    1 - p) in eval mode on bf16 parameters and input: the port's output in
    the dtype tpukaldi's ends in (bf16; float32 for the `*_cudnn` family,
    whose float32 initial state promotes it), and no further from
    tpukaldi's float32 output (L2) than 2x tpukaldi's bf16 output is."""
    _, _, x, jmod, params, stats, port = _zoo_setup(case)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 **({"batch_stats": stats} if stats else {})}
    want32 = jmod.apply(variables, jnp.asarray(x), train=False)
    cast, xb = tpk_cast_compute(variables["params"], jnp.asarray(x),
                                jnp.bfloat16)
    want16 = jmod.apply({**variables, "params": cast}, xb, train=False)
    graph = SimpleNamespace(modules={"m": port})
    pcast, xp = _cast_compute(graph, torch.from_numpy(x), BF16)
    with torch.inference_mode():
        got = torch.func.functional_call(port, pcast["m"], (xp,))
    want_dtype = (torch.float32 if want16.dtype == jnp.float32 else BF16)
    assert got.dtype == want_dtype, (case, got.dtype, want16.dtype)
    d_port = _distance(got.float().numpy(), want32)
    d_tpk = _distance(np.asarray(want16.astype(jnp.float32)), want32)
    assert d_port <= 2 * d_tpk, (case, d_port, d_tpk)


def _markers(tree):
    """1.0 where a leaf is bf16, 0.0 where it is float32."""
    return jax.tree_util.tree_map(
        lambda x: np.full(np.shape(x), float(x.dtype == jnp.bfloat16),
                          np.float32), tree)


@pytest.mark.parametrize("case", ["liGRU-kernel", "LSTM-kernel", "GRU-kernel",
                                  "QLSTM-kernel", "MLP", "SincNet"])
def test_cast_set_matches_tpukaldi(case):
    """Which parameters the bf16 mode casts, in tpukaldi's naming through
    `to_jax_params`, is what tpukaldi's `_cast_compute` casts."""
    jg, params, stats, pg, feats, _, _ = _graphs(case)
    want, _ = tpk_cast_compute(jax.tree_util.tree_map(jnp.asarray, params),
                               jnp.asarray(feats), jnp.bfloat16)
    cast, _ = _cast_compute(pg, torch.from_numpy(feats), BF16)
    for name, module in pg.modules.items():
        sd = {k: torch.zeros(v.shape) if v.is_floating_point() else v
              for k, v in module.state_dict().items()}
        sd.update({k: torch.full(p.shape, float(p.dtype == BF16))
                   for k, p in cast[name].items()})
        got, _ = to_jax_params(sd, type(module).__name__)
        assert_trees_close(got, _markers(want[name]), 0.0, name)


# ----------------------------------------- 3. K4 with a bf16 ff, the refusals
def _lean_inputs(T, B, H, seed=0):
    g = torch.Generator().manual_seed(seed)
    ff = (torch.randn(T, B, 4 * H, generator=g) * 0.5).to(BF16)
    u = torch.randn(H, 4 * H, generator=g) / H ** 0.5
    mask = (torch.rand(B, H, generator=g) > 0.2).float()
    grad = torch.randn(T, B, H, generator=g)
    return ff, u, mask, grad


@pytest.mark.parametrize("shape", [(7, 3, 12), (1, 2, 4), (9, 5, 20)])
def test_lean_plain_version_takes_bf16_ff(shape):
    """K4's plain versions on a bf16 ff: h and c bitwise the float32 entry's
    on ff.float(); dff bf16, bitwise the float32 entry's dff rounded to
    nearest even, dmask bitwise its; du = h_prev^T float(dff)."""
    T, B, H = shape
    ff, u, mask, grad = _lean_inputs(T, B, H)
    h, c = lstm.lstm_recurrence_lean(ff, u, mask)
    h32, c32 = lstm.lstm_recurrence_lean(ff.float(), u, mask)
    assert h.dtype == c.dtype == torch.float32
    assert torch.equal(h, h32) and torch.equal(c, c32)
    dff, du, dmask = lstm.lstm_recurrence_lean_bwd(ff, h, c, grad, u, mask)
    dff32, _, dmask32 = lstm.lstm_recurrence_lean_bwd(ff.float(), h, c, grad,
                                                      u, mask)
    assert dff.dtype == BF16 and du.dtype == dmask.dtype == torch.float32
    assert torch.equal(dff, dff32.to(BF16)) and torch.equal(dmask, dmask32)
    want = (h[:-1].reshape(-1, H).double().t()
            @ dff[1:].reshape(-1, 4 * H).double())
    np.testing.assert_allclose(du.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max() + 1))


def test_lean_recurrence_bf16_matches_tpukaldis_kernel():
    """`LSTMLeanRecurrence` on a bf16 ff (the QLSTM's bf16 path) against
    tpukaldi's `lstm_recurrence_lean` in interpret mode on the same bf16
    inputs: h within 1e-5, and the gradients in the primal dtypes, ff's
    within one bf16 rounding of its largest element (a rounding of dA that
    a last-bit difference of the float32 sums can flip), u's and mask's
    within 1e-4 of their largest."""
    T, B, H = 7, 3, 12
    ff, u, mask, grad = _lean_inputs(T, B, H)
    u16 = u.to(BF16)
    j_ff, j_u, j_mask = (jnp.asarray(t.float().numpy()).astype(d) for t, d in (
        (ff, jnp.bfloat16), (u16, jnp.bfloat16), (mask, jnp.float32)))
    j_h, vjp = jax.vjp(lambda a, b, m: jax_lstm.lstm_recurrence_lean(
        a, b, m, True), j_ff, j_u, j_mask)
    j_grads = vjp(jnp.asarray(grad.numpy()))
    leaves = [t.clone().requires_grad_() for t in (ff, u16, mask)]
    h = lstm.LSTMLeanRecurrence.apply(*leaves)
    h.backward(grad)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(j_h), rtol=0,
                               atol=1e-5)
    for t, want in zip(leaves, j_grads):
        assert t.grad.dtype == t.dtype
        want = np.asarray(want.astype(jnp.float32))
        top = float(np.abs(want).max())
        tol = top * 2.0 ** -8 if t.dtype == BF16 and t.dim() == 3 else 1e-4 * top
        np.testing.assert_allclose(t.grad.float().numpy(), want, rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("entry", ["ligru", "lstm", "gru", "conv1d_pool",
                                   "lstm_lean_u"])
def test_float32_entries_refuse_bf16(entry):
    """No fallback: a bf16 tensor given to an entry without a bf16 path
    raises on the CPU too (the Functions and `conv_pool` widen at their
    boundary first); K4's u must come widened."""
    x = torch.zeros(2, 1, 8, dtype=BF16)
    call = {
        "ligru": lambda: ligru.ligru_recurrence(x[..., :8], torch.zeros(4, 8),
                                                torch.ones(1, 4)),
        "lstm": lambda: lstm.lstm_recurrence(torch.zeros(2, 1, 8),
                                             torch.zeros(2, 8, dtype=BF16),
                                             torch.ones(1, 2)),
        "gru": lambda: gru.gru_recurrence(x[..., :6], torch.zeros(2, 4),
                                          torch.zeros(2, 2), torch.ones(1, 2)),
        "conv1d_pool": lambda: conv1d.conv1d_pool(
            torch.zeros(1, 20, dtype=BF16), torch.zeros(3, 2), 2),
        "lstm_lean_u": lambda: lstm.lstm_recurrence_lean(
            x, torch.zeros(2, 8, dtype=BF16), torch.ones(1, 2)),
    }[entry]
    with pytest.raises(TypeError, match="float32"):
        call()


# ------------------------------------------------------ 4. the checkpoints
def test_bf16_checkpoints_keep_float32_masters_both_ways(tmp_path):
    """A bf16 run's final checkpoint holds float32 weights, optimizer state
    and statistics on both sides: tpukaldi's loads into the port bit for
    bit, and the port's into tpukaldi."""
    corpus = generate_corpus(str(tmp_path / "corpus"), n_utts=8, seed=9,
                             noise=0.3)
    finals = {}
    for side, run in (("tpk", tpk_run_experiment),
                      ("port", lambda cfg: run_experiment(cfg,
                                                          device="cpu"))):
        cfg = write_cfg(corpus, str(tmp_path / side), arch="MLP", n_epochs=1,
                        n_chunks=1, batch_size=64, lr=0.2)
        with open(cfg) as f:
            text = f.read().replace("[exp]", "[exp]\ncompute_dtype = bfloat16",
                                    1)
        with open(cfg, "w") as f:
            f.write(text)
        run(cfg)
        (final,) = glob.glob(str(tmp_path / side / "exp_files" / "final_*"))
        finals[side] = (cfg, final)

    # tpukaldi's into the port: every leaf float32, loaded as it is
    cfg, final = finals["tpk"]
    params, opt_state, stats = read_checkpoint(final)
    for tree in (params, opt_state, stats):
        for path, leaf in _leaves(tree):
            if isinstance(leaf, np.ndarray) and leaf.dtype.kind == "f":
                assert leaf.dtype == np.float32, path
    exp = load_config(cfg)
    ds = exp.datasets[exp.train_with[0]]
    chunk = load_chunk(ds, list(ds.features), list(ds.labels), 1000, seed=1)
    graph = compiler.build_graph(exp, chunk.fea_layout, chunk.lab_layout,
                                 "cpu")
    (arch,) = graph.modules
    module = graph.modules[arch]
    load_all({arch: final}, graph.modules,
             make_all_optimizers(graph.archs, graph.modules))
    got, got_stats = port_tree(module)
    assert_trees_close(got, params, 0.0, arch)
    assert_trees_close(got_stats, stats, 0.0, arch)

    # the port's into tpukaldi, against templates of its own init
    _, final = finals["port"]
    params, _, stats = read_checkpoint(final)
    template_p = jax.tree_util.tree_map(np.zeros_like, params)
    template_s = jax.tree_util.tree_map(np.zeros_like, stats)
    got_p, _, got_s = load_checkpoint(final, template_p, None, template_s)
    for want, tree in ((params, got_p), (stats, got_s)):
        got = dict(_leaves(tree))
        assert sorted(got) == sorted(dict(_leaves(want)))
        for path, a in _leaves(want):
            assert np.asarray(got[path]).dtype == np.float32, path
            np.testing.assert_array_equal(np.asarray(got[path]), a,
                                          err_msg=path)
