"""The rest of the shipped zoo in the port (tpukaldi_torch/models: RNN and
minimalGRU in recurrent.py, cudnn_like.py, sru.py, fusion.py) against
tpukaldi's flax modules given the same weights, and their weight maps and
checkpoints.

Each class runs at 2 layers of width 8-24: bidirectional and, where the
class allows it, unidirectional, and `RNN_cudnn` in tanh and in relu.
Weights come from tpukaldi's flax init with batchnorm and laynorm
parameters and statistics replaced by numpy draws; they reach the port
through `from_jax_params`.  Inputs come from numpy with a seed.  Tolerance:
1e-5 absolute, as in tests/test_torch_port_models.py: float32 on both
sides, sums in other orders.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpukaldi.compat.torch_import import import_model_par
from tpukaldi.io import read_mat_ark
from tpukaldi.models import cudnn_like as jax_cudnn
from tpukaldi.models import fusion as jax_fusion
from tpukaldi.models import recurrent as jax_recurrent
from tpukaldi.models import sru as jax_sru
from tpukaldi.train.checkpoint import save_checkpoint
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi.train.optimizers import make_optimizer
from tpukaldi_torch.compat.jax_params import (
    moments_from_jax,
    moments_to_jax,
    to_jax_params,
)
from tpukaldi_torch.kernels import ligru
from tpukaldi_torch.models import fusion, resolve
from tpukaldi_torch.tools.flagship_tree import (
    recipe_cfg,
    save_seeded_init,
    write_kaldi_tree,
    write_train_cfg,
)
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train.checkpoint import load_all
from tpukaldi_torch.train.optimizers import ArchOptimizer
from torch_port_helpers import (
    assert_trees_close,
    assert_trees_equal,
    jax_init,
    port_module,
    port_tree,
)

ATOL = 1e-5
D = 12  # input width: 3 mics of 4 for the fusion layer

_RNN = dict(rnn_lay="16,12", rnn_drop="0.2,0.2", rnn_use_batchnorm="True,True",
            rnn_use_laynorm="False,False", rnn_act="tanh,tanh",
            rnn_bidir="True", rnn_orthinit="True",
            rnn_use_laynorm_inp="False", rnn_use_batchnorm_inp="False")
_MGRU = dict(minimalgru_lay="16,12", minimalgru_drop="0.2,0.2",
             minimalgru_use_batchnorm="True,True",
             minimalgru_use_laynorm="False,False", minimalgru_act="tanh,tanh",
             minimalgru_bidir="True", minimalgru_orthinit="True",
             minimalgru_use_laynorm_inp="False",
             minimalgru_use_batchnorm_inp="False")
_CUDNN = dict(hidden_size="10", num_layers="2", bias="True", batch_first="True",
              dropout="0.2", bidirectional="True")
_SRU = dict(sru_hidden_size="10", sru_num_layers="2", sru_dropout="0.1",
            sru_rnn_dropout="0.1", sru_use_tanh="False", sru_use_relu="False",
            sru_use_selu="False", sru_layer_norm="False",
            sru_bidirectional="True", sru_has_skip_term="True",
            sru_rescale="True", sru_highway_bias="-1")
_FUSION = dict(fusionrnn_lay="16,12", fusionrnn_drop="0.2,0.2",
               fusionrnn_bidir="True", fusionrnn_act="prelu,prelu",
               fusionrnn_do_fusion="True", fusionrnn_fusion_layer_size="24",
               fusionrnn_number_of_mic="3", fusionrnn_fusion_act="prelu",
               fusionrnn_fusion_reduce="sum")

# case -> (class name, tpukaldi class, options)
CASES = {
    # the shipped recipe's layer kind: batchnorm, tanh, recurrent dropout
    "RNN": ("RNN", jax_recurrent.RNN, _RNN),
    # the plain loop's other options: biases, laynorm on h, relu, input ln/bn
    "RNN_unidir_laynorm": ("RNN", jax_recurrent.RNN, dict(
        _RNN, rnn_use_batchnorm="False,False", rnn_use_laynorm="True,False",
        rnn_act="relu,leaky_relu", rnn_bidir="False", rnn_orthinit="False",
        rnn_use_laynorm_inp="True", rnn_use_batchnorm_inp="True")),
    "minimalGRU": ("minimalGRU", jax_recurrent.minimalGRU, _MGRU),
    "minimalGRU_unidir_laynorm": ("minimalGRU", jax_recurrent.minimalGRU, dict(
        _MGRU, minimalgru_use_batchnorm="False,True",
        minimalgru_use_laynorm="True,False", minimalgru_act="relu,tanh",
        minimalgru_bidir="False", minimalgru_orthinit="False")),
    "LSTM_cudnn": ("LSTM_cudnn", jax_cudnn.LSTM_cudnn, _CUDNN),
    "LSTM_cudnn_unidir": ("LSTM_cudnn", jax_cudnn.LSTM_cudnn, dict(
        _CUDNN, bidirectional="False", batch_first="False")),
    "GRU_cudnn": ("GRU_cudnn", jax_cudnn.GRU_cudnn, _CUDNN),
    "GRU_cudnn_unidir_nobias": ("GRU_cudnn", jax_cudnn.GRU_cudnn, dict(
        _CUDNN, bidirectional="False", bias="False")),
    "RNN_cudnn_tanh": ("RNN_cudnn", jax_cudnn.RNN_cudnn,
                       dict(_CUDNN, nonlinearity="tanh")),
    "RNN_cudnn_relu": ("RNN_cudnn", jax_cudnn.RNN_cudnn,
                       dict(_CUDNN, nonlinearity="relu")),
    "RNN_cudnn_relu_unidir": ("RNN_cudnn", jax_cudnn.RNN_cudnn, dict(
        _CUDNN, nonlinearity="relu", bidirectional="False")),
    # the shipped recipe's: g the identity, the skip projected (D != H)
    "SRU": ("SRU", jax_sru.SRU, _SRU),
    # tanh, layer norm, no rescale, and a skip of the raw input (D == H)
    "SRU_unidir_tanh_ln": ("SRU", jax_sru.SRU, dict(
        _SRU, sru_hidden_size=str(D), sru_use_tanh="True",
        sru_layer_norm="True", sru_bidirectional="False",
        sru_rescale="False", sru_highway_bias="0.5")),
    "SRU_relu_noskip": ("SRU", jax_sru.SRU, dict(
        _SRU, sru_use_relu="True", sru_has_skip_term="False")),
    # always bidirectional; the fusion layer, then a Linear layer
    "fusionRNN": ("fusionRNN_jit", jax_fusion.fusionRNN_jit, _FUSION),
    "fusionRNN_mean_leaky": ("fusionRNN", jax_fusion.fusionRNN, dict(
        _FUSION, fusionrnn_fusion_act="leaky_relu",
        fusionrnn_fusion_reduce="mean")),
    "fusionRNN_no_fusion": ("fusionRNN", jax_fusion.fusionRNN, dict(
        _FUSION, fusionrnn_do_fusion="False")),
}


def _no_drop(opts):
    """The options with every dropout rate 0."""
    return {k: ",".join("0.0" for _ in v.split(",")) if "drop" in k else v
            for k, v in opts.items()}


def _variables(params, stats):
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def _setup(case, seed=5, drop=True):
    class_name, jcls, opts = CASES[case]
    if not drop:
        opts = _no_drop(opts)
    x = np.random.default_rng(seed).standard_normal((11, 3, D)).astype(
        np.float32)
    jmod, params, stats = jax_init(jcls, opts, x, seed=seed)
    port = port_module(resolve(class_name), opts, D, params, stats, class_name)
    return class_name, opts, x, jmod, params, stats, port


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_tpukaldi(case, with_lengths):
    """Eval forward, with bucket-padded lengths or without.  With lengths
    the valid frames agree."""
    class_name, opts, x, jmod, params, stats, port = _setup(case)
    lengths = np.array([11, 7, 4], np.int64) if with_lengths else None
    want = np.asarray(jmod.apply(
        _variables(params, stats), jnp.asarray(x), train=False,
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), lengths=None if lengths is None
                   else torch.from_numpy(lengths)).numpy()
    assert got.shape == want.shape == (11, 3, port.out_dim)
    if lengths is not None:
        valid = np.arange(11)[:, None] < lengths[None, :]
        got, want = got[valid], want[valid]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_tpukaldi_with_a_zero_length_row(case):
    """Eval forward of a batch padded as the forward batches are
    (`data/batching.py`): lengths [11, 7, 0], the padding frames zeros.
    The valid frames agree with tpukaldi's to ATOL, and every frame of the
    output, padding included, is finite."""
    class_name, opts, x, jmod, params, stats, port = _setup(case)
    lengths = np.array([11, 7, 0], np.int64)
    valid = np.arange(11)[:, None] < lengths[None, :]
    x[~valid] = 0.0
    want = np.asarray(jmod.apply(
        _variables(params, stats), jnp.asarray(x), train=False,
        lengths=jnp.asarray(lengths, jnp.int32)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), lengths=torch.from_numpy(lengths))
    got = got.numpy()
    assert got.shape == want.shape == (11, 3, port.out_dim)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_train_gradients_match_tpukaldi(case):
    """Train mode at drop 0: every gradient of sum(out * w) and the updated
    batchnorm statistics."""
    class_name, opts, x, jmod, params, stats, port = _setup(case, drop=False)
    # weights of a mean, as the costs take one: gradients of order 1
    w = (np.random.default_rng(8).standard_normal((11, 3, port.out_dim))
         / 33).astype(np.float32)

    def loss_fn(p):
        out, upd = jmod.apply(_variables(p, stats), jnp.asarray(x), train=True,
                              mutable=["batch_stats"],
                              rngs={"dropout": jax.random.key(0)})
        return (out * w).sum(), upd

    (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    port.train()
    got = (port(torch.from_numpy(x)) * torch.from_numpy(w)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=0, atol=ATOL)
    got_grads, _ = port_tree(port, grads=True)
    assert_trees_close(got_grads, jax.tree_util.tree_map(np.asarray, grads),
                       ATOL)
    _, got_stats = port_tree(port)
    assert_trees_close(got_stats, jax.tree_util.tree_map(
        np.asarray, dict(upd.get("batch_stats", {}))), ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_weight_maps_round_trip_bit_exact(case):
    """tpukaldi's tree -> from_jax_params -> the port (strict load) ->
    to_jax_params == the tree, to the bit; the moment maps likewise."""
    class_name, opts, x, jmod, params, stats, port = _setup(case)
    back_params, back_stats = to_jax_params(port.state_dict(), class_name)
    assert_trees_equal(back_params, params)
    assert_trees_equal(back_stats, stats)
    moments = moments_from_jax(port, params)
    assert set(moments) == {n for n, _ in port.named_parameters()}
    assert_trees_equal(moments_to_jax(port, moments), params)


@pytest.mark.parametrize("case", ["RNN", "RNN_unidir_laynorm", "minimalGRU",
                                  "minimalGRU_unidir_laynorm"])
def test_import_model_par_loads_port_weights(case):
    """tpukaldi's own converter loads the port's RNN and minimalGRU
    state_dicts unchanged."""
    class_name, opts, x, jmod, params, stats, port = _setup(case)
    got_params, got_stats = import_model_par(port.state_dict(), class_name)
    assert_trees_equal(got_params, params)
    assert_trees_equal(got_stats, stats)


def _rmsprop(name):
    from types import SimpleNamespace

    return SimpleNamespace(name=name, lr=[0.01], options={},
                           optimizer=SimpleNamespace(kind="rmsprop", options={
                               "opt_alpha": 0.95, "opt_eps": 1e-8}))


@pytest.mark.parametrize("case", ["RNN", "minimalGRU", "LSTM_cudnn",
                                  "GRU_cudnn", "RNN_cudnn_relu", "SRU",
                                  "fusionRNN"])
def test_tpukaldi_checkpoint_restores_and_steps(case, tmp_path):
    """A msgpack checkpoint tpukaldi wrote after one rmsprop step (weights,
    batch statistics, optimizer state) restores into a freshly initialised
    port module, and the next step equals tpukaldi's."""
    class_name, opts, x, jmod, params, stats, _ = _setup(case)
    arch = _rmsprop(class_name)
    tx = make_optimizer(arch)
    rng = np.random.default_rng(12)

    def grads_like():
        return jax.tree_util.tree_map(
            lambda p: rng.standard_normal(np.shape(p)).astype(np.float32),
            params)

    state = tx.init(params)
    updates, state = tx.update(grads_like(), state, params)
    params = jax.tree_util.tree_map(np.asarray,
                                    optax.apply_updates(params, updates))
    path = str(tmp_path / "tpk.ckpt")
    save_checkpoint(path, params, state, stats)

    port = resolve(class_name)(opts, D)
    port.reset_parameters(torch.Generator().manual_seed(1))
    opt = ArchOptimizer(arch, port)
    load_all({class_name: path}, {class_name: port}, {class_name: opt})
    assert opt.count == 1
    got_params, got_stats = to_jax_params(port.state_dict(), class_name)
    assert_trees_equal(got_params, params)
    assert_trees_equal(got_stats, stats)

    grads = grads_like()
    for name, g in moments_from_jax(port, grads).items():
        port.get_parameter(name).grad = g.clone()
    opt.step()
    updates, _ = tx.update(grads, state, params)
    want = jax.tree_util.tree_map(np.asarray,
                                  optax.apply_updates(params, updates))
    assert_trees_close(to_jax_params(port.state_dict(), class_name)[0], want,
                       ATOL)


def test_fusion_cpu_path_runs_the_ligru_plain_version(monkeypatch):
    """On the CPU, fusionRNN's recurrence is K1's plain version on the gates
    reordered to (wh, wz) and u to [uh | uz], one call a layer, never K1's
    autograd Function and no kernel launch: at eval without a gradient
    through the `tpukaldi::fusion_recurrence` op (K1's wrapper, whose CPU
    branch is the plain version), in train mode with one through the plain
    loop itself.  Both agree with tpukaldi's scan (train mode with batch
    statistics)."""
    calls = []

    def ref(ff, u, mask, *rest):
        calls.append((tuple(ff.shape), tuple(u.shape)))
        return ligru_ref(ff, u, mask, *rest)

    def kernel(*args):
        raise AssertionError("K1's Function called on a CPU tensor")

    ligru_ref = ligru.ligru_recurrence_ref
    monkeypatch.setattr(fusion, "ligru_recurrence_ref", ref)
    monkeypatch.setattr(ligru, "ligru_recurrence_ref", ref)
    monkeypatch.setattr(fusion.LiGRURecurrence, "apply", kernel)
    class_name, opts, x, jmod, params, stats, port = _setup("fusionRNN",
                                                            drop=False)
    launches = ligru.launches
    for train in (False, True):
        calls.clear()
        port.train(train)
        with torch.set_grad_enabled(train):
            got = port(torch.from_numpy(x)).detach().numpy()
        want, _ = jmod.apply(_variables(params, stats), jnp.asarray(x),
                             train=train, mutable=["batch_stats"])
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
        # layer 0 is the fusion layer, 24 // 3 = 8 wide; layer 1 is 12
        assert calls == [((11, 6, 16), (8, 16)), ((11, 6, 24), (12, 24))]
    assert ligru.launches == launches


def _init_stats(x):
    x = np.asarray(x, np.float64)
    return float(np.abs(x).max()), float(x.std())


def _assert_same_init(got, want, path=""):
    """Leaf by leaf: the same constant where tpukaldi's init is constant
    (zeros, ones, the highway bias), else the same spread and range (within
    25%: the draws are independent), and orthonormal rows or columns where
    tpukaldi's are."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same_init(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, path
    if np.all(w == w.flat[0]):
        np.testing.assert_array_equal(g, w, err_msg=path)
        return
    (g_max, g_std), (w_max, w_std) = _init_stats(g), _init_stats(w)
    assert 0.8 < g_std / w_std < 1.25 and 0.8 < g_max / w_max < 1.25, (
        path, g_std, w_std, g_max, w_max)
    if g.ndim < 2:
        return
    for a, b in ((g, w), (np.swapaxes(g, -1, -2), np.swapaxes(w, -1, -2))):
        if a.shape[-2] <= a.shape[-1]:
            eye = np.eye(a.shape[-2])
            if np.allclose(b @ np.swapaxes(b, -1, -2), eye, atol=1e-4):
                np.testing.assert_allclose(a @ np.swapaxes(a, -1, -2),
                                           np.broadcast_to(eye, a.shape[:-2]
                                                           + eye.shape),
                                           atol=1e-4, err_msg=path)


# wide enough for a spread to be measured: 2 layers of 64 over 48 inputs
INIT_CASES = {
    "RNN": ("RNN", jax_recurrent.RNN, dict(_RNN, rnn_lay="64,64")),
    "RNN_uniform_rec": ("RNN", jax_recurrent.RNN, dict(
        _RNN, rnn_lay="64,64", rnn_orthinit="False",
        rnn_use_batchnorm="False,False")),
    "minimalGRU": ("minimalGRU", jax_recurrent.minimalGRU,
                   dict(_MGRU, minimalgru_lay="64,64")),
    "LSTM_cudnn": ("LSTM_cudnn", jax_cudnn.LSTM_cudnn,
                   dict(_CUDNN, hidden_size="64")),
    "GRU_cudnn_uniform_rec": ("GRU_cudnn", jax_cudnn.GRU_cudnn, dict(
        _CUDNN, hidden_size="64", batch_first="False")),
    "RNN_cudnn": ("RNN_cudnn", jax_cudnn.RNN_cudnn,
                  dict(_CUDNN, hidden_size="64", nonlinearity="relu")),
    "SRU": ("SRU", jax_sru.SRU, dict(_SRU, sru_hidden_size="64",
                                     sru_layer_norm="True")),
    "fusionRNN": ("fusionRNN_jit", jax_fusion.fusionRNN_jit, dict(
        _FUSION, fusionrnn_lay="64,64", fusionrnn_fusion_layer_size="192")),
}


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_reset_parameters_draws_tpukaldi_init(case):
    """The port's `reset_parameters(generator)` draws from tpukaldi's init
    distributions: U(+-1/sqrt(fan)) weights and biases, orthogonal
    recurrent weights where tpukaldi's are, xavier-normal fusion weights,
    zeros and the highway bias where tpukaldi sets them."""
    class_name, jcls, opts = INIT_CASES[case]
    x = np.zeros((4, 2, 48), np.float32)
    variables = jcls(options=opts, inp_dim=48).init(
        {"params": jax.random.key(2), "dropout": jax.random.key(3)},
        jnp.asarray(x), train=False)
    want = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    port = resolve(class_name)(opts, 48)
    port.reset_parameters(torch.Generator().manual_seed(2))
    got, _ = to_jax_params(port.state_dict(), class_name)
    _assert_same_init(got, want)


# cfg/TIMIT/LSTM_fmllr_cudnn.cfg at 2 layers of 16, drop 0, one epoch of one
# chunk; its test split of 5 utterances leaves every forward batch (8 rows)
# partial, padded with rows of length 0
CUDNN_RUN_SPLITS = {"train": (16, 40, 80), "dev": (4, 40, 60),
                    "test": (5, 30, 90)}
CUDNN_RUN_CUTS = {"hidden_size = 550": "hidden_size = 16",
                  "num_layers = 4": "num_layers = 2",
                  "dropout = 0.2": "dropout = 0.0",
                  "n_epochs_tr = 24": "n_epochs_tr = 1",
                  "n_chunks = 5": "n_chunks = 1",
                  "increase_seq_length_train = True":
                  "increase_seq_length_train = False"}
# the arks (log-posteriors minus log-priors, up to 0.21 here) after two
# rmsprop steps from the same weights: the two packages part by 4.8e-7 at
# most on the CPU (float32 sums in other orders); held 20x wider
CUDNN_RUN_ATOL = 1e-5


def test_cudnn_recipe_run_with_partial_forward_batches_matches_tpukaldi(
        tmp_path):
    """The bidirectional LSTM_cudnn recipe, shrunk, through tpukaldi's
    `run_experiment` and the port's (CPU) from the same seeded weights:
    res.res written by both, and the port's forward arks equal to
    tpukaldi's on every written frame within CUDNN_RUN_ATOL."""
    tree = write_kaldi_tree(str(tmp_path / "timit"), 10, n_phones=3,
                            n_pdfs=9, splits=CUDNN_RUN_SPLITS)
    outs, init = {}, None
    for side in ("tpk", "port"):
        out = str(tmp_path / side)
        os.makedirs(out)
        cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                              CUDNN_RUN_CUTS, recipe=recipe_cfg("LSTM_cudnn"))
        if init is None:
            init = save_seeded_init(cfg, 10, str(tmp_path / "init"))
        outs[side] = (out, cfg)
    tpk_run_experiment(outs["tpk"][1], overrides=init)
    run_experiment(outs["port"][1], overrides=init, device="cpu")
    arks = {}
    for side, (out, _) in outs.items():
        assert os.path.getsize(os.path.join(out, "res.res")) > 0, side
        ef = os.path.join(out, "exp_files")
        (name,) = [f for f in os.listdir(ef) if f.endswith("_to_decode.ark")]
        arks[side] = dict(read_mat_ark(os.path.join(ef, name)))
    assert sorted(arks["port"]) == sorted(arks["tpk"])
    assert len(arks["tpk"]) == CUDNN_RUN_SPLITS["test"][0]
    for key, want in arks["tpk"].items():
        got = arks["port"][key]
        assert got.shape == want.shape == (want.shape[0], 9), key
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(got, want, rtol=0, atol=CUDNN_RUN_ATOL,
                                   err_msg=key)
