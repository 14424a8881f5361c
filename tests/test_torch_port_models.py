"""The port's models (tpukaldi_torch/models) against tpukaldi's flax modules
given the same weights, and the weight converter between the two.

Weights come from the flax init with batchnorm statistics and affine
parameters replaced by numpy draws (so eval-mode batchnorm is not the
identity); they reach the port through `from_jax_params`.  Inputs come from
numpy with a seed.  Tolerance: 1e-5 absolute on outputs of order 1 — both
sides compute in float32, with matmul sums in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.compat.torch_import import import_model_par
from tpukaldi.models.mlp import MLP as JaxMLP
from tpukaldi.models.recurrent import liGRU as JaxLiGRU
from tpukaldi_torch.compat.jax_params import from_jax_params
from tpukaldi_torch.models import MLP, liGRU, resolve

ATOL = 1e-5

LIGRU_OPTS = {
    # the flagship layer kind: batchnorm, relu, recurrent dropout 0.2
    "flagship": dict(
        ligru_lay="16,16", ligru_drop="0.2,0.2",
        ligru_use_batchnorm="True,True", ligru_use_laynorm="False,False",
        ligru_act="relu,relu", ligru_bidir="True", ligru_orthinit="True",
        ligru_use_laynorm_inp="False", ligru_use_batchnorm_inp="False",
    ),
    # the plain-loop path: biases, laynorm on h, tanh, input ln/bn
    "laynorm_tanh": dict(
        ligru_lay="16,12", ligru_drop="0.1,0.0",
        ligru_use_batchnorm="False,False", ligru_use_laynorm="True,False",
        ligru_act="tanh,relu", ligru_bidir="True", ligru_orthinit="False",
        ligru_use_laynorm_inp="True", ligru_use_batchnorm_inp="True",
    ),
}
MLP_OPTS = {
    # the flagship softmax head
    "softmax_head": dict(
        dnn_lay="9", dnn_drop="0.0", dnn_use_batchnorm="False",
        dnn_use_laynorm="False", dnn_act="softmax",
        dnn_use_laynorm_inp="False", dnn_use_batchnorm_inp="False",
    ),
    "bn_ln_stack": dict(
        dnn_lay="24,20,9", dnn_drop="0.1,0.1,0.0",
        dnn_use_batchnorm="True,False,False", dnn_use_laynorm="False,True,False",
        dnn_act="relu,leaky_relu,softmax",
        dnn_use_laynorm_inp="True", dnn_use_batchnorm_inp="True",
    ),
}
D = 10


def _randomize_norms(tree, rng, positive=False):
    """Replace every batchnorm/laynorm leaf with a numpy draw."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_norms(v, rng, positive or k == "var")
        elif positive:
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.normal(0.0, 0.3, np.shape(v)).astype(np.float32) + (
                1.0 if k in ("scale", "gamma") or k.endswith("_gamma") else 0.0)
    return out


def _jax_init(cls, opts, x, seed):
    module = cls(options=opts, inp_dim=D)
    variables = module.init({"params": jax.random.key(seed),
                             "dropout": jax.random.key(seed + 1)},
                            jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    stats = jax.tree_util.tree_map(
        np.asarray, dict(variables.get("batch_stats", {})))
    rng = np.random.default_rng(seed)
    norm_keys = [k for k in params if k.startswith(("bn", "ln"))]
    params.update(_randomize_norms({k: params[k] for k in norm_keys}, rng))
    stats = {k: _randomize_norms({"mean": s["mean"]}, rng) | {
        "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
        for k, s in stats.items()}
    return module, params, stats


def _port(cls, opts, params, stats, class_name):
    module = cls(opts, D)
    module.load_state_dict(from_jax_params(class_name, params, stats))
    return module.eval()


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("name", list(LIGRU_OPTS))
def test_ligru_matches_flax(name, with_lengths):
    opts = LIGRU_OPTS[name]
    rng = np.random.default_rng(3)
    T, B = 11, 3
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    lengths = np.array([11, 7, 4], np.int64) if with_lengths else None
    jmod, params, stats = _jax_init(JaxLiGRU, opts, x, seed=5)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    want = np.asarray(jmod.apply(
        variables, jnp.asarray(x), train=False,
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32)))
    port = _port(liGRU, opts, params, stats, "liGRU")
    with torch.inference_mode():
        got = port(torch.from_numpy(x),
                   lengths=None if lengths is None else torch.from_numpy(lengths))
    assert got.shape == want.shape == (T, B, port.out_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(MLP_OPTS))
def test_mlp_matches_flax(name):
    opts = MLP_OPTS[name]
    x = np.random.default_rng(4).standard_normal((29, D)).astype(np.float32)
    jmod, params, stats = _jax_init(JaxMLP, opts, x, seed=7)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    port = _port(MLP, opts, params, stats, "MLP")
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, f"{path}/{k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}/{k}")


@pytest.mark.parametrize("cls_name,name", [
    *(("liGRU", n) for n in LIGRU_OPTS), *(("MLP", n) for n in MLP_OPTS)])
def test_converter_round_trip(cls_name, name):
    """JAX params -> port state_dict -> import_model_par == JAX params."""
    jcls, pcls, opts = {
        "liGRU": (JaxLiGRU, liGRU, LIGRU_OPTS.get(name)),
        "MLP": (JaxMLP, MLP, MLP_OPTS.get(name)),
    }[cls_name]
    x = np.zeros((4, 2, D) if cls_name == "liGRU" else (4, D), np.float32)
    _, params, stats = _jax_init(jcls, opts, x, seed=11)
    port = _port(pcls, opts, params, stats, cls_name)  # strict load
    back_params, back_stats = import_model_par(port.state_dict(), cls_name)
    _assert_trees_equal(back_params, params)
    _assert_trees_equal(back_stats, stats)


def test_registry_resolves_cfg_libraries():
    for lib in ("tpukaldi.models", "tpukaldi_torch.models", "neural_networks"):
        assert resolve("liGRU", lib) is liGRU
        assert resolve("MLP", lib) is MLP
    with pytest.raises(NotImplementedError, match="LSTM.*still to be ported"):
        resolve("LSTM")
    with pytest.raises(KeyError):
        resolve("liGRU", "my_library")


def test_ligru_impl_pallas_refuses_cpu():
    opts = dict(LIGRU_OPTS["flagship"], ligru_impl="pallas")
    module = liGRU(opts, D).eval()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        with torch.inference_mode():
            module(torch.zeros(3, 2, D))
