"""The port's models (tpukaldi_torch/models) against tpukaldi's flax modules
given the same weights, and the weight converter between the two.

Weights come from the flax init with batchnorm statistics and affine
parameters replaced by numpy draws (so eval-mode batchnorm is not the
identity); they reach the port through `from_jax_params`.  Inputs come from
numpy with a seed.  Tolerance: 1e-5 absolute on outputs of order 1 — both
sides compute in float32, with matmul sums in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.compat.torch_import import import_model_par
from tpukaldi.models.mlp import MLP as JaxMLP
from tpukaldi.models.recurrent import liGRU as JaxLiGRU
from tpukaldi_torch.models import MLP, liGRU, resolve
from torch_port_helpers import assert_trees_equal, jax_init, port_module

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


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("name", list(LIGRU_OPTS))
def test_ligru_matches_flax(name, with_lengths):
    opts = LIGRU_OPTS[name]
    rng = np.random.default_rng(3)
    T, B = 11, 3
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    lengths = np.array([11, 7, 4], np.int64) if with_lengths else None
    jmod, params, stats = jax_init(JaxLiGRU, opts, x, seed=5)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    want = np.asarray(jmod.apply(
        variables, jnp.asarray(x), train=False,
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32)))
    port = port_module(liGRU, opts, D, params, stats, "liGRU")
    with torch.inference_mode():
        got = port(torch.from_numpy(x),
                   lengths=None if lengths is None else torch.from_numpy(lengths))
    assert got.shape == want.shape == (T, B, port.out_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(MLP_OPTS))
def test_mlp_matches_flax(name):
    opts = MLP_OPTS[name]
    x = np.random.default_rng(4).standard_normal((29, D)).astype(np.float32)
    jmod, params, stats = jax_init(JaxMLP, opts, x, seed=7)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    port = port_module(MLP, opts, D, params, stats, "MLP")
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cls_name,name", [
    *(("liGRU", n) for n in LIGRU_OPTS), *(("MLP", n) for n in MLP_OPTS)])
def test_converter_round_trip(cls_name, name):
    """JAX params -> port state_dict -> import_model_par == JAX params."""
    jcls, pcls, opts = {
        "liGRU": (JaxLiGRU, liGRU, LIGRU_OPTS.get(name)),
        "MLP": (JaxMLP, MLP, MLP_OPTS.get(name)),
    }[cls_name]
    x = np.zeros((4, 2, D) if cls_name == "liGRU" else (4, D), np.float32)
    _, params, stats = jax_init(jcls, opts, x, seed=11)
    port = port_module(pcls, opts, D, params, stats, cls_name)  # strict load
    back_params, back_stats = import_model_par(port.state_dict(), cls_name)
    assert_trees_equal(back_params, params)
    assert_trees_equal(back_stats, stats)


def test_registry_resolves_cfg_libraries():
    for lib in ("tpukaldi.models", "tpukaldi_torch.models", "neural_networks"):
        assert resolve("liGRU", lib) is liGRU
        assert resolve("MLP", lib) is MLP
    with pytest.raises(NotImplementedError, match="RNN.*still to be ported"):
        resolve("RNN")
    with pytest.raises(KeyError):
        resolve("liGRU", "my_library")


def test_ligru_impl_pallas_refuses_cpu():
    opts = dict(LIGRU_OPTS["flagship"], ligru_impl="pallas")
    module = liGRU(opts, D).eval()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        with torch.inference_mode():
            module(torch.zeros(3, 2, D))
