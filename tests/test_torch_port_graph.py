"""The port's graph compiler (tpukaldi_torch/graph/compiler.py) against
tpukaldi's on one program that uses all ten DSL ops, mixes sequential (3D)
and frame-level (2D) architectures, and masks bucket padding out of the
costs.  Same weights on both sides (tpukaldi's init, batchnorm statistics
drawn from numpy, carried over by `from_jax_params`); inputs from numpy.
Tolerance 1e-5 absolute: float32 on both sides, sums in other orders.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.config.model_dsl import parse_model
from tpukaldi.graph import compiler as jax_compiler
from tpukaldi_torch.compat.jax_params import from_jax_params
from tpukaldi_torch.graph import compiler

PROGRAM = """
out_rnn=compute(rnn,fea1)
out_a=compute(mlp_a,out_rnn)
out_b=compute(mlp_b,fea2)
cat=concatenate(out_a,out_b)
prod=mult(out_a,out_b)
s=sum(prod,out_a)
av=avg(s,out_b)
mc=mult_constant(av,0.5)
sc=sum_constant(mc,1.0)
out_c=compute(mlp_c,cat)
loss_nll=cost_nll(out_c,lab1)
rec=mse(sc,out_b)
loss_final=sum(loss_nll,rec)
err_final=cost_err(out_c,lab1)
"""
FEA = {"fea1": (0, 6), "fea2": (6, 10)}
LAB = {"lab1": 0}
N_CLASSES = 5


def _arch(cls, seq, **opts):
    return SimpleNamespace(class_name=cls, library="tpukaldi.models",
                           seq_model=seq, freeze=False, options=opts)


def _exp(forward_outs):
    mlp = dict(dnn_drop="0.0", dnn_use_batchnorm="False",
               dnn_use_laynorm="False", dnn_use_laynorm_inp="False",
               dnn_use_batchnorm_inp="False")
    return SimpleNamespace(
        model=parse_model(PROGRAM),
        archs={
            "rnn": _arch("liGRU", True, ligru_lay="8", ligru_drop="0.2",
                         ligru_use_batchnorm="True", ligru_use_laynorm="False",
                         ligru_act="relu", ligru_bidir="True",
                         ligru_orthinit="True"),
            "mlp_a": _arch("MLP", False, dnn_lay="7", dnn_act="tanh", **mlp),
            "mlp_b": _arch("MLP", False, dnn_lay="7", dnn_act="sigmoid", **mlp),
            "mlp_c": _arch("MLP", False, dnn_lay=str(N_CLASSES),
                           dnn_act="softmax", **mlp),
        },
        forward=SimpleNamespace(outs=forward_outs),
    )


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(12)
    T, B = 9, 3
    feats = rng.standard_normal((T, B, 10)).astype(np.float32)
    labs = rng.integers(0, N_CLASSES, (T, B, 1))
    exp = _exp(["out_c"])
    jg = jax_compiler.build_graph(exp, FEA, LAB)
    params, stats = jax_compiler.init_graph(jg, jax.random.key(2),
                                            jnp.asarray(feats))
    params = jax.tree_util.tree_map(np.asarray, params)
    stats = jax.tree_util.tree_map(np.asarray, stats)
    bn = stats["rnn"]["bn_ff0"]
    bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    pg = compiler.build_graph(exp, FEA, LAB, "cpu")
    for name, module in pg.modules.items():
        module.load_state_dict(from_jax_params(
            type(module).__name__, params[name], stats[name]))
    return jg, params, stats, pg, feats, labs


@pytest.mark.parametrize("n_valid_t", [None, 6])
def test_all_ops_match_tpukaldi(graphs, n_valid_t):
    jg, params, stats, pg, feats, labs = graphs
    want, _ = jax_compiler.apply_graph(
        jg, params, stats, jnp.asarray(feats), jnp.asarray(labs), train=False,
        to_do="valid",
        n_valid_t=None if n_valid_t is None else jnp.asarray(n_valid_t))
    with torch.inference_mode():
        got = compiler.apply_graph(
            pg, torch.from_numpy(feats), torch.from_numpy(labs), train=False,
            to_do="valid", n_valid_t=n_valid_t)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(want[name]),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_forward_mode_stops_early_like_tpukaldi(graphs):
    """Forward mode computes what `out_c` needs and no cost."""
    jg, params, stats, pg, feats, _ = graphs
    want, _ = jax_compiler.apply_graph(jg, params, stats, jnp.asarray(feats),
                                       None, train=False, to_do="forward")
    with torch.inference_mode():
        got = compiler.apply_graph(pg, torch.from_numpy(feats), None,
                                   train=False, to_do="forward")
    assert set(got) == set(want)
    assert "loss_nll" not in got and "out_c" in got
    np.testing.assert_allclose(got["out_c"].numpy(), np.asarray(want["out_c"]),
                               rtol=0, atol=1e-5)


def test_init_graph_is_seeded():
    a = compiler.build_graph(_exp(["out_c"]), FEA, LAB, "cpu")
    b = compiler.build_graph(_exp(["out_c"]), FEA, LAB, "cpu")
    compiler.init_graph(a, 7)
    compiler.init_graph(b, 7)
    for name in a.modules:
        for (k, va), vb in zip(a.modules[name].state_dict().items(),
                               b.modules[name].state_dict().values()):
            assert torch.equal(va, vb), (name, k)
    compiler.init_graph(b, 8)
    assert not torch.equal(a.modules["rnn"].wh[0].weight,
                           b.modules["rnn"].wh[0].weight)
