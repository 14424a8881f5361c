"""Helpers shared by the port's parity tests (tests/test_torch_port_*.py):
tpukaldi's flax init with drawn norm statistics, the port module loaded from
it, tree comparisons in tpukaldi's naming, and one train and eval step of a
two-head recipe graph on both sides.

Not a test module (pytest collects test_*.py only); the test files import
it from their own directory.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpukaldi.config.model_dsl import parse_model
from tpukaldi.graph import compiler as jax_compiler
from tpukaldi.train.optimizers import make_optimizer
from tpukaldi.train.step import _loss_fn, make_eval_step, make_train_step
from tpukaldi_torch.compat.jax_params import from_jax_params, to_jax_params
from tpukaldi_torch.graph import compiler
from tpukaldi_torch.train.optimizers import make_all_optimizers
from tpukaldi_torch.train.step import eval_step, train_step


def randomize_norms(tree, rng, positive=False):
    """Replace every batchnorm/laynorm leaf with a numpy draw."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize_norms(v, rng, positive or k == "var")
        elif positive:
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.normal(0.0, 0.3, np.shape(v)).astype(np.float32) + (
                1.0 if k in ("scale", "gamma") or k.endswith("_gamma") else 0.0)
    return out


def jax_init(cls, opts, x, seed):
    """The flax module of `cls` over x's last axis, its init with batchnorm
    and laynorm parameters and statistics replaced by numpy draws (so
    eval-mode batchnorm is not the identity): (module, params, stats)."""
    module = cls(options=opts, inp_dim=x.shape[-1])
    variables = module.init({"params": jax.random.key(seed),
                             "dropout": jax.random.key(seed + 1)},
                            jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    stats = jax.tree_util.tree_map(
        np.asarray, dict(variables.get("batch_stats", {})))
    rng = np.random.default_rng(seed)
    norm_keys = [k for k in params if k.startswith(("bn", "ln"))]
    params.update(randomize_norms({k: params[k] for k in norm_keys}, rng))
    stats = {k: randomize_norms({"mean": s["mean"]}, rng) | {
        "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
        for k, s in stats.items()}
    return module, params, stats


def port_module(cls, opts, inp_dim, params, stats, class_name):
    """The port's module with tpukaldi's weights (strict load), eval mode."""
    module = cls(opts, inp_dim)
    module.load_state_dict(from_jax_params(class_name, params, stats))
    return module.eval()


def assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, f"{path}/{k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}/{k}")


def assert_trees_close(got, want, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_close(got[k], want[k], atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=path)


def port_tree(module, grads=False):
    """The module's parameters (or their .grad) in tpukaldi's naming."""
    sd = dict(module.state_dict())
    if grads:
        sd.update({n: p.grad for n, p in module.named_parameters()})
    return to_jax_params(sd, type(module).__name__)


# the TIMIT recipes' program: a recurrent stack and two softmax heads
PROGRAM = """
out_dnn1=compute({cell}_layers,fmllr)
out_dnn2=compute(MLP_layers,out_dnn1)
out_dnn3=compute(MLP_layers2,out_dnn1)
loss_mono=cost_nll(out_dnn3,lab_mono)
loss_mono_w=mult_constant(loss_mono,1.0)
loss_cd=cost_nll(out_dnn2,lab_cd)
loss_final=sum(loss_cd,loss_mono_w)
err_final=cost_err(out_dnn2,lab_cd)
"""
FEA = {"fmllr": (0, 6)}
LAB = {"lab_cd": 0, "lab_mono": 1}
N_CD, N_MONO = 9, 3


def recipe_exp(cell: str, act: str, freeze_mono: bool = False):
    """The recipe program over a 2x8 bidirectional `cell` (batchnorm, `act`,
    drop 0) and two softmax heads, rmsprop as the cfgs have it; the mono
    head frozen or not."""
    rms = SimpleNamespace(kind="rmsprop", options={
        "opt_alpha": 0.95, "opt_eps": 1e-8, "opt_momentum": 0.0,
        "opt_centered": False, "opt_weight_decay": 0.0})
    mlp = dict(dnn_drop="0.0", dnn_use_batchnorm="False",
               dnn_use_laynorm="False", dnn_use_laynorm_inp="False",
               dnn_use_batchnorm_inp="False", dnn_act="softmax")
    p = cell.lower()
    cell_opts = {f"{p}_lay": "8,8", f"{p}_drop": "0.0,0.0",
                 f"{p}_use_batchnorm": "True,True",
                 f"{p}_use_laynorm": "False,False", f"{p}_act": f"{act},{act}",
                 f"{p}_bidir": "True", f"{p}_orthinit": "True"}

    def arch(name, cls, seq, freeze=False, **opts):
        return SimpleNamespace(name=name, class_name=cls,
                               library="tpukaldi.models", seq_model=seq,
                               freeze=freeze, options=opts, optimizer=rms,
                               lr=[4e-4])

    return SimpleNamespace(
        model=parse_model(PROGRAM.format(cell=cell)),
        archs={
            f"{cell}_layers": arch(f"{cell}_layers", cell, True, **cell_opts),
            "MLP_layers": arch("MLP_layers", "MLP", False, dnn_lay=str(N_CD),
                               **mlp),
            "MLP_layers2": arch("MLP_layers2", "MLP", False, freeze_mono,
                                dnn_lay=str(N_MONO), **mlp),
        },
        forward=SimpleNamespace(outs=["out_dnn2"]),
    )


def check_train_and_eval_step(exp):
    """Loss, err, every gradient, the batch statistics and the stepped
    weights of one train step, then loss and err of one eval step, of the
    port against tpukaldi at drop 0 from the same weights, on a
    bucket-padded batch (n_valid_t < T).  A frozen head runs in eval mode
    and is not stepped.  1e-5 absolute: float32 on both sides, sums in other
    orders; the stepped weights move by at most lr * 4.5 per element on
    rmsprop's first step, whose g / sqrt(0.05 g^2) amplifies nothing but
    the gradient's sign."""
    rng = np.random.default_rng(11)
    T, B, n_valid = 12, 3, 9
    feats = rng.standard_normal((T, B, 6)).astype(np.float32)
    labs = np.stack([rng.integers(0, N_CD, (T, B)),
                     rng.integers(0, N_MONO, (T, B))], axis=-1)
    jg = jax_compiler.build_graph(exp, FEA, LAB)
    params, stats = jax_compiler.init_graph(jg, jax.random.key(3),
                                            jnp.asarray(feats))
    params = jax.tree_util.tree_map(np.asarray, params)
    stats = jax.tree_util.tree_map(np.asarray, stats)
    pg = compiler.build_graph(exp, FEA, LAB, "cpu")
    for name, module in pg.modules.items():
        module.load_state_dict(from_jax_params(
            type(module).__name__, params[name], stats.get(name, {})))

    (loss_w, (err_w, _)), grads_w = jax.value_and_grad(
        _loss_fn, has_aux=True)(params, jg, stats, jnp.asarray(feats),
                                jnp.asarray(labs), None, jnp.asarray(n_valid))
    optimizers = {n: make_optimizer(a) for n, a in exp.archs.items()}
    frozen = {n: a.freeze for n, a in exp.archs.items()}
    opt_states = {n: optimizers[n].init(params[n]) for n in params}
    new_params, new_stats, _, loss_s, _ = make_train_step(
        jg, optimizers, frozen, donate=False)(
        params, stats, opt_states, jnp.asarray(feats), jnp.asarray(labs),
        jax.random.key(0), jnp.asarray(n_valid))
    np.testing.assert_allclose(float(loss_s), float(loss_w), atol=1e-6)

    opts = make_all_optimizers(pg.archs, pg.modules)
    loss, err = train_step(pg, opts, torch.from_numpy(feats),
                           torch.from_numpy(labs), n_valid)
    np.testing.assert_allclose(loss.item(), float(loss_w), rtol=0, atol=1e-5)
    np.testing.assert_allclose(err.item(), float(err_w), rtol=0, atol=1e-6)
    for name, module in pg.modules.items():
        got_grads, _ = port_tree(module, grads=True)
        assert_trees_close(got_grads, grads_w[name], 1e-5, f"grad {name}")
        got_params, got_stats = port_tree(module)
        assert_trees_close(got_params, new_params[name], 1e-5, name)
        assert_trees_close(got_stats, new_stats.get(name, {}), 1e-5,
                           f"stats {name}")
        if exp.archs[name].freeze:
            assert_trees_close(got_params, params[name], 0.0, name)

    # the eval step on the stepped weights
    loss_e, err_e = make_eval_step(jg)(new_params, new_stats,
                                       jnp.asarray(feats), jnp.asarray(labs),
                                       jnp.asarray(n_valid))
    got_loss, got_err = eval_step(pg, torch.from_numpy(feats),
                                  torch.from_numpy(labs), n_valid)
    np.testing.assert_allclose(got_loss.item(), float(loss_e), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_err.item(), float(err_e), rtol=0,
                               atol=1e-6)
