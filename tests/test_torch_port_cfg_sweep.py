"""Every shipped cfg (cfg/**/*.cfg, 39 of them) through the port against
tpukaldi: the sweep over the whole zoo.

Each cfg is read by both packages' `load_config`, its widths shrunk with a
copy of tests/test_cfg_matrix_runs.py's `SHRINK` list (the raw recipes'
and CNN_fbank's learning rates cut 100x, as
tests/test_torch_port_conv.py::RECIPE_SHRINK cuts the raw recipes': a
rounding that flips a max-pool argmax reroutes a gradient, and a full-size
rmsprop step turns that into a visible weight difference), its dropout
rates set to 0.  Both packages build the cfg's graph over synthetic
streams of its feature names (per corpus one base width, spliced by each
stream's context window: TIMIT and Librispeech 13, DIRHA 24, divisible by
the 6 mics of the fusion recipe and, spliced 5x, by the QLSTM's 4; raw
windows of 400 samples), tpukaldi's init reaches the port through
`from_jax_params`, and then, on one batch of synthetic features and labels
(sequence models: T = 12, B = 3, 9 valid frames; frame models: 36 rows):

- one train step: loss, err, every gradient, the batch statistics and the
  stepped weights (against tpukaldi's optimizer on the port's gradients to
  1e-5, and against tpukaldi's own step to 1e-5 plus what the optimizer
  makes of the gradients' rounding: see `_assert_step_close`);
- one eval step on the stepped weights: loss and err;
- one forward of the stepped weights with lengths < T (sequence models),
  on the valid frames.

Tolerance: 1e-5 absolute, as tests/torch_port_helpers.py's
`check_train_and_eval_step` holds the recipes.  `liGRU_fmllr_bf16.cfg`
runs in the bf16 compute mode on both sides (`compute_dtype = bfloat16`),
tpukaldi's liGRU at `ligru_impl = pallas` (its kernel in interpret mode,
the semantics of the port's `auto`), and is held by the bounds of
tests/test_torch_port_bf16.py: its bf16 loss within max(2 |tpk bf16 - tpk
f32|, 1e-3) of tpukaldi's bf16 loss, each master gradient no further (L2)
from tpukaldi's float32 one than 2x tpukaldi's bf16 gradient is, and the
bf16 forward's posteriors within 0.05 in probability space of tpukaldi's.
"""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.config import load_config as tpk_load_config
from tpukaldi.graph import compiler as jax_compiler
from tpukaldi.train.optimizers import make_optimizer
from tpukaldi.train.step import _loss_fn, make_eval_step, make_forward_step
from tpukaldi_torch.compat.jax_params import from_jax_params
from tpukaldi_torch.config import load_config
from tpukaldi_torch.graph import compiler
from tpukaldi_torch.models.registry import resolve
from tpukaldi_torch.train.chunk_runtime import compute_dtype
from tpukaldi_torch.train.optimizers import make_all_optimizers
from tpukaldi_torch.train.step import eval_step, forward_step, train_step
from torch_port_helpers import assert_trees_close, port_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(os.path.relpath(p, os.path.join(REPO, "cfg"))
              for p in glob.glob(os.path.join(REPO, "cfg", "**", "*.cfg"),
                                 recursive=True))
N_CD, N_MONO = 8, 4
ATOL = 1e-5
T, B, N_VALID, N_FRAMES = 12, 3, 9, 36
# each corpus's base stream width (the raw stream: its window length)
DIMS = {"TIMIT": 13, "Librispeech": 13, "DIRHA": 24}
RAW_DIM = 400

# a copy of tests/test_cfg_matrix_runs.py:162-196
SHRINK = [
    # layer-size shrinks keep option-list lengths intact
    ("1024,1024,1024,1024,1024,N_out_lab_cd", "24,24,24,24,24,N_out_lab_cd"),
    ("1024,1024,1024,1024,N_out_lab_cd", "24,24,24,24,N_out_lab_cd"),
    ("1024,1024,1024,1024,1024", "24,24,24,24,24"),
    ("550,550,550,550,550", "16,16,16,16,16"),
    ("550,550,550,550", "16,16,16,16"),
    ("550,550,550", "16,16,16"),
    ("lstm_lay = 1024,1024", "lstm_lay = 16,16"),
    ("hidden_size = 550", "hidden_size = 16"),
    ("num_layers = 4", "num_layers = 2"),
    ("sru_hidden_size = 550", "sru_hidden_size = 16"),
    ("sru_num_layers = 4", "sru_num_layers = 2"),
    ("cnn_n_filt = 80,60,60", "cnn_n_filt = 8,6,6"),
    ("cnn_n_filt = 128,60,60,60", "cnn_n_filt = 8,6,6,6"),
    ("sinc_n_filt = 80,60,60", "sinc_n_filt = 8,6,6"),
    ("fusionRNN_lay = 512,512,512,512", "fusionRNN_lay = 12,12,12,12"),
    ("fusionRNN_fusion_layer_size = 3072", "fusionRNN_fusion_layer_size = 24"),
    ("dnn_lay = 2048,2048,N_out_lab_cd", "dnn_lay = 24,24,N_out_lab_cd"),
    ("dnn_lay = 1024,N_out_lab_cd", "dnn_lay = 24,N_out_lab_cd"),
    ("dnn_lay = 1024,100", "dnn_lay = 24,8"),
    ("dnn_lay = 1024", "dnn_lay = 16"),
    # batch sizes / epochs / chunks
    ("batch_size_train = 128", "batch_size_train = 16"),
    ("batch_size_valid = 128", "batch_size_valid = 16"),
    ("batch_size_train = 8", "batch_size_train = 2"),
    ("batch_size_valid = 8", "batch_size_valid = 2"),
    ("batch_size_train = 16", "batch_size_train = 2"),
    ("batch_size_valid = 16", "batch_size_valid = 2"),
    ("n_epochs_tr = 24", "n_epochs_tr = 2"),
    ("n_epochs_tr = 8", "n_epochs_tr = 2"),
    ("n_chunks = 5", "n_chunks = 2"),
    ("n_chunks = 40", "n_chunks = 2"),
    ("n_chunks=1", "n_chunks=1"),
]

# per cfg, replacements made before SHRINK's
EXTRA = {
    # the decoder reconstructs the spliced fbank stream: 13 x (5 + 1 + 5)
    "TIMIT/MLP_fbank_autoencoder.cfg": [("dnn_lay = 1024,440",
                                         "dnn_lay = 24,143")],
    # the enhancement MLP outputs the clean stream's width
    "TIMIT/TIMIT_rev/joint_training_liGRU_fbank.cfg": [("dnn_lay = 40",
                                                         "dnn_lay = 13")],
    # learning rates cut 100x (see the module docstring)
    "TIMIT/CNN_raw.cfg": [("arch_lr = 0.0008", "arch_lr = 0.000008")],
    "TIMIT/SincNet_raw.cfg": [("arch_lr = 0.08", "arch_lr = 0.0008")],
    "TIMIT/CNN_fbank.cfg": [("arch_lr = 0.08", "arch_lr = 0.0008")],
    # per-epoch schedules re-scoped to SHRINK's 2 epochs, as
    # tests/test_cfg_matrix_runs.py::TIMIT_CASES does
    "TIMIT/MLP_mfcc_basic_flex.cfg": [
        ("batch_size_train = 128*12 | 64*10 | 32*2",
         "batch_size_train = 16*1 | 8*1"),
        ("max_seq_length_train = 1000*18 | 500*6",
         "max_seq_length_train = 1000*1 | 500*1"),
        ("arch_lr = 0.08*10|0.04*5|0.02*3|0.01*2|0.005*2|0.0025*2",
         "arch_lr = 0.08*1|0.04*1"),
        ("dnn_drop = 0.15*12|0.20*12,0.15,0.15*10|0.20*14,0.15,0.0",
         "dnn_drop = 0.15*1|0.20*1,0.15,0.15*1|0.20*1,0.15,0.0"),
    ],
    "TIMIT/liGRU_fmllr_lr_schedule.cfg": [
        ("arch_lr = 0.0004*10|0.0002*4|0.0001*4|0.00005*2|0.000025*2"
         "|0.0000125*2", "arch_lr = 0.0004*1|0.0002*1")],
}
BF16 = "TIMIT/liGRU_fmllr_bf16.cfg"


def _prepare(cfg_rel, tmp_path):
    """The cfg shrunk and pointed at `tmp_path` (no data there: both sides
    load it with strict_paths=False), N_out set through `lab_nout`."""
    with open(os.path.join(REPO, "cfg", cfg_rel)) as f:
        text = f.read()
    for var in ("$KALDI_TIMIT", "$KALDI_LIBRI", "$KALDI_DIRHA"):
        text = text.replace(var, str(tmp_path / "tree"))
    text = re.sub(r"out_folder = \S+", f"out_folder = {tmp_path / 'out'}",
                  text)
    text = text.replace("lab_opts=ali-to-pdf",
                        f"lab_opts=ali-to-pdf\n\tlab_nout={N_CD}")
    text = text.replace("lab_opts=ali-to-phones --per-frame=true",
                        "lab_opts=ali-to-phones --per-frame=true"
                        f"\n\tlab_nout={N_MONO}")
    for old, new in EXTRA.get(cfg_rel, ()):
        assert old in text, (cfg_rel, old)
        text = text.replace(old, new)
    for old, new in SHRINK:
        text = text.replace(old, new)
    path = tmp_path / "run.cfg"
    path.write_text(text)
    return str(path)


def _no_dropout(exp):
    """Every architecture's dropout rates set to 0 (the modules read them
    from their options)."""
    for arch in exp.archs.values():
        for key, value in arch.options.items():
            if "drop" in key:
                arch.options[key] = ",".join("0.0" for _ in value.split(","))


def _layouts(exp, cfg_rel):
    """(fea layout, lab layout) of the train set: each stream's base width
    spliced by its context window, in the dataset's order."""
    ds = exp.datasets[exp.train_with[0]]
    fea, off = {}, 0
    for name, spec in ds.features.items():
        base = RAW_DIM if name == "raw" else DIMS[cfg_rel.split("/")[0]]
        width = base * (spec.cw_left + spec.cw_right + 1)
        fea[name] = (off, off + width)
        off += width
    lab = {name: i for i, name in enumerate(ds.labels)}
    n_out = [spec.n_out for spec in ds.labels.values()]
    return fea, lab, n_out


def _batch(seq, width, n_out, rng):
    shape = (T, B) if seq else (N_FRAMES,)
    feats = rng.standard_normal((*shape, width)).astype(np.float32)
    labs = np.stack([rng.integers(0, n, shape) for n in n_out], axis=-1)
    return feats, labs


def _assert_step_close(got, want, got_g, want_g, gain, path):
    """|got - want| <= ATOL + gain * |got_g - want_g| elementwise."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_step_close(got[k], want[k], got_g[k], want_g[k], gain,
                               f"{path}/{k}")
        return
    excess = (np.abs(np.asarray(got) - np.asarray(want)) - ATOL
              - gain * np.abs(np.asarray(got_g) - np.asarray(want_g)))
    assert excess.max(initial=0.0) <= 0.0, (path, float(excess.max()))


def _valid_rows(lengths):
    """The (T*B,) rows of a flattened (T, B, C) output with t < length."""
    return (np.arange(T)[:, None] < lengths[None, :]).reshape(-1)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree, np.float64)


def _check_bf16(exp_j, exp, cfg_rel):
    """The bf16 recipe: one bf16 train step and one bf16 forward of the
    port against tpukaldi's, by the bounds of the module docstring."""
    assert compute_dtype(exp) == torch.bfloat16
    for arch in exp_j.archs.values():
        if "ligru_impl" in arch.options:
            arch.options["ligru_impl"] = "pallas"
    _no_dropout(exp_j)
    _no_dropout(exp)
    fea, lab, n_out = _layouts(exp, cfg_rel)
    width = max(end for _, end in fea.values())
    jg = jax_compiler.build_graph(exp_j, fea, lab)
    pg = compiler.build_graph(exp, fea, lab, "cpu")
    rng = np.random.default_rng(11)
    feats, labs = _batch(True, width, n_out, rng)
    params, stats = jax_compiler.init_graph(jg, jax.random.key(3),
                                            jnp.asarray(feats))
    for name, module in pg.modules.items():
        module.load_state_dict(from_jax_params(
            type(module).__name__, jax.tree_util.tree_map(np.asarray,
                                                          params[name]),
            jax.tree_util.tree_map(np.asarray, stats.get(name, {}))))
    tpk = {}
    for mode, cdt in (("f32", None), ("bf16", jnp.bfloat16)):
        (loss, _), grads = jax.jit(
            lambda p, s, f, lb, n: jax.value_and_grad(_loss_fn, has_aux=True)(
                p, jg, s, f, lb, None, n, cdt))(
            params, stats, jnp.asarray(feats), jnp.asarray(labs),
            jnp.asarray(N_VALID))
        tpk[mode] = (float(loss), grads)
    lengths = np.array([T, 7, 4], np.int64)
    want = make_forward_step(jg, compute_dtype=jnp.bfloat16)(
        params, stats, jnp.asarray(feats), jnp.asarray(lengths, jnp.int32))
    got = forward_step(pg, torch.from_numpy(feats), torch.from_numpy(lengths),
                       compute_dtype=torch.bfloat16)
    rows = _valid_rows(lengths)
    for name in want:
        np.testing.assert_allclose(np.exp(got[name].numpy()[rows]),
                                   np.exp(np.asarray(want[name])[rows]),
                                   rtol=0, atol=0.05, err_msg=name)
    loss, _ = train_step(pg, make_all_optimizers(pg.archs, pg.modules),
                         torch.from_numpy(feats), torch.from_numpy(labs),
                         N_VALID, None, torch.bfloat16)
    own = abs(tpk["bf16"][0] - tpk["f32"][0])
    assert abs(loss.item() - tpk["bf16"][0]) <= max(2 * own, 1e-3), (
        loss.item(), tpk)
    worst = 0.0
    for name, module in pg.modules.items():
        got_grads, _ = port_tree(module, grads=True)
        want32 = dict(_leaves(tpk["f32"][1][name]))
        want16 = dict(_leaves(tpk["bf16"][1][name]))
        for path, g in _leaves(got_grads):
            d_port = np.linalg.norm(g - want32[path])
            d_tpk = np.linalg.norm(want16[path] - want32[path])
            assert d_port <= 2 * d_tpk, (name, path, d_port, d_tpk)
            worst = max(worst, d_port / max(d_tpk, 1e-30))
    print(f"{cfg_rel}: loss gap {abs(loss.item() - tpk['bf16'][0]):.3e} "
          f"(tpukaldi's bf16-f32 {own:.3e}), gradient distance ratio <= "
          f"{worst:.3f}")


@pytest.mark.parametrize("cfg_rel", CFGS)
def test_cfg_matches_tpukaldi(cfg_rel, tmp_path):
    path = _prepare(cfg_rel, tmp_path)
    exp_j = tpk_load_config(path, strict_paths=False)
    exp = load_config(path, strict_paths=False)
    # every class a shipped cfg names resolves in the port
    for arch in exp.archs.values():
        resolve(arch.class_name, arch.library)
    if cfg_rel == BF16:
        _check_bf16(exp_j, exp, cfg_rel)
        return
    assert compute_dtype(exp) is None
    _no_dropout(exp_j)
    _no_dropout(exp)
    fea, lab, n_out = _layouts(exp, cfg_rel)
    width = max(end for _, end in fea.values())
    jg = jax_compiler.build_graph(exp_j, fea, lab)
    pg = compiler.build_graph(exp, fea, lab, "cpu")
    rng = np.random.default_rng(11)
    feats, labs = _batch(jg.seq_model, width, n_out, rng)
    n_valid = N_VALID if jg.seq_model else None
    jn_valid = None if n_valid is None else jnp.asarray(n_valid)
    params, stats = jax_compiler.init_graph(jg, jax.random.key(3),
                                            jnp.asarray(feats))
    params = jax.tree_util.tree_map(np.asarray, params)
    stats = jax.tree_util.tree_map(np.asarray, stats)
    for name, module in pg.modules.items():
        module.load_state_dict(from_jax_params(
            type(module).__name__, params[name], stats.get(name, {})))

    # one train step: tpukaldi's loss and gradients (jitted once), then its
    # step body's update, `params + optimizer.update(grads)`, per arch
    (loss_w, (err_w, new_stats)), grads_w = jax.jit(
        lambda p, s, f, lb, n: jax.value_and_grad(_loss_fn, has_aux=True)(
            p, jg, s, f, lb, None, n))(
        params, stats, jnp.asarray(feats), jnp.asarray(labs), jn_valid)
    grads_w = jax.tree_util.tree_map(np.asarray, grads_w)
    new_stats = jax.tree_util.tree_map(np.asarray, new_stats)
    new_params = {}
    for name, arch in exp_j.archs.items():
        tx = make_optimizer(arch)
        new_params[name] = params[name]
        if not arch.freeze:
            updates, _ = tx.update(grads_w[name], tx.init(params[name]),
                                   params[name])
            new_params[name] = jax.tree_util.tree_map(
                lambda p, u: np.asarray(p + u), params[name], updates)
    loss, err = train_step(pg, make_all_optimizers(pg.archs, pg.modules),
                           torch.from_numpy(feats), torch.from_numpy(labs),
                           n_valid)
    np.testing.assert_allclose(loss.item(), float(loss_w), rtol=0, atol=ATOL)
    np.testing.assert_allclose(err.item(), float(err_w), rtol=0, atol=1e-6)
    for name, module in pg.modules.items():
        arch = exp_j.archs[name]
        got_grads, _ = port_tree(module, grads=True)
        assert_trees_close(got_grads, grads_w[name], ATOL, f"grad {name}")
        got_params, got_stats = port_tree(module)
        assert_trees_close(got_stats, new_stats.get(name, {}), ATOL,
                           f"stats {name}")
        if arch.freeze:
            assert_trees_close(got_params, params[name], 0.0, name)
            continue
        # the port's step is tpukaldi's optimizer on the port's gradients
        tx = make_optimizer(arch)
        updates, _ = tx.update(got_grads, tx.init(params[name]), params[name])
        assert_trees_close(got_params, jax.tree_util.tree_map(
            lambda p, u: np.asarray(p + u), params[name], updates), ATOL,
            f"step {name}")
        # and tpukaldi's own step up to its gradients' rounding, which the
        # optimizer amplifies where a gradient is tiny: rmsprop's and adam's
        # first step g / (sqrt(c) |g| + eps) changes by up to |dg| / eps
        # (e.g. a bias before a batchnorm, whose gradient is 0 but for
        # rounding, or a deep layer's gradient of order eps)
        slope = 1.0 if arch.optimizer.kind == "sgd" else 1.0 / float(
            arch.optimizer.options.get("opt_eps", 1e-8))
        _assert_step_close(got_params, new_params[name], got_grads,
                           grads_w[name], arch.lr[0] * slope, name)

    # one eval step on the stepped weights
    loss_e, err_e = make_eval_step(jg)(new_params, new_stats,
                                       jnp.asarray(feats), jnp.asarray(labs),
                                       jn_valid)
    got_loss, got_err = eval_step(pg, torch.from_numpy(feats),
                                  torch.from_numpy(labs), n_valid)
    np.testing.assert_allclose(got_loss.item(), float(loss_e), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got_err.item(), float(err_e), rtol=0,
                               atol=1e-6)

    # one forward with lengths < T (sequence models), on the valid frames
    lengths = np.array([T, 7, 4], np.int64) if jg.seq_model else None
    want = make_forward_step(jg)(
        new_params, new_stats, jnp.asarray(feats),
        None if lengths is None else jnp.asarray(lengths, jnp.int32))
    got = forward_step(pg, torch.from_numpy(feats),
                       None if lengths is None else torch.from_numpy(lengths))
    assert sorted(got) == sorted(want) == sorted(exp.forward.outs)
    for name in want:
        w, g = np.asarray(want[name]), got[name].numpy()
        assert g.shape == w.shape, name
        if lengths is not None:
            rows = _valid_rows(lengths)
            w, g = w[rows], g[rows]
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
