"""The port's raw-waveform front-ends (tpukaldi_torch/models/cnn.py) and
their layer-0 kernels' plain versions (tpukaldi_torch/kernels/conv1d.py)
against tpukaldi's, on the CPU at small sizes.

1. `conv1d_pool_ref`/`_bwd_ref` and `conv1d_pool_ln_act_ref`/`_bwd_ref`,
   and the autograd Functions around them, against tpukaldi's plain
   references `_xla_conv_pool` / `_xla_conv_pool_ln_act` at "highest"
   precision and their `jax.vjp`; dbias exactly 0.
2. The dropout hash mask bit for bit against tpukaldi's `_drop_mask`, and
   the plain K6 at drop 0.15 against the composed reference times that
   mask, forward and backward; one tiny interpret-mode call of tpukaldi's
   Pallas kernel with dropout, which fixes the seed and window-id
   conventions.
3. `CNN` and `SincNet` (both SincConv variants) under `auto` and `pallas`
   in eval and train mode against tpukaldi's modules with the same weights,
   which the weight maps carry both ways.
4. Both raw recipes (cfg/TIMIT/CNN_raw.cfg, SincNet_raw.cfg) shrunk and run
   by both packages: production forward, and 2 epochs of training from one
   seeded init.
5. The knob, the registry, the float32 pin and the launch counters; the
   kernels against their plain versions on a card (skipped without one).

Inputs come from numpy with a seed; training comparisons run at drop 0,
since torch cannot draw JAX's threefry bits.  Each tolerance is stated
where it is used.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.compat.torch_import import import_model_par
from tpukaldi.io import read_mat_ark
from tpukaldi.kernels import conv1d as jax_conv
from tpukaldi.models import cnn as jax_cnn
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi.train.chunk_runtime import read_info as tpk_read_info
from tpukaldi_torch.compat.jax_params import from_jax_params, to_jax_params
from tpukaldi_torch.kernels import conv1d
from tpukaldi_torch.models import CNN, SincNet, resolve
from tpukaldi_torch.models.cnn import conv_impl
from tpukaldi_torch.tools.flagship_tree import (
    forward_outputs,
    recipe_cfg,
    save_seeded_finals,
    save_seeded_init,
    write_kaldi_tree,
    write_prod_cfg,
    write_train_cfg,
)
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train import chunk_runtime
from torch_port_helpers import assert_trees_equal, jax_init, port_tree

# float32 on both sides, sums in other orders: the forward of order 1
FWD_ATOL = 1e-5
# train mode: batchnorm divides by a batch std over a few dozen rows,
# which scales the rounding up
TRAIN_FWD_ATOL = 1e-4
# gradients: sums of hundreds of terms in other orders, relative to each
# tensor's max
GRAD_RTOL = 2e-4
EPS = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close_rel(got, want, rtol, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=name)


def _conv_inputs(N, L, K, O, pool, seed):
    rng = np.random.default_rng(seed)
    M = (L - K + 1) // pool
    x = rng.standard_normal((N, L)).astype(np.float32)
    w = (rng.standard_normal((K, O)) / np.sqrt(K)).astype(np.float32)
    bias = rng.standard_normal(O).astype(np.float32)
    gt = (1 + 0.3 * rng.standard_normal((M, O))).astype(np.float32)
    bt = (0.3 * rng.standard_normal((M, O))).astype(np.float32)
    dy = rng.standard_normal((N, M, O)).astype(np.float32)
    return x, w, bias, gt, bt, dy


# ------------------------------------------------- 1. the plain versions
@pytest.mark.parametrize("shape", [
    (3, 800, 129, 32, 3),   # the recipe's K and pool, narrow windows
    (2, 400, 129, 16, 3),   # the CPU tests' raw windows
    (3, 500, 40, 16, 2),    # K < 128
    (5, 260, 7, 9, 5),      # odd N, tiny K, a pool tail
    (3, 800, 251, 32, 3),   # SincNet's published 251 taps
    (2, 400, 251, 16, 3),   # 251 taps over the CPU tests' raw windows
    (2, 800, 129, 16, 16),  # a pool past the forwards' run of 12
])
def test_conv_pool_matches_tpukaldi(shape):
    """y and (dx, dw) of the plain K5 and of `ConvPool` against tpukaldi's
    `_xla_conv_pool` and its VJP: y to FWD_ATOL, the argmax first-match,
    the gradients to GRAD_RTOL of each tensor's max."""
    N, L, K, O, pool = shape
    x, w, _, _, _, dy = _conv_inputs(*shape, seed=sum(shape))
    y_j, vjp = jax.vjp(lambda a, b: jax_conv._xla_conv_pool(a, b, pool,
                                                            "highest"),
                       jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))
    y, idx = conv1d.conv1d_pool_ref(_t(x), _t(w), pool)
    assert y.shape == idx.shape == (N, (L - K + 1) // pool, O)
    assert idx.dtype == torch.int8 and 0 <= idx.min() and idx.max() < pool
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0,
                               atol=FWD_ATOL)
    leaves = [_t(a).requires_grad_() for a in (x, w)]
    (conv1d.ConvPool.apply(*leaves, pool) * _t(dy)).sum().backward()
    for dx, dw in (conv1d.conv1d_pool_bwd_ref(_t(x), _t(dy), idx, _t(w), pool),
                   [a.grad for a in leaves]):
        _close_rel(dx, dx_j, GRAD_RTOL, "dx")
        _close_rel(dw, dw_j, GRAD_RTOL, "dw")


def test_pool_argmax_takes_the_first_match():
    """Ties pick the first index, as tpukaldi's kernel and torch do."""
    c = torch.tensor([[[1.0], [1.0], [0.5], [2.0], [2.0], [2.0]]])
    m, idx = conv1d._pool_argmax(c, 3)
    assert m.flatten().tolist() == [1.0, 2.0]
    assert idx.flatten().tolist() == [0, 0]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [
    (5, 640, 129, 16, 2),  # the recipe's K
    (3, 423, 40, 16, 3),   # K < 128, odd N
    (3, 800, 251, 32, 3),  # SincNet's published 251 taps
    (2, 400, 251, 16, 3),  # 251 taps over the CPU tests' raw windows
    (2, 800, 129, 16, 16),  # a pool past the forwards' run of 12
])
def test_conv_pool_ln_act_matches_tpukaldi(shape, relu):
    """out of the plain K6 and of `ConvPoolLnAct`, and all five gradients,
    against tpukaldi's `_xla_conv_pool_ln_act` and its VJP: out to FWD_ATOL,
    dx, dw, dgt and dbt to GRAD_RTOL of each tensor's max; dbias is an
    exact zero (the layer norm's mean cancels the bias; tpukaldi's kernel
    emits the same zero, its composed autodiff ~1e-7 of noise)."""
    N, L, K, O, pool = shape
    x, w, bias, gt, bt, dy = _conv_inputs(*shape, seed=sum(shape) + relu)
    f = lambda a, b, g, h: jax_conv._xla_conv_pool_ln_act(  # noqa: E731
        a, b, jnp.asarray(bias), g, h, pool, EPS, relu, "highest")
    z_j, vjp = jax.vjp(f, *map(jnp.asarray, (x, w, gt, bt)))
    grads_j = vjp(jnp.asarray(dy))
    z, idx, stats = conv1d.conv1d_pool_ln_act_ref(
        _t(x), _t(w), _t(bias), _t(gt), _t(bt), 0, pool, EPS, relu, 0.0)
    assert stats.shape == (N, 2, O)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=0,
                               atol=FWD_ATOL)
    got_ref = conv1d.conv1d_pool_ln_act_bwd_ref(
        _t(x), _t(w), _t(bias), _t(gt), _t(bt), 0, idx, stats, _t(dy), pool,
        EPS, relu, 0.0)
    leaves = [_t(a).requires_grad_() for a in (x, w, bias, gt, bt)]
    out = conv1d.ConvPoolLnAct.apply(*leaves, 0, pool, EPS, relu, 0.0)
    np.testing.assert_allclose(out.detach().numpy(), z.numpy(), rtol=0, atol=0)
    (out * _t(dy)).sum().backward()
    for got in (got_ref, [a.grad for a in leaves]):
        dx, dw, dbias, dgt, dbt = got
        assert torch.equal(dbias, torch.zeros_like(dbias))
        for name, a, b in zip(("dx", "dw", "dgt", "dbt"), (dx, dw, dgt, dbt),
                              grads_j):
            _close_rel(a, b, GRAD_RTOL, name)


# ------------------------------------------------- 2. the dropout mask
@pytest.mark.parametrize("drop", [0.15, 0.5])
@pytest.mark.parametrize("seed", [-1, -2 ** 31, 2 ** 31 - 1, 987654321])
def test_drop_mask_is_tpukaldis_bit_for_bit(seed, drop):
    """The hash mask of every window id equals tpukaldi's `_drop_mask`
    (called with a (1, 1) int32 seed as its kernel reads it), element for
    element; and the vectorised form over window ids equals the
    per-window one."""
    M, O = 13, 11
    wids = [0, 1, 7, 8, 1000, 2 ** 20 + 3]
    got = conv1d.drop_mask(seed, torch.tensor(wids), M, O, drop)
    assert got.shape == (len(wids), M, O) and got.dtype == torch.bool
    for k, wid in enumerate(wids):
        want = np.asarray(jax_conv._drop_mask(
            jnp.full((1, 1), seed, jnp.int32), jnp.int32(wid), (M, O), drop))
        np.testing.assert_array_equal(got[k].numpy(), want)
        np.testing.assert_array_equal(
            conv1d.drop_mask(seed, wid, M, O, drop).numpy(), want)
    keep = got.float().mean().item()
    assert abs(keep - (1 - drop)) < 0.1


def test_keep_threshold_and_scale_follow_tpukaldi():
    """The threshold by Python's round (halves to even) and clamped below
    2^32; the scale 1/(1-drop) rounded to float32."""
    assert conv1d.keep_threshold(0.0) == 2 ** 32 - 1
    assert conv1d.keep_threshold(0.5) == 2 ** 31
    assert conv1d.keep_threshold(0.15) == round(0.85 * 2.0 ** 32)
    assert conv1d.drop_scale(0.15).item() == np.float32(1 / 0.85)


def test_dropped_conv_pool_ln_act_matches_masked_composed():
    """The plain K6 at drop 0.15 equals tpukaldi's composed chain times
    tpukaldi's hash mask over 1/keep (window id = the row in the call), and
    its gradients equal the VJP of that masked chain: to FWD_ATOL and
    GRAD_RTOL."""
    shape = (6, 423, 40, 16, 3)
    N, L, K, O, pool = shape
    drop, seed = 0.15, -77
    x, w, bias, gt, bt, dy = _conv_inputs(*shape, seed=5)
    M = gt.shape[0]
    mask = np.stack([np.asarray(jax_conv._drop_mask(
        jnp.full((1, 1), seed, jnp.int32), jnp.int32(n), (M, O), drop))
        for n in range(N)])
    scale = np.float32(1.0 / (1.0 - drop))

    def masked(a, b, g, h):
        z = jax_conv._xla_conv_pool_ln_act(a, b, jnp.asarray(bias), g, h, pool,
                                           EPS, True, "highest")
        return jnp.where(mask, z * scale, 0.0)

    z_j, vjp = jax.vjp(masked, *map(jnp.asarray, (x, w, gt, bt)))
    grads_j = vjp(jnp.asarray(dy))
    leaves = [_t(a).requires_grad_() for a in (x, w, bias, gt, bt)]
    out = conv1d.ConvPoolLnAct.apply(*leaves, seed, pool, EPS, True, drop)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(z_j), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_array_equal(out.detach().numpy() == 0,
                                  np.asarray(z_j) == 0)
    (out * _t(dy)).sum().backward()
    assert torch.equal(leaves[2].grad, torch.zeros(O))
    for name, a, b in zip(("dx", "dw", "dgt", "dbt"),
                          [leaves[i].grad for i in (0, 1, 3, 4)], grads_j):
        _close_rel(a, b, GRAD_RTOL, name)


def test_dropout_matches_tpukaldis_interpret_kernel():
    """One tiny call of tpukaldi's Pallas `conv1d_pool_ln_act` in interpret
    mode with dropout: the plain K6 with the same int32 seed drops the same
    elements (the window id is the row in the call, over two of its
    8-window programs) and agrees to FWD_ATOL."""
    shape = (10, 512 + 24, 25, 128, 2)  # M = 256: the kernel's lane layout
    N, L, K, O, pool = shape
    drop, seed = 0.15, 123456789
    x, w, bias, gt, bt, _ = _conv_inputs(*shape, seed=9)
    want = np.asarray(jax_conv.conv1d_pool_ln_act(
        *map(jnp.asarray, (x, w, bias, gt, bt)), seed, pool, EPS, True, drop,
        True, "highest"))
    got, _, _ = conv1d.conv1d_pool_ln_act_ref(
        _t(x), _t(w), _t(bias), _t(gt), _t(bt), seed, pool, EPS, True, drop)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)


# ------------------------------------------------- 3. the modules
CNN_OPTS = dict(
    cnn_n_filt="16,8,8,8", cnn_len_filt="129,5,5,3",
    cnn_max_pool_len="3,3,3,2", cnn_use_laynorm_inp="True",
    cnn_use_batchnorm_inp="False", cnn_use_laynorm="True,True,True,True",
    cnn_use_batchnorm="False,False,True,False", cnn_act="relu,relu,relu,relu",
    cnn_drop="0.0,0.0,0.0,0.0")
SINC_OPTS = dict(
    sinc_n_filt="16,8,8", sinc_len_filt="129,5,3", sinc_max_pool_len="3,3,3",
    sinc_sample_rate="16000", sinc_min_low_hz="50", sinc_min_band_hz="50",
    sinc_use_laynorm_inp="True", sinc_use_batchnorm_inp="False",
    sinc_use_laynorm="True,True,True", sinc_use_batchnorm="False,True,False",
    sinc_act="leaky_relu,leaky_relu,leaky_relu", sinc_drop="0.0,0.0,0.0")
# SincNet's published filter lengths (Ravanelli & Bengio, SLT 2018; its
# cfg/SincNet_TIMIT.cfg): layer 0 of 251 taps
SINC251 = {"sinc_len_filt = 129,5,3": "sinc_len_filt = 251,5,5"}
MODULES = {
    "CNN": (jax_cnn.CNN, CNN, CNN_OPTS),
    "SincNet": (jax_cnn.SincNet, SincNet, SINC_OPTS),
    "SincNet_fast": (jax_cnn.SincNet, SincNet, {**SINC_OPTS, "sinc_fast": "True"}),
    "SincNet251": (jax_cnn.SincNet, SincNet,
                   {**SINC_OPTS, "sinc_len_filt": "251,5,5"}),
}
L_RAW = 400


def _port(name, params, stats, impl, monkeypatch):
    _, cls, opts = MODULES[name]
    monkeypatch.setenv("TPUKALDI_CONV_IMPL", impl)
    module = cls(opts, L_RAW)
    module.load_state_dict(from_jax_params(cls.__name__, params, stats))
    return module


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_flax(name, impl, train, monkeypatch):
    """Outputs and every gradient of the port's CNN and SincNet (layer 0
    through K6 for the CNN's relu and layer norm, through K5 for SincNet's
    leaky_relu, under `pallas`; the composed path under `auto` on CPU)
    against tpukaldi's module on its CPU path, from the same weights, with a
    batchnorm layer so that train and eval differ; drop 0.  Outputs to
    FWD_ATOL (TRAIN_FWD_ATOL in train mode), gradients to GRAD_RTOL of each
    tensor's max.  The conv
    biases are followed by a layer norm, which cancels them: their
    gradients are zero up to float32 noise on both sides (exactly zero
    through K6), so they are held below 1e-4 of the weight gradient's max.
    The fast SincConv's cut-off gradients are ill-conditioned in float32
    (sines of up to 200 rad): each package lands 2-5% from float64 there,
    so they are held to a float64 run of both syntheses instead."""
    jcls, _, opts = MODULES[name]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, L_RAW)).astype(np.float32)
    g = rng.standard_normal((6, jcls.compute_out_dim(opts, L_RAW))).astype(
        np.float32)
    jmod, params, stats = jax_init(jcls, opts, x, 7)

    def loss(p, xx):
        y = jmod.apply({"params": p, "batch_stats": stats}, xx, train=train,
                       mutable=["batch_stats"])[0]
        return (y * g).sum(), y

    (_, want), (grads_p, grads_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    port = _port(name, params, stats, impl, monkeypatch).train(train)
    xt = _t(x).requires_grad_()
    got = port(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=TRAIN_FWD_ATOL if train else FWD_ATOL)
    (got * _t(g)).sum().backward()
    _close_rel(xt.grad, grads_x, GRAD_RTOL, "dx")
    got_grads, _ = port_tree(port, grads=True)
    fast_cutoffs = name == "SincNet_fast"
    for key, want_g in grads_p.items():
        if isinstance(want_g, dict):
            for k, v in want_g.items():
                _close_rel(got_grads[key][k], v, GRAD_RTOL, f"{key}/{k}")
        elif key.endswith("_b"):
            scale = np.abs(np.asarray(grads_p[key[:-2]])).max()
            assert np.abs(np.asarray(got_grads[key])).max() <= 1e-4 * scale
            assert np.abs(np.asarray(want_g)).max() <= 1e-4 * scale
        elif not (fast_cutoffs and key in ("low_hz", "band_hz")):
            _close_rel(got_grads[key], want_g, GRAD_RTOL, key)
    if impl == "pallas" and name == "CNN":
        assert torch.equal(port.conv[0].bias.grad,
                           torch.zeros_like(port.conv[0].bias))


def test_fast_sinc_cutoff_gradients_match_in_float64():
    """The fast SincConv's synthesis and its cut-off gradients, port and
    tpukaldi, in float64 (where float32's conditioning does not blur them):
    to 1e-10 of each tensor's max."""
    from tpukaldi_torch.models.cnn import sinc_filters_fast

    n = 16
    mel = np.linspace(jax_cnn._to_mel(30), jax_cnn._to_mel(7900), n + 1)
    hz = jax_cnn._to_hz(mel)
    low, band = hz[:-1, None], np.diff(hz)[:, None]
    G = np.random.default_rng(0).standard_normal((n, 129))
    with jax.enable_x64(True):
        f = lambda lo, b: (jax_cnn.sinc_filters_fast(  # noqa: E731
            lo, b, 129, 16000, 50, 50) * jnp.asarray(G)).sum()
        want = [np.asarray(a) for a in jax.grad(f, argnums=(0, 1))(
            jnp.asarray(low), jnp.asarray(band))]
        filt = np.asarray(jax_cnn.sinc_filters_fast(
            jnp.asarray(low), jnp.asarray(band), 129, 16000, 50, 50))
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in (low, band)]
    got_f = sinc_filters_fast(*leaves, 129, 16000, 50, 50)
    (got_f * torch.tensor(G)).sum().backward()
    _close_rel(got_f.detach(), filt, 1e-10, "filters")
    for leaf, w in zip(leaves, want):
        _close_rel(leaf.grad, w, 1e-10, "cut-off gradient")


@pytest.mark.parametrize("name", ["CNN", "SincNet"])
def test_conv_weight_map_round_trip(name):
    """tpukaldi params -> port state_dict (strict load, the reference's key
    names) -> the port's to_jax_params and tpukaldi's import_model_par ==
    the params, exactly."""
    jcls, cls, opts = MODULES[name]
    x = np.zeros((2, L_RAW), np.float32)
    _, params, stats = jax_init(jcls, opts, x, 11)
    port = cls(opts, L_RAW)
    port.load_state_dict(from_jax_params(name, params, stats))
    sd = port.state_dict()
    bn = "bn.2" if name == "CNN" else "bn.1"
    assert {"ln0.gamma", "conv.1.weight", "ln.2.beta", f"{bn}.running_var"} <= set(sd)
    assert ("conv.0.low_hz_" in sd) == (name == "SincNet")
    assert sd["ln.0.gamma"].shape == (16, (L_RAW - 129 + 1) // 3)
    for back in (to_jax_params(sd, name), import_model_par(sd, name)):
        assert_trees_equal(back[0], params)
        assert_trees_equal(back[1], stats)
    assert from_jax_params(name, params, stats).keys() == sd.keys()


def test_out_dim_truncates_as_the_reference():
    """int((current - K + 1) / pool) per layer, float then truncate:
    SincNet_raw's 3200 samples give 1024, 340, 112 (338 / 3 -> 112)."""
    opts = {**SINC_OPTS, "sinc_n_filt": "80,60,60"}
    assert SincNet._dims(opts, 3200)[3] == [1024, 340, 112]
    assert SincNet.compute_out_dim(opts, 3200) == 6720
    assert CNN.compute_out_dim({**CNN_OPTS, "cnn_n_filt": "128,60,60,60"},
                               3200) == 3300


# ------------------------------------------------- 4. the recipes
SPLITS = {"train": (16, 40, 80), "dev": (4, 40, 60), "test": (5, 30, 90)}
SHRINK = {
    "dnn_lay = 2048,2048,N_out_lab_cd": "dnn_lay = 32,32,N_out_lab_cd",
    "dnn_drop = 0.15,0.15,0.0": "dnn_drop = 0.0,0.0,0.0",
    "n_epochs_tr = 24": "n_epochs_tr = 2",
    "n_chunks = 5": "n_chunks = 2",
}
RECIPE_SHRINK = {
    # The learning rates are cut 100x.  At the recipes' own rates the
    # training is chaotic: a float32 rounding that flips a max-pool argmax
    # reroutes a gradient, and tpukaldi's own two conv lowerings (nhc, dot)
    # part by 1e-2 in the loss within five steps.  At 1/100 both pairs,
    # port and tpukaldi, stay within 1.3e-4 over twelve steps.
    "CNN": {"cnn_n_filt = 128,60,60,60": "cnn_n_filt = 16,8,8,8",
            "cnn_drop = 0.15,0.15,0.15,0.15": "cnn_drop = 0.0,0.0,0.0,0.0",
            "arch_lr = 0.0008": "arch_lr = 0.000008"},
    "SincNet": {"sinc_n_filt = 80,60,60": "sinc_n_filt = 16,8,8",
                "arch_lr = 0.08": "arch_lr = 0.0008"},
}


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    return write_kaldi_tree(str(tmp_path_factory.mktemp("raw")), 10,
                            n_phones=3, n_pdfs=9, splits=SPLITS,
                            raw_wlen=L_RAW)


def test_raw_tree_shares_the_label_rate(raw_tree):
    """One raw window of L_RAW samples per label frame, utterance by
    utterance, in every split."""
    from tpukaldi_torch.io import read_mat_scp

    for split in SPLITS:
        raw = dict(read_mat_scp(os.path.join(
            raw_tree, "data", "raw_200ms", split, "feats_raw.scp")))
        fea = dict(read_mat_scp(os.path.join(raw_tree, "data", split,
                                             "feats.scp")))
        assert sorted(raw) == sorted(fea) and len(raw) == SPLITS[split][0]
        for key, m in raw.items():
            assert m.shape == (fea[key].shape[0], L_RAW) and m.dtype == np.float32
            assert np.abs(m).max() <= 1.0


def _arks(out):
    ef = os.path.join(out, "exp_files")
    name = [f for f in os.listdir(ef) if f.endswith("_to_decode.ark")]
    assert len(name) == 1
    return dict(read_mat_ark(os.path.join(ef, name[0])))


@pytest.mark.parametrize("recipe", ["CNN", "SincNet", "SincNet251"])
def test_raw_recipe_serving_matches_tpukaldi(recipe, raw_tree, tmp_path,
                                             monkeypatch):
    """The production forward of the shrunk recipe from the port's seeded
    final checkpoints, read by both packages: every posterior row within
    1e-4 (log-posteriors minus log-priors, order 10), the port through its
    plain K6/K5 (`pallas`).  SincNet251 is SincNet_raw.cfg at the paper's
    filter lengths (SINC251), layer 0 of 251 taps."""
    monkeypatch.setenv("TPUKALDI_CONV_IMPL", "pallas")
    base = "SincNet" if recipe == "SincNet251" else recipe
    shrink = {**SHRINK, **RECIPE_SHRINK[base],
              **(SINC251 if recipe == "SincNet251" else {})}
    outs = {}
    for side in ("tpk", "port"):
        out = str(tmp_path / side)
        outs[side] = write_prod_cfg(raw_tree, out, str(tmp_path / f"{side}.cfg"),
                                    shrink, recipe=recipe_cfg(base))
        save_seeded_finals(outs[side], L_RAW)
    run_experiment(outs["port"], device="cpu")
    monkeypatch.delenv("TPUKALDI_CONV_IMPL")
    tpk_run_experiment(outs["tpk"])
    want = _arks(str(tmp_path / "tpk"))
    got = dict(forward_outputs(str(tmp_path / "port"))[0])
    assert sorted(got) == sorted(want) and len(want) == SPLITS["test"][0]
    for key, w in want.items():
        assert got[key].shape == w.shape == (w.shape[0], 9)
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-4, err_msg=key)


@pytest.fixture(scope="module")
def tpk_runs(raw_tree, tmp_path_factory):
    """tpukaldi's 2-epoch runs of both shrunk recipes and the seeded init
    overrides they started from: recipe -> (out folder, overrides)."""
    runs = {}
    for recipe in RECIPE_SHRINK:
        base = tmp_path_factory.mktemp(f"tpk_{recipe}")
        out = str(base / "out")
        os.makedirs(out)
        cfg = write_train_cfg(raw_tree, out, str(base / "run.cfg"),
                              {**SHRINK, **RECIPE_SHRINK[recipe]},
                              recipe=recipe_cfg(recipe))
        init = save_seeded_init(cfg, L_RAW, str(base / "init"))
        tpk_run_experiment(cfg, overrides=init)
        runs[recipe] = (out, init)
    return runs


def _infos(out):
    ef = os.path.join(out, "exp_files")
    return {f: os.path.join(ef, f) for f in sorted(os.listdir(ef))
            if f.endswith(".info") and not f.startswith("forward_")}


def _res_lines(out, prefix):
    with open(os.path.join(out, "res.res")) as f:
        return [line for line in f if line.startswith(prefix)]


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("recipe", ["CNN", "SincNet"])
def test_raw_recipe_training_run_matches_tpukaldi(recipe, impl, raw_tree,
                                                  tpk_runs, tmp_path,
                                                  monkeypatch):
    """The shrunk recipe (16-filter layer 0, 32-wide MLP, drop 0, rates
    cut 100x, 2 epochs of 2 chunks) trained by the port (CPU; `auto`: the
    composed path, `pallas`: K6's or K5's plain versions through their
    Functions) from tpukaldi's seeded initial weights: per-chunk loss and
    frames in the .info ledger within 1e-3 absolute (the loss is ~2), the
    same new-bob decisions and lr entries in res.res, and the forward arks
    within 1e-3 absolute (order 10).  err is discrete: the shrunk network
    is near chance, its 9-way outputs near-uniform, and a 1e-4 change of
    the logits flips the argmax of a few near-tie frames (1-3 of a chunk's
    384 seen), so err is held within 1e-2, 3.8 frames of 384."""
    monkeypatch.setenv("TPUKALDI_CONV_IMPL", impl)
    out_tpk, init = tpk_runs[recipe]
    out = str(tmp_path / "port")
    os.makedirs(out)
    cfg = write_train_cfg(raw_tree, out, str(tmp_path / "run.cfg"),
                          {**SHRINK, **RECIPE_SHRINK[recipe]},
                          recipe=recipe_cfg(recipe))
    before = chunk_runtime.train_batches
    run_experiment(cfg, overrides=init, device="cpu")
    assert chunk_runtime.train_batches > before
    want, got = _infos(out_tpk), _infos(out)
    assert list(got) == list(want) and len(want) == 2 * (2 + 1)
    for name in want:
        w, g = tpk_read_info(want[name]), chunk_runtime.read_info(got[name])
        for key, atol in (("loss", 1e-3), ("frames", 1e-3), ("err", 1e-2)):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=atol,
                                       err_msg=f"{name} {key}")
    with open(os.path.join(out_tpk, "log.log")) as f:
        bob_tpk = [line for line in f if "[new-bob]" in line]
    with open(os.path.join(out, "log.log")) as f:
        assert [line for line in f if "[new-bob]" in line] == bob_tpk
    lrs = [[w for w in line.split() if w.startswith("lr_")]
           for line in _res_lines(out, "ep=")]
    assert lrs == [[w for w in line.split() if w.startswith("lr_")]
                   for line in _res_lines(out_tpk, "ep=")]
    assert len(lrs) == 2 and all(lrs)
    ark_tpk, ark_port = _arks(out_tpk), _arks(out)
    assert sorted(ark_port) == sorted(ark_tpk)
    for key, w in ark_tpk.items():
        np.testing.assert_allclose(ark_port[key], w, rtol=0, atol=1e-3,
                                   err_msg=key)


def test_train_step_gradients_takes_frame_batches(raw_tree, tmp_path):
    """`flagship_tree.train_step_gradients` (the train-step check's
    helper) on a raw recipe: frame batches, which carry no `n_valid_t`, and
    a first chunk smaller than a batch (here of 1024), which runs as one
    batch of its frames, as the runtime runs it.  A finite loss and a
    gradient for every parameter, the conv biases' exact or noise-sized
    zeros among them."""
    from tpukaldi_torch.tools.flagship_tree import train_step_gradients

    out = str(tmp_path / "out")
    cfg = write_train_cfg(raw_tree, out, str(tmp_path / "run.cfg"),
                          {**SHRINK, **RECIPE_SHRINK["CNN"],
                           "batch_size_train = 128": "batch_size_train = 1024"},
                          recipe=recipe_cfg("CNN"))
    loss, grads, shape = train_step_gradients(cfg, "cpu")
    assert np.isfinite(loss) and len(shape) == 2 and shape[1] == L_RAW
    assert 0 < shape[0] < 1024
    assert {"CNN_layers.conv.0.weight", "MLP_layers.wx.0.weight"} <= set(grads)
    assert all(torch.isfinite(g).all() for g in grads.values())


# ------------------------------------------------- 5. knobs and the card
def test_conv_impl_knob(monkeypatch):
    """One normalised knob: case and spaces do not matter, an unknown value
    raises (at module construction, where it is read)."""
    monkeypatch.setenv("TPUKALDI_CONV_IMPL", " Pallas ")
    assert conv_impl() == "pallas"
    assert CNN(CNN_OPTS, L_RAW).impl == "pallas"
    monkeypatch.setenv("TPUKALDI_CONV_IMPL", "cudnn")
    with pytest.raises(ValueError, match="TPUKALDI_CONV_IMPL"):
        CNN(CNN_OPTS, L_RAW)
    monkeypatch.delenv("TPUKALDI_CONV_IMPL")
    assert conv_impl() == "auto"


def test_kernel_gates_raise():
    """K5's and K6's envelope, 1 <= K <= 512 and 1 <= pool <= 32 with a
    pooled row, is checked before any device dispatch: outside it a
    ValueError names the limit (not a silent reroute), on the CPU and on
    any other device (here the meta device); SincNet's 251 taps and a pool
    of 16 run, through the Functions and the no-grad ops.  The whole conv
    stack (K7) keeps its own limits, K0 <= 129 and pool <= 12, at its gate
    and its entry."""
    from tpukaldi_torch.kernels import conv_stack, ops

    for device in ("cpu", "meta"):
        x = torch.zeros(2, 1200, device=device)
        args = [torch.zeros(4, device=device)] + [torch.zeros(
            (1200 - 100 + 1) // 33, 4, device=device)] * 2
        with pytest.raises(ValueError, match="K <= 512, got 513"):
            conv1d.ConvPool.apply(x, torch.zeros(513, 4, device=device), 3)
        with pytest.raises(ValueError, match="K <= 512, got 513"):
            conv1d.conv1d_pool_ln_act(x, torch.zeros(513, 4, device=device),
                                      *args, 0, 3, EPS, True)
        with pytest.raises(ValueError, match="pool <= 32, got 33"):
            conv1d.conv1d_pool(x, torch.zeros(100, 4, device=device), 33)
        with pytest.raises(ValueError, match="pool <= 32, got 33"):
            conv1d.conv1d_pool_ln_act(x, torch.zeros(100, 4, device=device),
                                      *args, 0, 33, EPS, True)
        with pytest.raises(ValueError, match="does not fit"):
            conv1d.conv1d_pool(x[:, :120], torch.zeros(100, 4, device=device),
                               30)
    x = torch.randn(2, 1200)
    for K, pool in ((251, 3), (251, 16), (512, 32)):
        M = (1200 - K + 1) // pool
        w = torch.randn(K, 4, requires_grad=True)
        assert conv1d.ConvPool.apply(x, w, pool).shape == (2, M, 4)
        assert ops.conv_pool(x, w.detach(), pool).shape == (2, M, 4)
        gt, bt = torch.ones(M, 4), torch.zeros(M, 4)
        out = conv1d.ConvPoolLnAct.apply(x, w, torch.zeros(4), gt, bt, 0,
                                         pool, EPS, True, 0.0)
        assert out.shape == (2, M, 4)
        out.sum().backward()
        assert torch.isfinite(w.grad).all()
    with pytest.raises(ValueError, match="K <= 129, got 130"):
        conv_stack.stack_supported((130, 5), (128, 60), 3200, (3, 3))
    with pytest.raises(ValueError, match="pool <= 12, got 16"):
        conv_stack.stack_supported((129, 5), (128, 60), 3200, (16, 3))
    z = torch.zeros
    with pytest.raises(ValueError, match="K <= 129, got 130"):
        conv_stack.conv_stack_fused(
            z(2, 400), z(130, 128), z(128), z(90, 128), z(90, 128),
            [(z(8, 128, 3), z(8), z(28, 8), z(28, 8))], 0, (3, 3), EPS,
            True, (0.0, 0.0))


def test_cuda_device_pins_float32(monkeypatch, raw_tree, tmp_path):
    """Resolving a CUDA device turns cuDNN's TF32 off (PyTorch's default is
    on) and keeps cuBLAS's off, through the legacy `allow_tf32` flags only,
    so their getters read back without a mixed-API error; a CPU device and
    a CPU runtime leave them as they are."""
    from tpukaldi_torch.tools.flagship_tree import train_plan

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        assert chunk_runtime.resolve_device("cpu") == torch.device("cpu")
        out = str(tmp_path / "out")
        exp, _ = train_plan(write_train_cfg(
            raw_tree, out, str(tmp_path / "run.cfg"), RECIPE_SHRINK["CNN"],
            recipe=recipe_cfg("CNN")))
        assert chunk_runtime.ChunkRuntime(exp, "cpu").device.type == "cpu"
        assert torch.backends.cudnn.allow_tf32
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert chunk_runtime.resolve_device("cuda:0") == torch.device("cuda:0")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_registry_resolves_the_raw_front_ends():
    from tpukaldi_torch.models import PASE, channel_averaging, logMelFb

    for lib in ("tpukaldi.models", "tpukaldi_torch.models", "neural_networks"):
        assert resolve("CNN", lib) is CNN
        assert resolve("SincNet", lib) is SincNet
        # the rate-differing raw-wave front ends
        assert resolve("logMelFb", lib) is logMelFb
        assert resolve("channel_averaging", lib) is channel_averaging
        assert resolve("PASE", lib) is PASE


def test_cpu_paths_count_no_launch(monkeypatch):
    """A train-mode forward and backward on CPU tensors through the plain
    K6 (the CNN, with its in-kernel dropout) and K5 (SincNet) reaches every
    parameter and counts no kernel launch."""
    monkeypatch.setenv("TPUKALDI_CONV_IMPL", "pallas")
    counters = ("launches", "bwd_launches", "ln_launches", "ln_bwd_launches")
    before = [getattr(conv1d, c) for c in counters]
    x = _t(np.random.default_rng(2).standard_normal((5, L_RAW)).astype(
        np.float32))
    for cls, opts in ((CNN, {**CNN_OPTS, "cnn_drop": "0.15,0.0,0.0,0.0"}),
                      (SincNet, SINC_OPTS)):
        module = cls(opts, L_RAW)
        module.reset_parameters(torch.Generator().manual_seed(1))
        out = module(x, generator=torch.Generator().manual_seed(3))
        out.square().sum().backward()
        # conv biases before a layer norm get exact or noise-sized zeros
        assert all(p.grad is not None for p in module.parameters())
    assert [getattr(conv1d, c) for c in counters] == before


def test_fused_dropout_seed_replays():
    """K6's dropout seed comes from the step's generator: the same
    generator seed drops the same elements, another seed others."""
    module = CNN({**CNN_OPTS, "cnn_drop": "0.15,0.0,0.0,0.0",
                  "cnn_use_batchnorm": "False,False,False,False"}, L_RAW)
    module.impl = "pallas"
    module.reset_parameters(torch.Generator().manual_seed(1))
    module.train()
    x = _t(np.random.default_rng(2).standard_normal((4, L_RAW)).astype(
        np.float32))
    outs = [module(x, generator=torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("fused, drop", [(False, 0.0), (True, 0.0),
                                         (True, 0.15)])
def test_functions_give_a_waveform_no_gradient(fused, drop):
    """A waveform that needs no gradient gets none: `ConvPool` and
    `ConvPoolLnAct` then skip dx (their plain backwards' `need_dx=False`
    returns None), and dW (and dgt, dbt, dbias) are bitwise those of the
    call that computes dx."""
    x, w, bias, gt, bt, dy = (_t(a) for a in
                              _conv_inputs(3, 500, 40, 16, 3, seed=5))
    grads = {}
    for need in (True, False):
        xx = x.clone().requires_grad_(need)
        leaves = [t.clone().requires_grad_()
                  for t in ((w, bias, gt, bt) if fused else (w,))]
        if fused:
            out = conv1d.ConvPoolLnAct.apply(xx, *leaves, 7, 3, EPS, True,
                                             drop)
        else:
            out = conv1d.ConvPool.apply(xx, *leaves, 3)
        (out * dy).sum().backward()
        grads[need] = (xx.grad, [t.grad for t in leaves])
    assert grads[True][0] is not None and grads[False][0] is None
    for a, b in zip(grads[True][1], grads[False][1]):
        assert torch.equal(a, b)
    idx = conv1d.conv1d_pool_ref(x, w, 3)[1]
    dx, dw = conv1d.conv1d_pool_bwd_ref(x, dy, idx, w, 3, need_dx=False)
    assert dx is None
    assert torch.equal(dw, conv1d.conv1d_pool_bwd_ref(x, dy, idx, w, 3)[1])


def test_fused_entries_keep_no_pooled_value_on_cpu():
    """On the CPU the fused forward keeps no ypool (the plain backward
    recomputes the pooled value through idx, as tpukaldi's does), and the
    backward, given none, is the plain backward."""
    x, w, bias, gt, bt, dy = (_t(a) for a in
                              _conv_inputs(2, 400, 40, 16, 3, seed=6))
    _, idx, stats, ypool = conv1d.conv1d_pool_ln_act(x, w, bias, gt, bt, 0,
                                                     3, EPS, True)
    assert ypool is None
    want = conv1d.conv1d_pool_ln_act_bwd_ref(x, w, bias, gt, bt, 0, idx,
                                             stats, dy, 3, EPS, True, 0.0)
    got = conv1d.conv1d_pool_ln_act_bwd(x, w, bias, gt, bt, 0, idx, stats,
                                        None, dy, 3, EPS, True, 0.0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [0.0, 0.15])
def test_conv_kernels_match_plain_on_card(drop):
    """K5f/K5b and K6f/K6b against their plain versions on the same card
    at a small odd shape; the backwards given the kernel's own idx (a sum
    in another order can flip a near-tie).  1e-5 absolute on the outputs
    and on K6f's saved pooled value, 1e-4 of each gradient's max; the same
    dropped elements.  Without dx (`need_dx=False`) the backwards return
    none, and their other gradients are bitwise those of the call with
    dx."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    chunk_runtime.pin_float32()
    x, w, bias, gt, bt, dy = (_t(a).cuda() for a in
                              _conv_inputs(13, 700, 100, 40, 3, seed=3))
    y, idx = conv1d.conv1d_pool(x, w, 3)
    y_r, _ = conv1d.conv1d_pool_ref(x, w, 3)
    torch.testing.assert_close(y, y_r, rtol=0, atol=1e-5)
    got = conv1d.conv1d_pool_bwd(x, dy, idx, w, 3)
    for a, b in zip(got, conv1d.conv1d_pool_bwd_ref(x, dy, idx, w, 3)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item())
    no_dx = conv1d.conv1d_pool_bwd(x, dy, idx, w, 3, need_dx=False)
    assert no_dx[0] is None and torch.equal(no_dx[1], got[1])
    out, idx, stats, ypool = conv1d.conv1d_pool_ln_act(
        x, w, bias, gt, bt, -5, 3, EPS, True, drop)
    out_r, _, _ = conv1d.conv1d_pool_ln_act_ref(x, w, bias, gt, bt, -5, 3,
                                                EPS, True, drop)
    torch.testing.assert_close(out, out_r, rtol=0, atol=1e-5)
    assert torch.equal(out == 0, out_r == 0)
    torch.testing.assert_close(ypool, conv1d._pooled_at(conv1d._conv(x, w),
                                                        idx, 3),
                               rtol=0, atol=1e-5)
    got = conv1d.conv1d_pool_ln_act_bwd(x, w, bias, gt, bt, -5, idx, stats,
                                        ypool, dy, 3, EPS, True, drop)
    want = conv1d.conv1d_pool_ln_act_bwd_ref(x, w, bias, gt, bt, -5, idx,
                                             stats, dy, 3, EPS, True, drop)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * max(b.abs().max().item(), 1e-30))
    no_dx = conv1d.conv1d_pool_ln_act_bwd(x, w, bias, gt, bt, -5, idx, stats,
                                          ypool, dy, 3, EPS, True, drop,
                                          need_dx=False)
    assert no_dx[0] is None
    assert all(torch.equal(a, b) for a, b in zip(no_dx[1:], got[1:]))
