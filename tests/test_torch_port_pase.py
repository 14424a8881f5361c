"""The port's PASE encoder (tpukaldi_torch/models/pase.py) and its weight
maps against tpukaldi's (tpukaldi/models/pase.py,
compat/torch_import.py::convert_pase_checkpoint), on the CPU at small
sizes.

1. The encoder at the small cfg of tests/test_torch_import.py (strides 10,
   16) and at a cfg with an even kernel and a length the strides do not
   divide (flax's "SAME" padding, uneven), in train and eval mode: the
   output, the batch statistics, the input's and every parameter's
   gradient within 1e-5 of their largest (float32 on both sides, sums in
   other orders).
2. The weight maps both ways; `convert_pase_checkpoint` and
   `convert_pase_checkpoint_file` on tpukaldi's fabricated pase state
   dict: the same trees as tpukaldi's, one output from both packages.
3. PASE -> the flagship's heads through both packages' `run_experiment`
   from one init at drop 0 (window = shift = 160, the decimation): res.res
   and the arks within 1e-3; and with a 400-sample window both packages
   raise (the encoder gives n_lab + 2 frames), nothing cropped.

Inputs come from numpy with a seed.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.compat.torch_import import (
    convert_pase_checkpoint as tpk_convert,
    convert_pase_checkpoint_file as tpk_convert_file,
)
from tpukaldi.models.pase import PASE as JaxPASE
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi_torch.compat.jax_params import (
    convert_pase_checkpoint,
    convert_pase_checkpoint_file,
    from_jax_params,
    to_jax_params,
)
from tpukaldi_torch.models import PASE, resolve
from tpukaldi_torch.models.pase import decimation, read_pase_cfg
from tpukaldi_torch.tools.flagship_tree import (
    forward_outputs,
    save_seeded_init,
    write_kaldi_tree,
    write_rate_cfg,
)
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train.checkpoint import read_checkpoint
from torch_port_helpers import assert_trees_close, assert_trees_equal

RTOL = 1e-5
CFGS = {
    # tests/test_torch_import.py's small encoder
    "small": ({"emb_dim": 12, "fmaps": [8, 16], "kwidths": [5, 5],
               "strides": [10, 16], "sinc_out": 8, "sinc_kwidth": 31}, 480),
    # an even kernel (10) and strides (10, 3) that 517 samples do not fill
    "uneven": ({"emb_dim": 6, "fmaps": [8, 12], "kwidths": [10, 4],
                "strides": [10, 3], "sinc_out": 8, "sinc_kwidth": 31}, 517),
}


def _opts(tmp_path, cfg):
    path = tmp_path / "pase.json"
    path.write_text(json.dumps(cfg))
    return {"pase_cfg": str(path)}


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max(), err_msg=name)


def _weights(opts, x, seed):
    """tpukaldi's init with every batchnorm's affine map and statistics and
    every PReLU slope drawn from numpy: (params, stats)."""
    module = JaxPASE(options=opts, inp_dim=1)
    # jitted: flax's eager init takes seconds of op-by-op dispatch
    v = jax.jit(lambda key: module.init({"params": key}, jnp.asarray(x),
                                        train=False))(jax.random.key(seed))
    params = jax.tree_util.tree_map(np.asarray, dict(v["params"]))
    stats = jax.tree_util.tree_map(np.asarray, dict(v["batch_stats"]))
    rng = np.random.default_rng(seed)
    for name in stats:
        c = stats[name]["mean"].shape
        params[name] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                        "bias": rng.normal(0, 0.3, c).astype(np.float32)}
        stats[name] = {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                       "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    for name in params:
        if name.endswith("act") or name.startswith("act"):
            params[name] = rng.uniform(0.1, 0.4, params[name].shape).astype(
                np.float32)
    return params, stats


def _both(opts, x, params, stats, train, g, dtype):
    """The encoder's output, new batch statistics and gradients (tpukaldi's
    naming: input, then parameters) on both sides, in `dtype`."""
    with jax.enable_x64(dtype == np.float64):
        module = JaxPASE(options=opts, inp_dim=1)
        p0, s0 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dtype), (params, stats))

        def f(p, xx):
            if train:
                out, upd = module.apply({"params": p, "batch_stats": s0}, xx,
                                        train=True, mutable=["batch_stats"])
                return out, upd["batch_stats"]
            return module.apply({"params": p, "batch_stats": s0}, xx), s0

        def loss(p, xx):
            out, new_stats = f(p, xx)
            return jnp.sum(out * jnp.asarray(g, dtype)), (out, new_stats)

        (_, (out, new_stats)), (d_p, d_x) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p0, jnp.asarray(x, dtype))
        want = jax.tree_util.tree_map(
            np.asarray, (out, new_stats, d_x, d_p))

    port = PASE(opts, 1)
    port.load_state_dict(from_jax_params("PASE", params, stats))
    port = port.to(torch.float64 if dtype == np.float64 else torch.float32)
    port.train(train)
    xt = torch.tensor(x, dtype=port.low_hz.dtype, requires_grad=True)
    out = port(xt)
    (out * torch.tensor(g, dtype=out.dtype)).sum().backward()
    sd = dict(port.state_dict())
    grads = to_jax_params(
        {**sd, **{n: p.grad for n, p in port.named_parameters()}}, "PASE")[0]
    got = (out.detach().numpy(), to_jax_params(sd, "PASE")[1],
           xt.grad.numpy(), grads)
    return got, want


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("which", sorted(CFGS))
def test_encoder_matches_tpukaldi(which, train, tmp_path):
    """The output, the new batch statistics and the input's gradient in
    float32; every parameter's gradient in float64 as well (in float32 the
    PReLU slopes' sums of ~1,500 terms part by 2e-5 of their largest
    through rounding alone).  In train mode a conv bias before a batchnorm
    has no gradient (the batch mean takes it out): float noise on both
    sides, held to 1e-5 of the largest parameter gradient."""
    cfg, L = CFGS[which]
    opts = _opts(tmp_path, cfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((L, 3, 1)).astype(np.float32)
    params, stats = _weights(opts, x, seed=2)
    T_out = -(-L // decimation(opts))
    g = rng.standard_normal((T_out, 3, cfg["emb_dim"])).astype(np.float32)
    for dtype in (np.float32, np.float64):
        (out, new_stats, dx, grads), (w_out, w_stats, w_dx, w_grads) = _both(
            opts, x, params, stats, train, g, dtype)
        assert w_out.shape == (T_out, 3, cfg["emb_dim"])
        _close(out, w_out, f"{dtype.__name__} output")
        _close(dx, w_dx, f"{dtype.__name__} input gradient")
        for name, s in w_stats.items():
            for key in ("mean", "var"):
                _close(new_stats[name][key], s[key], f"{name}/{key}")
        if dtype == np.float32:
            continue
        top = max(np.abs(a).max() for a in jax.tree_util.tree_leaves(w_grads))
        for name, want_g in w_grads.items():
            for key, w in (want_g.items() if isinstance(want_g, dict)
                           else [("", want_g)]):
                got_g = grads[name][key] if key else grads[name]
                if train and key == "bias" and name in ("emb", *(
                        f"conv{i}" for i in range(len(cfg["fmaps"])))):
                    assert np.abs(got_g).max() <= RTOL * top, name
                    assert np.abs(w).max() <= RTOL * top, name
                    continue
                _close(got_g, w, f"d{name}/{key}")


def test_padding_is_flax_same(tmp_path):
    """Each layer's frames: ceil(L / s); the encoder's, ceil(L / 160)."""
    opts = _opts(tmp_path, CFGS["uneven"][0])
    port = PASE(opts, 1).eval()
    for L in (1, 29, 30, 31, 517):
        with torch.no_grad():
            assert port(torch.zeros(L, 2, 1)).shape[0] == -(-L // 30)


def test_weight_maps_round_trip(tmp_path):
    opts = _opts(tmp_path, CFGS["uneven"][0])
    x = np.zeros((64, 1, 1), np.float32)
    params, stats = _weights(opts, x, seed=4)
    back = to_jax_params(from_jax_params("PASE", params, stats), "PASE")
    assert_trees_equal(back[0], params)
    assert_trees_equal(back[1], stats)
    # the port's init has tpukaldi's structure and mel-spaced cut-offs
    port = PASE(opts, 1)
    port.reset_parameters(torch.Generator().manual_seed(0))
    mine = to_jax_params(port.state_dict(), "PASE")[0]
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(params)
    assert_trees_close({k: mine[k] for k in ("low_hz", "band_hz")},
                       {k: params[k] for k in ("low_hz", "band_hz")}, 1e-3)


def _pase_state_dict(rng):
    """tests/test_torch_import.py's fabricated pase front-end state dict
    for the small cfg."""
    def bn(prefix, c, sd):
        sd[f"{prefix}.weight"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{prefix}.bias"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{prefix}.running_mean"] = np.zeros(c, np.float32)
        sd[f"{prefix}.running_var"] = np.ones(c, np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.array(7)

    sd = {}
    sd["frontend.sinc.low_hz_"] = rng.uniform(30, 4000, (8, 1)).astype(
        np.float32)
    sd["frontend.sinc.band_hz_"] = rng.uniform(50, 400, (8, 1)).astype(
        np.float32)
    bn("frontend.bn0", 8, sd)
    sd["frontend.act0.weight"] = np.full(8, 0.1, np.float32)
    for i, (o, inp, k) in enumerate([(8, 8, 5), (16, 8, 5)]):
        sd[f"frontend.blocks.{i}.conv.weight"] = (
            rng.standard_normal((o, inp, k)).astype(np.float32) * 0.1)
        sd[f"frontend.blocks.{i}.conv.bias"] = np.zeros(o, np.float32)
        bn(f"frontend.blocks.{i}.bn", o, sd)
        sd[f"frontend.blocks.{i}.act.weight"] = np.array([0.2], np.float32)
    sd["frontend.emb.weight"] = (
        rng.standard_normal((12, 16, 1)).astype(np.float32) * 0.1)
    sd["frontend.emb.bias"] = np.zeros(12, np.float32)
    bn("frontend.emb_bn", 12, sd)
    return sd


def test_convert_pase_checkpoint_matches_tpukaldi(tmp_path):
    opts = _opts(tmp_path, CFGS["small"][0])
    sd = _pase_state_dict(np.random.default_rng(3))
    params, stats = convert_pase_checkpoint(sd, opts)
    want_p, want_s = tpk_convert(sd, opts)
    assert_trees_equal(params, want_p)
    assert_trees_equal(stats, want_s)
    assert params["act0"].shape == (8,)
    x = np.random.default_rng(5).standard_normal((480, 2, 1)).astype(
        np.float32)
    module = JaxPASE(options=opts, inp_dim=1)
    want = jax.jit(lambda v, xx: module.apply(v, xx))(
        {"params": want_p, "batch_stats": want_s}, jnp.asarray(x))
    port = PASE(opts, 1).eval()
    port.load_state_dict(from_jax_params("PASE", params, stats))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want, "output")

    # the file versions: torch.load a state dict, write a .ckpt both
    # packages read (tpukaldi's through the port's reader too)
    pt = str(tmp_path / "pase.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               pt)
    ours, theirs = str(tmp_path / "ours.ckpt"), str(tmp_path / "theirs.ckpt")
    convert_pase_checkpoint_file(pt, opts["pase_cfg"], ours)
    tpk_convert_file(pt, opts["pase_cfg"], theirs)
    for path in (ours, theirs):
        p, opt_state, s = read_checkpoint(path)
        assert_trees_equal(p, params)
        assert_trees_equal(s, stats)
        assert opt_state == {}
    from tpukaldi.train.checkpoint import load_checkpoint

    p, _, s = load_checkpoint(ours)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, p), params)


def test_convert_refuses_a_mismatched_checkpoint(tmp_path):
    opts = _opts(tmp_path, {**CFGS["small"][0], "fmaps": [8, 32]})
    with pytest.raises(ValueError, match="conv1: checkpoint shape"):
        convert_pase_checkpoint(_pase_state_dict(np.random.default_rng(3)),
                                opts)


def test_read_pase_cfg_cache_keys_on_the_file(tmp_path):
    path = tmp_path / "p.json"
    path.write_text(json.dumps({"emb_dim": 12}))
    opts = {"pase_cfg": str(path)}
    assert read_pase_cfg(opts)["emb_dim"] == 12
    path.write_text(json.dumps({"emb_dim": 140, "strides": [10, 16]}))
    cfg = read_pase_cfg(opts)
    assert cfg["emb_dim"] == 140 and decimation(opts) == 160
    assert read_pase_cfg({})["fmaps"] == (64, 128, 128, 256, 256, 512, 512)
    for lib in ("tpukaldi.models", "tpukaldi_torch.models", "neural_networks"):
        assert resolve("PASE", lib) is PASE


# ------------------------------------------------ 3. through run_experiment
# short utterances in one length bucket: few batch shapes, few compiles
SPLITS = {"train": (4, 20, 24), "dev": (2, 20, 24), "test": (2, 20, 24)}
RUN_CUTS = {"n_epochs_tr = 24": "n_epochs_tr = 2", "n_chunks = 5": "n_chunks = 2"}


@pytest.fixture(scope="module")
def pase_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("pase")
    path = root / "pase.json"
    path.write_text(json.dumps(CFGS["small"][0]))
    trees = {w: write_kaldi_tree(str(root / f"tree{w}"), 4, n_phones=3,
                                 n_pdfs=9, splits=SPLITS, wave_window=w)
             for w in (160, 400)}
    return root, str(path), trees


def _arks(out):
    return dict(forward_outputs(out)[0])


def _ep_numbers(out):
    """The loss and err values of res.res's `ep=` lines."""
    with open(os.path.join(out, "res.res")) as f:
        return [float(v) for line in f if line.startswith("ep=")
                for v in re.findall(r"(?:loss|err)=([\d.]+)", line)]


def test_pase_run_matches_tpukaldi(pase_setup):
    """PASE (small cfg) -> the two heads, 2 epochs of 2 chunks at drop 0
    from the port's seeded init, through both packages: every res.res loss
    and err within 1e-3, the same ark keys and shapes (one row per label
    frame), values within 1e-3."""
    root, pase_json, trees = pase_setup
    outs = {}
    for side in ("tpk", "port"):
        out = str(root / f"run_{side}")
        cfg = write_rate_cfg(trees[160], out, str(root / f"{side}.cfg"),
                             "PASE", RUN_CUTS, pase_cfg=pase_json,
                             recurrent=False)
        if side == "tpk":
            init = save_seeded_init(cfg, 1, str(root / "init"))
            tpk_run_experiment(cfg, overrides=init)
        else:
            run_experiment(cfg, overrides=init, device="cpu")
        outs[side] = out
    want, got = _ep_numbers(outs["tpk"]), _ep_numbers(outs["port"])
    assert len(want) == len(got) == 2 * 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    a, b = _arks(outs["tpk"]), _arks(outs["port"])
    assert sorted(a) == sorted(b) and len(a) == SPLITS["test"][0]
    for key, w in a.items():
        assert b[key].shape == w.shape and w.shape[1] == 9
        np.testing.assert_allclose(b[key], w, rtol=0, atol=1e-3, err_msg=key)


def test_pase_label_mismatch_raises_in_both(pase_setup):
    """A 400-sample window gives the encoder n_lab + 2 frames for n_lab
    labels: tpukaldi's cost fails to broadcast, the port's raises on the
    row counts; neither crops."""
    root, pase_json, trees = pase_setup
    for side, run, err in (
            ("tpk", tpk_run_experiment, "Incompatible shapes"),
            ("port", lambda c: run_experiment(c, device="cpu"),
             "output rows against")):
        out = str(root / f"mismatch_{side}")
        cfg = write_rate_cfg(trees[400], out, str(root / f"mm_{side}.cfg"),
                             "PASE", RUN_CUTS, pase_cfg=pase_json,
                             recurrent=False)
        with open(cfg) as f:
            text = f.read()
        with open(cfg, "w") as f:
            f.write(text.replace(",160,160", ",160,400"))
        with pytest.raises(ValueError, match=err):
            run(cfg)


def test_bf16_raises_in_both(pase_setup, monkeypatch):
    """In bf16 compute mode tpukaldi's PASE fails (its float32 sinc filters
    meet a bf16 signal in the convolution); the port refuses with
    NotImplementedError, the class and the dtype named, before any output
    is written, and the module itself refuses a bf16 input."""
    root, pase_json, trees = pase_setup
    monkeypatch.setenv("TPUKALDI_COMPUTE_DTYPE", "bfloat16")
    cfgs = {side: write_rate_cfg(trees[160], str(root / f"bf16_{side}"),
                                 str(root / f"bf16_{side}.cfg"), "PASE",
                                 RUN_CUTS, pase_cfg=pase_json,
                                 recurrent=False)
            for side in ("tpk", "port")}
    with pytest.raises(TypeError, match="requires arguments to have the same "
                                        "dtypes"):
        tpk_run_experiment(cfgs["tpk"])
    with pytest.raises(NotImplementedError,
                       match=r"PASE has no torch.bfloat16 compute mode"):
        run_experiment(cfgs["port"], device="cpu")
    assert not os.path.exists(str(root / "bf16_port"))
    with pytest.raises(NotImplementedError, match="PASE has no"):
        PASE(_opts(root, CFGS["small"][0]), 1)(
            torch.zeros(320, 1, 1, dtype=torch.bfloat16))
