"""The port's QLSTM (tpukaldi_torch/models/quaternion.py) and its bf16-U
LSTM recurrence (K4's plain versions and `LSTMLeanRecurrence` in
tpukaldi_torch/kernels/lstm.py) against tpukaldi's, on the CPU at small
sizes.

1. `hamilton_kernel` and `QuaternionDense` forward against tpukaldi's; the
   lean (`autograd = False`) gradients against `quaternion_linear_leanvjp`'s.
2. K4's plain versions and the Function against tpukaldi's
   `lstm_recurrence_lean` in interpret mode and its `jax.vjp`, at T = 13
   and 37 (not multiples of its time block) and at the edges of K4f's
   tiling (an odd batch, H = 36, a batch of 70).
3. `QLSTM` in eval mode, with and without lengths, under `qlstm_impl` scan
   and pallas, against tpukaldi's same impl from the same weights.
4. The QLSTM weight map both ways.
5. The DIRHA recipe (cfg/DIRHA/QLSTM_mfcc.cfg) shrunk and trained for 2
   epochs by both packages from one seeded init.
6. The registry, the dispatch and the launch counters; the kernels against
   their plain versions on a card (skipped without one).

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
from tpukaldi.kernels import lstm as jax_lstm
from tpukaldi.models import quaternion as jax_q
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi.train.chunk_runtime import read_info as tpk_read_info
from tpukaldi_torch.compat.jax_params import from_jax_params, to_jax_params
from tpukaldi_torch.kernels import _build
from tpukaldi_torch.kernels import lstm as port_lstm
from tpukaldi_torch.models import QLSTM, QuaternionDense, resolve
from tpukaldi_torch.models.quaternion import QuaternionLinearLean, hamilton_kernel
from tpukaldi_torch.tools.flagship_tree import (
    recipe_cfg,
    save_seeded_init,
    write_kaldi_tree,
    write_prod_cfg,
    write_train_cfg,
)
from tpukaldi_torch.tools import lstm_fwd_phases, lstm_lean_bwd_phases
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train import chunk_runtime
from torch_port_helpers import assert_trees_equal, jax_init, port_module

# float32 on both sides with the same operations, sums in another order
ATOL = 1e-5


# ------------------------------------------------- 1. quaternion dense
def _quat(rng, n, m):
    return [(rng.standard_normal((n, m)) / np.sqrt(4 * n)).astype(np.float32)
            for _ in range(4)]


def test_hamilton_kernel_matches_tpukaldi():
    """The block layout exactly: the same entries, negated the same way."""
    comps = _quat(np.random.default_rng(0), 3, 5)
    want = np.asarray(jax_q.hamilton_kernel(*map(jnp.asarray, comps)))
    got = hamilton_kernel(*map(torch.from_numpy, comps)).numpy()
    assert got.shape == want.shape == (12, 20)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lean", [False, True])
def test_quaternion_dense_matches_flax(lean):
    """Forward of the port's QuaternionDense with the flax module's
    weights, over a (T, B, D) input, to ATOL."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 3, 8)).astype(np.float32)
    jmod = jax_q.QuaternionDense(12, lean_vjp=lean)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.key(2), jnp.asarray(x))["params"])
    params["bias"] = rng.standard_normal(12).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = QuaternionDense(8, 12, lean=lean)
    mod.load_state_dict({f"{c}_weight": torch.tensor(params[c])
                         for c in "rijk"} | {"bias": torch.tensor(params["bias"])})
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_lean_quaternion_gradients_match_tpukaldi():
    """`QuaternionLinearLean`'s gradients of x and of each component
    against `jax.vjp` of `quaternion_linear_leanvjp` (tpukaldi's `_qbwd`),
    and against autograd through x @ K, to ATOL."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 2, 8)).astype(np.float32)
    comps = _quat(rng, 2, 4)
    g = rng.standard_normal((6, 2, 16)).astype(np.float32)
    _, vjp = jax.vjp(jax_q.quaternion_linear_leanvjp,
                     *map(jnp.asarray, [x, *comps]))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    for fn in (QuaternionLinearLean.apply,
               lambda x_, *c: x_ @ hamilton_kernel(*c)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in [x, *comps]]
        (fn(*leaves) * torch.from_numpy(g)).sum().backward()
        for leaf, w in zip(leaves, want):
            np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0, atol=ATOL)


# ------------------------------------------------- 2. the bf16-U recurrence
def _lstm_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    ff = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    u = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    # mask != 1: train-style Bernoulli rows scaled like the eval (1-p) factor
    mask = ((rng.random((B, H)) < 0.8) * 0.8).astype(np.float32)
    g = rng.standard_normal((T, B, H)).astype(np.float32)
    return ff, u, mask, g


# (T, B, H) of the bf16-U recurrence checks: T not a multiple of tpukaldi's
# time block, and the edges of K4f's tiling (an odd batch, H not a multiple
# of 16, a batch over 64 rows); the first two keep their ids
LEAN_SHAPES = [pytest.param(13, 4, 16, id="13"), pytest.param(37, 4, 16, id="37"),
               pytest.param(9, 5, 36, id="T9-B5-H36"),
               pytest.param(7, 70, 16, id="T7-B70-H16")]


@pytest.mark.parametrize("T, B, H", LEAN_SHAPES)
def test_lean_recurrence_matches_jax(T, B, H):
    """h and c of K4's plain forward; dff, dU and dmask of its plain
    backward and of `LSTMLeanRecurrence`, against tpukaldi's Pallas kernel
    in interpret mode and its VJP.  Both round h, U and dA to the same bf16
    operands and multiply exactly, so only the float32 sum order differs:
    ATOL absolute (the weight gradient relative to its max).  The float32
    recurrence is ~5e-4 away, so the test tells the two apart."""
    ff, u, mask, g = _lstm_inputs(T, B, H, seed=T)
    j = [jnp.asarray(x) for x in (ff, u, mask)]
    h_p, c_p = jax_lstm._lstm_lean_fwd_impl(*j, interpret=True)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_lstm.lstm_recurrence_lean(a, b, c, True), *j)
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]

    t = [torch.from_numpy(x) for x in (ff, u, mask, g)]
    h, c = port_lstm.lstm_recurrence_lean_ref(*t[:3])
    np.testing.assert_allclose(h.numpy(), np.asarray(h_p), rtol=0, atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_p), rtol=0, atol=ATOL)
    h32, _ = port_lstm.lstm_recurrence_ref(*t[:3])
    assert np.abs(h32.numpy() - np.asarray(h_p)).max() > 20 * ATOL

    got_ref = port_lstm.lstm_recurrence_lean_bwd_ref(t[0], h, c, t[3], t[1], t[2])
    leaves = [x.clone().requires_grad_() for x in t[:3]]
    (port_lstm.LSTMLeanRecurrence.apply(*leaves) * t[3]).sum().backward()
    for got in (got_ref, [x.grad for x in leaves]):
        for name, a, w in zip(("dff", "du", "dmask"), got, want):
            atol = ATOL * (np.abs(w).max() if name == "du" else 1.0)
            np.testing.assert_allclose(a.detach().numpy(), w, rtol=0,
                                       atol=atol, err_msg=name)


def test_lean_cpu_paths_count_no_launch():
    """On CPU tensors the lean wrappers run their plain versions: no
    launch is counted, forward or backward."""
    before = (port_lstm.lean_launches, port_lstm.lean_bwd_launches)
    ff, u, mask, g = (torch.from_numpy(x) for x in _lstm_inputs(9, 2, 8, 4))
    ff.requires_grad_()
    (port_lstm.LSTMLeanRecurrence.apply(ff, u, mask) * g).sum().backward()
    assert (port_lstm.lean_launches, port_lstm.lean_bwd_launches) == before


def test_lean_bwd_operands_layout():
    """K4b's bf16 operands: the remat's h_prev (the forward's h one step
    back, zero at t = 0) and U, both with H padded to the remat's stage
    depth with zeros, U's rows to 8 columns; and K4f's packed U."""
    T, B, H = 3, 2, 36
    h = torch.randn(T, B, H, generator=torch.Generator().manual_seed(1))
    u = torch.randn(H, 4 * H, generator=torch.Generator().manual_seed(2))
    hp, u16, upk = port_lstm.lean_bwd_operands(h, u)
    hk = port_lstm._pad(H, port_lstm.LEAN_REMAT_DEPTH)
    assert hk == 64 and hp.dtype == u16.dtype == upk.dtype == torch.bfloat16
    assert hp.shape == (T * B, hk) and u16.shape == (hk, 4 * H)
    assert not hp[:B].any() and not hp[:, H:].any() and not u16[H:].any()
    assert torch.equal(hp[B:, :H].float(),
                       h[:-1].reshape(-1, H).to(torch.bfloat16).float())
    assert torch.equal(u16[:H].float(), u.to(torch.bfloat16).float())
    assert torch.equal(upk, port_lstm._pack(u, H))
    # an odd H: U's rows of 4H = 148 columns padded to 152
    _, u16, _ = port_lstm.lean_bwd_operands(torch.zeros(T, B, 37),
                                            torch.ones(37, 148))
    assert u16.shape == (64, 152) and not u16[:, 148:].any()
    assert torch.equal(u16[:37, :148].float(), torch.ones(37, 148))


def test_lean_bwd_phase_variants_cut_what_they_name():
    """`tools/lstm_lean_bwd_phases.py` builds K4b's variants by replacing
    lines of `csrc/lstm_lean_bwd.cu`: each line is there once, each variant
    differs from the source, and each cut variant cuts what it names and
    keeps the rest."""
    with open(os.path.join(_build._CSRC, port_lstm.LEAN_BWD_SOURCE)) as f:
        source = f.read()
    assert lstm_lean_bwd_phases.source() == source
    got = lstm_fwd_phases.variants(source, lstm_lean_bwd_phases.VARIANTS)
    assert got["as built"] == source
    assert all(text != source for name, text in got.items()
               if name != "as built")
    cuts = {"nt < 0": "product", "!= 1e-30f": "stores",
            "__uint_as_float": "mma", "exchange = false": "exchange",
            "t >= p.T;": "chain", "the remat alone": "sequential launch"}
    want = {"no product": {"product"}, "no stores": {"stores"},
            "no mma": {"mma"}, "no group barrier": set(),
            "no exchange": {"exchange"}, "neither": {"product", "exchange"},
            "no chain": {"chain"}, "remat only": {"sequential launch"}}
    for name, (_, exact) in lstm_lean_bwd_phases.VARIANTS.items():
        assert exact == (name not in want), name
    for name, names in want.items():
        assert {cut for mark, cut in cuts.items()
                if mark in got[name]} == names, name
        # the one cut that removes its lines: the group's barrier
        assert ("tpk::grid_wait(gbar" in got[name]) == (
            name != "no group barrier"), name
    assert "R <= 1;" in got["R 1"] and "R = nu; R <= nu;" in got["S 1"]
    for old, _ in (lstm_lean_bwd_phases._NO_PRODUCT,
                   lstm_lean_bwd_phases._NO_STORES,
                   lstm_lean_bwd_phases._NO_MMA,
                   lstm_lean_bwd_phases._NO_GROUP_SYNC,
                   lstm_lean_bwd_phases._NO_EXCHANGE,
                   lstm_lean_bwd_phases._NO_CHAIN,
                   lstm_lean_bwd_phases._NO_SEQ):
        assert source.count(old) == 1
        with pytest.raises(ValueError, match="not in the source once"):
            lstm_fwd_phases.variants(source.replace(old, ""),
                                     lstm_lean_bwd_phases.VARIANTS)


# ------------------------------------------------- 3, 4. the QLSTM module
D = 12


def _opts(impl="auto", **extra):
    opts = dict(lstm_lay="16,16", lstm_drop="0.2,0.2", lstm_bidir="True",
                lstm_act="tanh,tanh", quaternion_init="quaternion",
                autograd="False", qlstm_impl=impl)
    opts.update(extra)
    return opts


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_qlstm_matches_flax(impl, with_lengths):
    """Eval-mode outputs of the port's QLSTM and tpukaldi's under the same
    `qlstm_impl` (scan: float32 recurrence; pallas: the bf16-U recurrence,
    tpukaldi's Pallas kernel in interpret mode, the port's plain version on
    CPU), weights through `from_jax_params`: ATOL absolute (order 1)."""
    opts = _opts(impl)
    rng = np.random.default_rng(3)
    T, B = 11, 3
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    lengths = np.array([11, 7, 4], np.int64) if with_lengths else None
    jmod, params, stats = jax_init(jax_q.QLSTM, opts,
                                   np.zeros((4, 2, D), np.float32), 5)
    want = np.asarray(jmod.apply(
        {"params": params}, jnp.asarray(x), train=False,
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32)))
    port = port_module(QLSTM, opts, D, params, stats, "QLSTM")
    with torch.inference_mode():
        got = port(torch.from_numpy(x),
                   lengths=None if lengths is None else torch.from_numpy(lengths))
    assert got.shape == want.shape == (T, B, port.out_dim) == (T, B, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_qlstm_weight_map_round_trip():
    """tpukaldi params -> port state_dict (strict load, the reference's key
    names) -> the port's to_jax_params and tpukaldi's import_model_par ==
    the params, exactly."""
    _, params, stats = jax_init(jax_q.QLSTM, _opts(),
                                np.zeros((4, 2, D), np.float32), 11)
    port = port_module(QLSTM, _opts(), D, params, stats, "QLSTM")
    sd = port.state_dict()
    assert {"wfx.0.r_weight", "wcx.1.bias", "uch.1.k_weight"} <= set(sd)
    assert not any(k.startswith("ufh") and k.endswith("bias") for k in sd)
    for back in (to_jax_params(sd, "QLSTM"), import_model_par(sd, "QLSTM")):
        assert_trees_equal(back[0], params)
        assert back[1] == {}
    assert from_jax_params("QLSTM", params, {}).keys() == sd.keys()


# ------------------------------------------------- 5. the recipe
DIM = 12  # spliced (2 + 1 + 2) x 12 = 60, a multiple of 4
SPLITS = {"train": (64, 40, 80), "dev": (16, 40, 60), "test": (6, 30, 90)}
SHRINK = {
    "lstm_lay = 1024,1024": "lstm_lay = 16,16",
    "lstm_drop = 0.2,0.2": "lstm_drop = 0.0,0.0",
    "n_epochs_tr = 24": "n_epochs_tr = 2\nnr_of_valid_per_epoch = 2",
    "n_chunks = 5": "n_chunks = 2",
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_kaldi_tree(str(tmp_path_factory.mktemp("dirha")), DIM,
                            n_phones=3, n_pdfs=9, splits=SPLITS, corpus="DIRHA")


def _infos(out):
    ef = os.path.join(out, "exp_files")
    return {f: os.path.join(ef, f) for f in sorted(os.listdir(ef))
            if f.endswith(".info") and not f.startswith("forward_")}


def _log_lines(out, tag):
    with open(os.path.join(out, "log.log")) as f:
        return [line for line in f if tag in line]


def _ark(out):
    ef = os.path.join(out, "exp_files")
    name = [f for f in os.listdir(ef) if f.endswith("_to_decode.ark")]
    assert len(name) == 1
    return dict(read_mat_ark(os.path.join(ef, name[0])))


def test_dirha_recipe_training_run_matches_tpukaldi(tree, tmp_path):
    """cfg/DIRHA/QLSTM_mfcc.cfg, shrunk to 2x16 at drop 0, trained for 2
    epochs of 2 chunks by tpukaldi and by the port (CPU, `auto`: the
    float32 recurrence on both sides) from the same seeded initial weights:
    per-chunk loss and err in the .info ledger within 1e-3 absolute
    (float32 over 8 rmsprop steps; the loss is ~2), the same new-bob
    decisions and lr entries in res.res, and the forward arks within 1e-3
    absolute (log-posteriors minus log-priors, order 10)."""
    outs, init = {}, None
    for side in ("tpk", "port"):
        out = str(tmp_path / side)
        os.makedirs(out)
        cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"), SHRINK,
                              recipe=recipe_cfg("QLSTM"))
        if init is None:
            init = save_seeded_init(cfg, DIM, str(tmp_path / "init"))
        outs[side] = (out, cfg)
    tpk_run_experiment(outs["tpk"][1], overrides=init)
    before = (chunk_runtime.train_batches, chunk_runtime.valid_batches)
    run_experiment(outs["port"][1], overrides=init, device="cpu")
    # 2 epochs x 2 chunks x 32 utterances in batches of 16; 2 x 2 valid
    # points x 16 dev utterances
    assert (chunk_runtime.train_batches - before[0],
            chunk_runtime.valid_batches - before[1]) == (8, 4)

    out_tpk, out_port = outs["tpk"][0], outs["port"][0]
    want, got = _infos(out_tpk), _infos(out_port)
    assert list(got) == list(want) and len(want) == 2 * (2 + 2)
    for name in want:
        w, g = tpk_read_info(want[name]), chunk_runtime.read_info(got[name])
        for key in ("loss", "err", "frames"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-3,
                                       err_msg=f"{name} {key}")
    assert _log_lines(out_port, "[new-bob]") == _log_lines(out_tpk, "[new-bob]")
    res = {}
    for side, out in (("tpk", out_tpk), ("port", out_port)):
        with open(os.path.join(out, "res.res")) as f:
            res[side] = [[w for w in line.split() if w.startswith("lr_")]
                         for line in f if line.startswith("ep=")]
    assert len(res["tpk"]) == 2 and all(res["tpk"]) and res["port"] == res["tpk"]

    ark_tpk, ark_port = _ark(out_tpk), _ark(out_port)
    assert sorted(ark_port) == sorted(ark_tpk)
    assert len(ark_tpk) == SPLITS["test"][0]
    for key, want_post in ark_tpk.items():
        assert ark_port[key].shape == want_post.shape == (want_post.shape[0], 9)
        np.testing.assert_allclose(ark_port[key], want_post, rtol=0, atol=1e-3,
                                   err_msg=key)


def test_dirha_prod_cfg(tree, tmp_path):
    """The production variant: a DIRHA_prod dataset with lab_name=none over
    the test features, forwarded with it, the recipe's paths pointed at the
    tree."""
    cfg = write_prod_cfg(tree, str(tmp_path / "out"), str(tmp_path / "p.cfg"),
                         recipe=recipe_cfg("QLSTM"))
    text = open(cfg).read()
    assert "data_name = DIRHA_prod" in text
    assert "forward_with = DIRHA_prod" in text
    assert "$KALDI_DIRHA" not in text
    assert f"lab_data_folder={tree}/data/test/" in text
    prod = text[text.index("[dataset4]"):text.index("[data_use]")]
    assert "lab = lab_name=none" in prod and "lab_folder" not in prod


# ------------------------------------------------- 6. knobs and the card
def test_registry_resolves_qlstm():
    for lib in ("tpukaldi.models", "tpukaldi_torch.models", "neural_networks"):
        assert resolve("QLSTM", lib) is QLSTM


def test_quaternion_widths_must_divide_by_four():
    with pytest.raises(ValueError, match="multiples of 4"):
        QLSTM(_opts(), 10)


@pytest.mark.parametrize("impl", ["auto", "scan", "pallas"])
def test_qlstm_train_step_on_cpu_counts_no_launch(impl):
    """A train-mode forward and backward on CPU tensors, through the
    float32 Function (auto, scan), the bf16-U Function (pallas) or the
    plain loop (a relu layer), reaches every parameter and counts no kernel
    launch."""
    counters = ("launches", "bwd_launches", "lean_launches",
                "lean_bwd_launches")
    before = [getattr(port_lstm, c) for c in counters]
    module = QLSTM(_opts(impl, lstm_act="tanh,relu"), D)
    module.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((9, 3, D)).astype(np.float32))
    out = module(x, generator=torch.Generator().manual_seed(3))
    out.square().sum().backward()
    assert all(p.grad is not None for p in module.parameters())
    assert [getattr(port_lstm, c) for c in counters] == before


def test_reset_parameters_is_seeded():
    """The same generator seed gives the same weights; another seed others."""
    a, b, c = (QLSTM(_opts(), D) for _ in range(3))
    for m, seed in ((a, 1), (b, 1), (c, 2)):
        m.reset_parameters(torch.Generator().manual_seed(seed))
    for (name, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(p, q), name
        if name.endswith("_weight"):
            assert not torch.equal(p, r), name


@pytest.mark.cuda
@pytest.mark.parametrize("T, B, H", [(41, 6, 64)] + LEAN_SHAPES + [
    pytest.param(6, 136, 16, id="T6-B136-H16-two-passes")])
def test_lean_kernels_match_plain_on_card(T, B, H):
    """K4f and K4b against their plain versions on the same card at small
    shapes, the edges of K4f's tiling and a batch of two passes (over 128
    rows) among them.  1e-4 absolute on h, c, dff and dmask, 1e-4 relative
    to the max on dU: both round to the same bf16 operands, but the float32
    sums run in other orders, and an operand that lands on a rounding tie
    moves its step by 2^-8 of h.  Two K4f calls, and two K4b calls, on the
    same inputs give the same bits (their sums run in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    ff, u, mask, g = (torch.from_numpy(x).cuda()
                      for x in _lstm_inputs(T, B, H, seed=2))
    before = (port_lstm.lean_launches, port_lstm.lean_bwd_launches)
    got_f = port_lstm.lstm_recurrence_lean(ff, u, mask)
    again = port_lstm.lstm_recurrence_lean(ff, u, mask)
    assert all(torch.equal(a, b) for a, b in zip(got_f, again))
    want_f = port_lstm.lstm_recurrence_lean_ref(ff, u, mask)
    got_b = port_lstm.lstm_recurrence_lean_bwd(ff, *got_f, g, u, mask)
    again = port_lstm.lstm_recurrence_lean_bwd(ff, *got_f, g, u, mask)
    assert all(torch.equal(a, b) for a, b in zip(got_b, again))
    want_b = port_lstm.lstm_recurrence_lean_bwd_ref(ff, *got_f, g, u, mask)
    torch.cuda.synchronize()
    assert (port_lstm.lean_launches, port_lstm.lean_bwd_launches) == (
        before[0] + 2, before[1] + 2)
    for a, b in zip(got_f, want_f):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    for name, a, b in zip(("dff", "du", "dmask"), got_b, want_b):
        atol = 1e-4 * (b.abs().max().item() if name == "du" else 1.0)
        torch.testing.assert_close(a, b, rtol=0, atol=atol, msg=name)
