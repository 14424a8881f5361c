"""The port's LSTM and GRU (tpukaldi_torch/kernels/{lstm,gru}.py and their
cells in tpukaldi_torch/models/recurrent.py) against tpukaldi's, on the CPU
at small sizes.

- (a) The recurrences: the plain forward loops, the plain reverse-time
  loops (what the CUDA kernels K2f/K2b and K3f/K3b are held to on a card)
  and the autograd Functions, against tpukaldi's Pallas kernels in
  interpret mode (forward, and backward through `jax.vjp`), its lax.scan
  forwards and its `_bwd_scan`s.
- (b) The `LSTM` and `GRU` modules against the flax modules with the same
  weights, with and without `lengths`; (c) the weight converter both ways.
- (d) One train step and one eval step of a shrunk LSTM and a shrunk GRU
  graph against tpukaldi's.
- (e) A 2-epoch shrunk run of each recipe (cfg/TIMIT/LSTM_fmllr.cfg,
  GRU_fmllr.cfg) through tpukaldi's `run_experiment` and the port's from
  the same initial weights.
- (f) The registry, the `*_impl` knobs and the launch counters; (g) the
  kernels against their plain versions on a card (skipped without one).

Inputs come from numpy with a seed; dropout is 0 wherever the two sides
are compared in training, since torch cannot draw JAX's threefry bits.
Each tolerance is stated where it is used.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.compat.torch_import import import_model_par
from tpukaldi.io import read_mat_ark
from tpukaldi.kernels import gru as jax_gru
from tpukaldi.kernels import lstm as jax_lstm
from tpukaldi.models.recurrent import GRU as JaxGRU
from tpukaldi.models.recurrent import LSTM as JaxLSTM
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi.train.chunk_runtime import read_info as tpk_read_info
from tpukaldi_torch.kernels import gru as port_gru
from tpukaldi_torch.kernels import lstm as port_lstm
from tpukaldi_torch.models import GRU, LSTM, resolve
from tpukaldi_torch.tools.flagship_tree import (
    recipe_cfg,
    save_seeded_init,
    write_kaldi_tree,
    write_train_cfg,
)
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train import chunk_runtime
from torch_port_helpers import (
    assert_trees_equal,
    check_train_and_eval_step,
    jax_init,
    port_module,
    recipe_exp,
)

# float32 on both sides with the same operations per step, the recurrent
# products summed in another order: the last bits move, over <= 37 steps
ATOL = 1e-5


# ------------------------------------------------------------ (a) kernels
def _lstm_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    ff = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    u = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    # mask != 1: train-style Bernoulli rows scaled like the eval (1-p) factor
    mask = ((rng.random((B, H)) < 0.8) * 0.8).astype(np.float32)
    g = rng.standard_normal((T, B, H)).astype(np.float32)
    return ff, u, mask, g


def _gru_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    ff = rng.standard_normal((T, B, 3 * H)).astype(np.float32)
    uzr = (rng.standard_normal((H, 2 * H)) / np.sqrt(H)).astype(np.float32)
    uh = (rng.standard_normal((H, H)) / np.sqrt(H)).astype(np.float32)
    mask = ((rng.random((B, H)) < 0.8) * 0.8).astype(np.float32)
    g = rng.standard_normal((T, B, H)).astype(np.float32)
    return ff, uzr, uh, mask, g


def _assert_grads(got, want_pallas, want_scan, names, du_names):
    """dff and dmask to ATOL absolute; the weight gradients, sums over T*B
    rows taken in another order, to ATOL relative to their max."""
    for name, a, wp, ws in zip(names, got, want_pallas, want_scan):
        a = a.detach().numpy()
        wp, ws = np.asarray(wp), np.asarray(ws)
        atol = ATOL * (np.abs(ws).max() if name in du_names else 1.0)
        assert a.shape == wp.shape == ws.shape, name
        np.testing.assert_allclose(a, wp, rtol=0, atol=atol, err_msg=name)
        np.testing.assert_allclose(a, ws, rtol=0, atol=atol, err_msg=name)


# T not a multiple of the Pallas blocks (4 and 16 for the LSTM, 8 and 16 for
# the GRU), so their padded time steps are exercised on tpukaldi's side
@pytest.mark.parametrize("T,B", [(13, 2), (37, 6)])
def test_lstm_recurrence_matches_jax(T, B):
    """h and c of the forward; dff, dU and dmask of the backward."""
    H = 16
    ff, u, mask, g = _lstm_inputs(T, B, H, seed=T * 10 + B)
    j = [jnp.asarray(x) for x in (ff, u, mask)]
    h_p, c_p = jax_lstm._lstm_pallas_fwd_impl(*j, interpret=True)
    h_s = jax_lstm.lstm_recurrence_scan(*j)
    h_v, vjp = jax.vjp(lambda a, b, c: jax_lstm.lstm_recurrence(a, b, c, True),
                       *j)
    want_pallas = vjp(jnp.asarray(g))
    want_scan = jax_lstm._bwd_scan(True, (*j, h_p, c_p), jnp.asarray(g))

    t = [torch.from_numpy(x) for x in (ff, u, mask, g)]
    h, c = port_lstm.lstm_recurrence_ref(*t[:3])
    for got, want in ((h, h_p), (h, h_s), (h, h_v), (c, c_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    got_ref = port_lstm.lstm_recurrence_bwd_ref(
        t[0], torch.from_numpy(np.array(h_p)), torch.from_numpy(np.array(c_p)),
        t[3], t[1], t[2])
    ff_t, u_t, mask_t = (x.clone().requires_grad_() for x in t[:3])
    (port_lstm.LSTMRecurrence.apply(ff_t, u_t, mask_t) * t[3]).sum().backward()
    for got in (got_ref, (ff_t.grad, u_t.grad, mask_t.grad)):
        _assert_grads(got, want_pallas, want_scan, ("dff", "du", "dmask"),
                      ("du",))


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("T,B", [(13, 2), (37, 6)])
def test_gru_recurrence_matches_jax(T, B, act):
    """h of the forward; dff, dUzr, dUh and dmask of the backward."""
    H = 16
    ff, uzr, uh, mask, g = _gru_inputs(T, B, H, seed=T * 10 + B)
    j = [jnp.asarray(x) for x in (ff, uzr, uh, mask)]
    h_p, vjp = jax.vjp(
        lambda a, b, c, d: jax_gru.gru_recurrence(a, b, c, d, act, True), *j)
    h_s = jax_gru.gru_recurrence_scan(*j, act)
    want_pallas = vjp(jnp.asarray(g))
    want_scan = jax_gru._bwd_scan(act, True, (*j, h_p), jnp.asarray(g))

    t = [torch.from_numpy(x) for x in (ff, uzr, uh, mask, g)]
    h = port_gru.gru_recurrence_ref(*t[:4], act)
    for want in (h_p, h_s):
        np.testing.assert_allclose(h.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    got_ref = port_gru.gru_recurrence_bwd_ref(
        t[0], torch.from_numpy(np.array(h_p)), t[4], t[1], t[2], t[3], act)
    leaves = [x.clone().requires_grad_() for x in t[:4]]
    (port_gru.GRURecurrence.apply(*leaves, act) * t[4]).sum().backward()
    for got in (got_ref, [x.grad for x in leaves]):
        _assert_grads(got, want_pallas, want_scan,
                      ("dff", "duzr", "duh", "dmask"), ("duzr", "duh"))


def _function_and_plain(cell):
    """(Function, plain loop, its inputs, the gradient g of h)."""
    if cell == "lstm":
        ff, u, mask, g = _lstm_inputs(21, 3, 8, seed=3)
        return (port_lstm.LSTMRecurrence.apply,
                lambda *a: port_lstm.lstm_recurrence_ref(*a)[0],
                [torch.from_numpy(x) for x in (ff, u, mask)], g)
    act = cell.split("_")[1]
    ff, uzr, uh, mask, g = _gru_inputs(21, 3, 8, seed=3)
    return (lambda *a: port_gru.GRURecurrence.apply(*a, act),
            lambda *a: port_gru.gru_recurrence_ref(*a, act),
            [torch.from_numpy(x) for x in (ff, uzr, uh, mask)], g)


@pytest.mark.parametrize("cell", ["lstm", "gru_relu", "gru_tanh"])
def test_function_matches_autograd_through_plain_loop(cell):
    """The Function's gradients of every input against autograd through the
    plain forward loop (what `*_impl = scan` trains with); ATOL: the same
    float32 operations, summed in other orders."""
    fn, plain, inputs, g = _function_and_plain(cell)
    grads = []
    for f in (fn, plain):
        leaves = [x.clone().requires_grad_() for x in inputs]
        (f(*leaves) * torch.from_numpy(g)).sum().backward()
        grads.append([x.grad for x in leaves])
    for x, y in zip(*grads):
        torch.testing.assert_close(x, y, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cell", ["lstm", "gru_relu"])
def test_cpu_paths_count_no_launch(cell):
    """On CPU tensors the wrappers run the plain versions: no launch is
    counted, forward or backward."""
    mod = port_lstm if cell == "lstm" else port_gru
    before = (mod.launches, mod.bwd_launches)
    fn, _, inputs, g = _function_and_plain(cell)
    inputs[0].requires_grad_()
    (fn(*inputs) * torch.from_numpy(g)).sum().backward()
    assert (mod.launches, mod.bwd_launches) == before


# ------------------------------------------------------------ (b), (c) modules
D = 10
COMMON = dict(use_laynorm_inp="False", use_batchnorm_inp="False",
              bidir="True", orthinit="True")
CELL_OPTS = {
    # the recipe's layer kind: batchnorm, tanh, recurrent dropout 0.2
    "recipe": dict(COMMON, lay="16,16", drop="0.2,0.2",
                   use_batchnorm="True,True", use_laynorm="False,False",
                   act="tanh,tanh"),
    # the plain-loop path: biases, laynorm on h, a relu LSTM / leaky_relu
    # GRU, input ln and bn, uniform recurrent init
    "plain_loop": dict(lay="16,12", drop="0.1,0.0",
                       use_batchnorm="False,False", use_laynorm="True,False",
                       use_laynorm_inp="True", use_batchnorm_inp="True",
                       bidir="True", orthinit="False"),
}
PLAIN_ACTS = {"LSTM": "tanh,relu", "GRU": "relu,leaky_relu"}
CLASSES = {"LSTM": (JaxLSTM, LSTM), "GRU": (JaxGRU, GRU)}


def _opts(cls_name, name, **extra):
    opts = dict(CELL_OPTS[name], **extra)
    if name == "plain_loop":
        opts["act"] = PLAIN_ACTS[cls_name]
    prefix = cls_name.lower()
    return {f"{prefix}_{k}": v for k, v in opts.items()}


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("name", list(CELL_OPTS))
@pytest.mark.parametrize("cls_name", list(CLASSES))
def test_cell_matches_flax(cls_name, name, with_lengths):
    """Eval-mode outputs to ATOL absolute (order 1)."""
    jcls, pcls = CLASSES[cls_name]
    opts = _opts(cls_name, name)
    rng = np.random.default_rng(3)
    T, B = 11, 3
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    lengths = np.array([11, 7, 4], np.int64) if with_lengths else None
    jmod, params, stats = jax_init(jcls, opts, np.zeros((4, 2, D), np.float32), 5)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    want = np.asarray(jmod.apply(
        variables, jnp.asarray(x), train=False,
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32)))
    port = port_module(pcls, opts, D, params, stats, cls_name)
    with torch.inference_mode():
        got = port(torch.from_numpy(x),
                   lengths=None if lengths is None else torch.from_numpy(lengths))
    assert got.shape == want.shape == (T, B, port.out_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(CELL_OPTS))
@pytest.mark.parametrize("cls_name", list(CLASSES))
def test_converter_round_trip(cls_name, name):
    """JAX params -> port state_dict (strict load) -> import_model_par ==
    JAX params, exactly; the state_dict has the reference's key names."""
    jcls, pcls = CLASSES[cls_name]
    opts = _opts(cls_name, name)
    _, params, stats = jax_init(jcls, opts, np.zeros((4, 2, D), np.float32), 11)
    port = port_module(pcls, opts, D, params, stats, cls_name)
    keys = set(port.state_dict())
    if cls_name == "LSTM":
        assert {"wfx.0.weight", "uch.1.weight"} <= keys
    else:
        assert {"wr.0.weight", "uh.1.weight", "ur.1.weight"} <= keys
    back_params, back_stats = import_model_par(port.state_dict(), cls_name)
    assert_trees_equal(back_params, params)
    assert_trees_equal(back_stats, stats)


# ------------------------------------------------------------ (d) one step
@pytest.mark.parametrize("cell", list(CLASSES))
def test_train_and_eval_step_match_tpukaldi(cell):
    """One train step and one eval step of the recipe program (a 2x8 cell,
    tanh) against tpukaldi's (`check_train_and_eval_step` states what is
    compared, and how close)."""
    check_train_and_eval_step(recipe_exp(cell, "tanh"))


# ------------------------------------------------------------ (e) runs
DIM = 10
SPLITS = {"train": (32, 40, 80), "dev": (8, 40, 60), "test": (6, 30, 90)}


def _shrink(cell):
    """The recipe cut to a 2x32 cell at drop 0 and 2 epochs of 2 chunks,
    validating after each chunk so epoch 0 already takes a new-bob
    decision."""
    p = cell.lower()
    five = lambda v: ",".join([v] * 5)  # noqa: E731
    return {
        f"{p}_lay = {five('550')}": f"{p}_lay = 32,32",
        f"{p}_drop = {five('0.2')}": f"{p}_drop = 0.0,0.0",
        f"{p}_use_laynorm = {five('False')}": f"{p}_use_laynorm = False,False",
        f"{p}_use_batchnorm = {five('True')}": f"{p}_use_batchnorm = True,True",
        f"{p}_act = {five('tanh')}": f"{p}_act = tanh,tanh",
        "n_epochs_tr = 24": "n_epochs_tr = 2\nnr_of_valid_per_epoch = 2",
        "increase_seq_length_train = True": "increase_seq_length_train = False",
        "n_chunks = 5": "n_chunks = 2",
    }


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_kaldi_tree(str(tmp_path_factory.mktemp("timit")), DIM,
                            n_phones=3, n_pdfs=9, splits=SPLITS)


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


@pytest.mark.parametrize("cell", list(CLASSES))
def test_recipe_training_run_matches_tpukaldi(cell, tree, tmp_path):
    """The recipe cfg, shrunk, trained for 2 epochs by tpukaldi and by the
    port (CPU) from the same seeded initial weights: per-chunk loss and err
    in the .info ledger within 1e-3 absolute (float32 on both sides over 8
    rmsprop steps; the loss is ~2-3), the same new-bob decisions and lr
    entries in res.res, and the forward arks within 1e-3 absolute
    (log-posteriors minus log-priors, order 10)."""
    outs, init = {}, None
    for side in ("tpk", "port"):
        out = str(tmp_path / side)
        os.makedirs(out)
        cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                              _shrink(cell), recipe=recipe_cfg(cell))
        if init is None:
            init = save_seeded_init(cfg, DIM, str(tmp_path / "init"))
        outs[side] = (out, cfg)
    tpk_run_experiment(outs["tpk"][1], overrides=init)
    before = (chunk_runtime.train_batches, chunk_runtime.valid_batches)
    run_experiment(outs["port"][1], overrides=init, device="cpu")
    # 2 epochs x 2 chunks x 16 utterances in batches of 8; 2 x 2 valid
    # points x 8 dev utterances
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


def test_recipe_cfg_replace_names_the_recipe(tree, tmp_path):
    """A replace= of a line the recipe lacks is refused, naming the recipe;
    an added `*_impl` line is what the plain-path variant needs."""
    with pytest.raises(ValueError, match="GRU_fmllr.cfg"):
        write_train_cfg(tree, str(tmp_path), str(tmp_path / "a.cfg"),
                        {"gru_impl = auto": "gru_impl = scan"},
                        recipe=recipe_cfg("GRU"))
    cfg = write_train_cfg(
        tree, str(tmp_path / "out"), str(tmp_path / "b.cfg"),
        {"gru_orthinit = True": "gru_orthinit = True\ngru_impl = scan"},
        recipe=recipe_cfg("GRU"))
    text = open(cfg).read()
    assert f"out_folder = {tmp_path / 'out'}\n" in text
    assert "gru_impl = scan" in text and "$KALDI_TIMIT" not in text


# ------------------------------------------------------------ (f) knobs
def test_registry_resolves_lstm_and_gru():
    for lib in ("tpukaldi.models", "tpukaldi_torch.models", "neural_networks"):
        assert resolve("LSTM", lib) is LSTM
        assert resolve("GRU", lib) is GRU


@pytest.mark.parametrize("cls_name", list(CLASSES))
def test_impl_pallas_refuses_cpu(cls_name):
    """`*_impl = pallas` asks for the hand kernel, which takes CUDA tensors
    only; a layer the kernel does not take (laynorm) runs the plain loop."""
    p = cls_name.lower()
    module = CLASSES[cls_name][1](_opts(cls_name, "recipe",
                                        impl="pallas"), D).eval()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        with torch.inference_mode():
            module(torch.zeros(3, 2, D))
    module = CLASSES[cls_name][1](
        _opts(cls_name, "recipe", impl="pallas",
              use_laynorm="True,True"), D).eval()
    with torch.inference_mode():
        assert module(torch.zeros(3, 2, D)).shape == (3, 2, 32)
    assert module.options[f"{p}_impl"] == "pallas"


@pytest.mark.parametrize("impl", ["auto", "scan"])
@pytest.mark.parametrize("cls_name", list(CLASSES))
def test_cell_train_step_on_cpu_counts_no_launch(cls_name, impl):
    """A train-mode forward and backward of a module on CPU tensors, through
    the Function (auto) or the plain loop (scan), reaches every parameter
    and counts no kernel launch."""
    mod = port_lstm if cls_name == "LSTM" else port_gru
    before = (mod.launches, mod.bwd_launches)
    torch.manual_seed(0)
    module = CLASSES[cls_name][1](_opts(cls_name, "recipe", impl=impl), D)
    module.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((9, 3, D)).astype(np.float32))
    module(x, generator=torch.Generator().manual_seed(3)).square().sum().backward()
    assert all(p.grad is not None for p in module.parameters())
    assert (mod.launches, mod.bwd_launches) == before


# ------------------------------------------------------------ (g) the card
@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru_relu", "gru_tanh"])
def test_kernels_match_plain_on_card(cell):
    """Each forward and backward kernel against its plain version on the
    same card.  1e-4 absolute on h, c, dff and dmask, 1e-4 relative to the
    max on the weight gradients: the kernels sum the recurrent products
    serially and the weight gradients in 16-row stages, cuBLAS in tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    if cell == "lstm":
        ff, u, mask, g = (torch.from_numpy(x).cuda()
                          for x in _lstm_inputs(41, 6, 64, seed=2))
        before = (port_lstm.launches, port_lstm.bwd_launches)
        got_f = port_lstm.lstm_recurrence(ff, u, mask)
        want_f = port_lstm.lstm_recurrence_ref(ff, u, mask)
        got_b = port_lstm.lstm_recurrence_bwd(ff, *want_f, g, u, mask)
        want_b = port_lstm.lstm_recurrence_bwd_ref(ff, *want_f, g, u, mask)
        names = ("dff", "du", "dmask")
        mod = port_lstm
    else:
        act = cell.split("_")[1]
        ff, uzr, uh, mask, g = (torch.from_numpy(x).cuda()
                                for x in _gru_inputs(41, 6, 64, seed=2))
        before = (port_gru.launches, port_gru.bwd_launches)
        got_f = (port_gru.gru_recurrence(ff, uzr, uh, mask, act),)
        want_f = (port_gru.gru_recurrence_ref(ff, uzr, uh, mask, act),)
        got_b = port_gru.gru_recurrence_bwd(ff, want_f[0], g, uzr, uh, mask,
                                            act)
        want_b = port_gru.gru_recurrence_bwd_ref(ff, want_f[0], g, uzr, uh,
                                                 mask, act)
        names = ("dff", "duzr", "duh", "dmask")
        mod = port_gru
    torch.cuda.synchronize()
    assert (mod.launches, mod.bwd_launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(got_f, want_f):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    for name, a, b in zip(names, got_b, want_b):
        atol = 1e-4 * (b.abs().max().item() if name.startswith("du") else 1.0)
        torch.testing.assert_close(a, b, rtol=0, atol=atol, msg=name)
