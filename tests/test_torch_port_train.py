"""The port's training path against tpukaldi's, on the CPU at small sizes.

- The liGRU backward: the port's plain reverse-time loop
  (`ligru_recurrence_bwd_ref`, what the CUDA kernel K1b is held to on the
  card) and the autograd Function around the recurrence, against `jax.vjp`
  of tpukaldi's `ligru_recurrence` (its Pallas backward in interpret mode)
  and its `_bwd_scan`.
- The batchnorm running statistics against flax's.
- One train step and one eval step of a shrunk flagship graph against
  tpukaldi's (`_loss_fn` gradients, `make_train_step`, `make_eval_step`).
- A 2-epoch shrunk flagship training run through tpukaldi's
  `run_experiment` and the port's from the same initial weights, and the
  port's standalone chunk runner against its in-process run.

Inputs come from numpy with a seed; dropout is 0 wherever the two sides
are compared, since torch cannot draw JAX's threefry bits.  Each tolerance
is stated where it is used.
"""

import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.io import read_mat_ark
from tpukaldi.kernels.ligru import _bwd_scan
from tpukaldi.kernels.ligru import ligru_recurrence as jax_ligru
from tpukaldi.models.common import make_batchnorm
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi.train.chunk_runtime import read_info as tpk_read_info
from tpukaldi.train.optimizers import make_optimizer
from tpukaldi_torch.kernels import ligru as port_ligru
from tpukaldi_torch.models import common
from tpukaldi_torch.tools.flagship_tree import (
    save_seeded_init,
    write_kaldi_tree,
    write_train_cfg,
)
from tpukaldi_torch.tools.run_chunk import run_chunk
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train import chunk_runtime
from torch_port_helpers import check_train_and_eval_step, recipe_exp


# ------------------------------------------------------------ (a) K1b
def _recurrence_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    ff = rng.standard_normal((T, B, 2 * H)).astype(np.float32)
    u = (rng.standard_normal((H, 2 * H)) / np.sqrt(H)).astype(np.float32)
    # mask != 1: train-style Bernoulli rows scaled like the eval (1-p) factor
    mask = ((rng.random((B, H)) < 0.8) * 0.8).astype(np.float32)
    g = rng.standard_normal((T, B, H)).astype(np.float32)
    return ff, u, mask, g


@pytest.mark.parametrize("T,B", [(13, 2), (37, 6)])
def test_ligru_backward_matches_jax(T, B):
    """T not a multiple of the Pallas time block (16), mask != 1; dff, dU
    and dmask.  1e-5 absolute on dff and dmask (float32, the same operations
    per step, h_prev @ U summed in another order), 1e-5 relative to max|dU|
    on dU, a sum over T*B rows taken in another order."""
    H = 16
    ff, u, mask, g = _recurrence_inputs(T, B, H, seed=T * 7 + B)
    h, vjp = jax.vjp(lambda a, b, c: jax_ligru(a, b, c, True),
                     jnp.asarray(ff), jnp.asarray(u), jnp.asarray(mask))
    want_pallas = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    want_scan = [np.asarray(x) for x in _bwd_scan(
        True, (jnp.asarray(ff), jnp.asarray(u), jnp.asarray(mask), h),
        jnp.asarray(g))]

    t = [torch.from_numpy(x) for x in (ff, u, mask, g)]
    got_ref = port_ligru.ligru_recurrence_bwd_ref(
        t[0], torch.from_numpy(np.array(h)), t[3], t[1], t[2])
    ff_t, u_t, mask_t = (x.clone().requires_grad_() for x in t[:3])
    h_t = port_ligru.LiGRURecurrence.apply(ff_t, u_t, mask_t)
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h), atol=1e-5)
    (h_t * t[3]).sum().backward()
    got_fn = (ff_t.grad, u_t.grad, mask_t.grad)

    for got in (got_ref, got_fn):
        for name, a, wp, ws in zip(("dff", "du", "dmask"), got, want_pallas,
                                   want_scan):
            atol = 1e-5 * (np.abs(ws).max() if name == "du" else 1.0)
            a = a.detach().numpy()
            assert a.shape == wp.shape, name
            np.testing.assert_allclose(a, wp, rtol=0, atol=atol, err_msg=name)
            np.testing.assert_allclose(a, ws, rtol=0, atol=atol, err_msg=name)


def test_ligru_function_matches_autograd_through_plain_loop():
    """The Function's gradients against autograd through the plain forward
    loop (what `ligru_impl = scan` trains with); 1e-5 absolute: the same
    float32 operations, summed in other orders."""
    ff, u, mask, g = (torch.from_numpy(x)
                      for x in _recurrence_inputs(21, 3, 8, seed=3))
    grads = []
    for fn in (port_ligru.LiGRURecurrence.apply,
               port_ligru.ligru_recurrence_ref):
        a, b = ff.clone().requires_grad_(), u.clone().requires_grad_()
        (fn(a, b, mask) * g).sum().backward()
        grads.append((a.grad, b.grad))
    for x, y in zip(*grads):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)


def test_ligru_cpu_backward_counts_no_launch():
    before = (port_ligru.launches, port_ligru.bwd_launches)
    ff, u, mask, g = (torch.from_numpy(x)
                      for x in _recurrence_inputs(5, 2, 8, seed=1))
    ff.requires_grad_()
    (port_ligru.LiGRURecurrence.apply(ff, u, mask) * g).sum().backward()
    assert (port_ligru.launches, port_ligru.bwd_launches) == before


@pytest.mark.cuda
def test_ligru_backward_kernel_matches_plain_on_card():
    """K1b against its plain version on the same card.  dff and dmask to
    1e-5 absolute, dU to 1e-5 relative to max|dU|: the kernel sums h_prev @
    U and dA @ U^T serially and dU in 16-row stages, cuBLAS in tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    ff, u, mask, g = (torch.from_numpy(x).cuda()
                      for x in _recurrence_inputs(41, 6, 64, seed=2))
    h = port_ligru.ligru_recurrence_ref(ff, u, mask)
    before = port_ligru.bwd_launches
    got = port_ligru.ligru_recurrence_bwd(ff, h, g, u, mask)
    want = port_ligru.ligru_recurrence_bwd_ref(ff, h, g, u, mask)
    torch.cuda.synchronize()
    assert port_ligru.bwd_launches == before + 1
    for name, a, b in zip(("dff", "du", "dmask"), got, want):
        atol = 1e-5 * (b.abs().max().item() if name == "du" else 1.0)
        torch.testing.assert_close(a, b, rtol=0, atol=atol, msg=name)


# ------------------------------------------------------------ (b) batchnorm
def test_batchnorm_running_stats_match_flax():
    """One train-mode pass on a (64, 5) input: output and updated running
    mean/var against tpukaldi's `make_batchnorm` (flax, momentum 0.95),
    which folds the *biased* batch variance into `var`.  1e-6 absolute
    (float32 moments); torch's own BatchNorm1d is off by the factor 64/63
    in the variance's batch term (3.6e-3 here)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((64, 5)) * 2.0 + 0.5).astype(np.float32)
    mean0 = rng.normal(0, 0.3, 5).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(0, 0.3, 5).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = make_batchnorm(False).apply(variables, jnp.asarray(x),
                                            mutable=["batch_stats"])
    bn = common.batchnorm(5)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    for key, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=0, atol=1e-6, err_msg=key)


# ------------------------------------------------------------ (d) one step
@pytest.mark.parametrize("freeze_mono", [False, True])
def test_train_and_eval_step_match_tpukaldi(freeze_mono):
    """One train step and one eval step of the flagship program (a 2x8
    liGRU, relu) against tpukaldi's, with the mono head frozen or not
    (`check_train_and_eval_step` states what is compared, and how close)."""
    check_train_and_eval_step(recipe_exp("liGRU", "relu", freeze_mono))


# ------------------------------------------------------------ (f), (g) runs
DIM = 10
SPLITS = {"train": (32, 40, 80), "dev": (8, 40, 60), "test": (6, 30, 90)}
TRAIN_SHRINK = {
    "ligru_lay = 550,550,550,550,550": "ligru_lay = 32,32",
    "ligru_drop = 0.2,0.2,0.2,0.2,0.2": "ligru_drop = 0.0,0.0",
    "ligru_use_laynorm = False,False,False,False,False":
        "ligru_use_laynorm = False,False",
    "ligru_use_batchnorm = True,True,True,True,True":
        "ligru_use_batchnorm = True,True",
    "ligru_act = relu,relu,relu,relu,relu": "ligru_act = relu,relu",
    # validation after each of the 2 train chunks, so epoch 0 already takes
    # a new-bob decision
    "n_epochs_tr = 24": "n_epochs_tr = 2\nnr_of_valid_per_epoch = 2",
    "increase_seq_length_train = True": "increase_seq_length_train = False",
    "n_chunks = 5": "n_chunks = 2",
}


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The same 2-epoch run through tpukaldi and through the port (CPU)."""
    root = tmp_path_factory.mktemp("train")
    tree = write_kaldi_tree(str(root / "timit"), DIM, n_phones=3, n_pdfs=9,
                            splits=SPLITS)
    outs = {}
    init = None
    for side in ("tpk", "port"):
        out = str(root / side)
        os.makedirs(out)
        cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"),
                              TRAIN_SHRINK)
        if init is None:
            init = save_seeded_init(cfg, DIM, str(root / "init"))
        outs[side] = (out, cfg)
    tpk_run_experiment(outs["tpk"][1], overrides=init)
    counts = (chunk_runtime.train_batches, chunk_runtime.valid_batches)
    run_experiment(outs["port"][1], overrides=init, device="cpu")
    counts = (chunk_runtime.train_batches - counts[0],
              chunk_runtime.valid_batches - counts[1])
    return outs["tpk"][0], outs["port"][0], counts


def _infos(out):
    ef = os.path.join(out, "exp_files")
    return {f: os.path.join(ef, f) for f in sorted(os.listdir(ef))
            if f.endswith(".info") and not f.startswith("forward_")}


def _res_lines(out):
    with open(os.path.join(out, "res.res")) as f:
        return [line.split() for line in f if line.startswith("ep=")]


def test_training_run_matches_tpukaldi(train_runs):
    """Per-chunk loss and err in the .info ledger within 1e-3 absolute
    (float32 on both sides over 8 rmsprop steps; the loss is ~2-3), the same
    new-bob decisions and lr entries in res.res, and the forward arks
    within 1e-3 absolute (log-posteriors minus log-priors, order 10)."""
    out_tpk, out_port, (n_train, n_valid) = train_runs
    want, got = _infos(out_tpk), _infos(out_port)
    assert list(got) == list(want) and len(want) == 2 * (2 + 2)
    for name in want:
        w, g = tpk_read_info(want[name]), chunk_runtime.read_info(got[name])
        for key in ("loss", "err", "frames"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-3,
                                       err_msg=f"{name} {key}")
    # 2 epochs x 2 chunks x 16 utterances in batches of 8; 2 x 2 valid
    # points x 8 dev utterances
    assert (n_train, n_valid) == (8, 4)

    lines_tpk, lines_port = _res_lines(out_tpk), _res_lines(out_port)
    assert len(lines_port) == len(lines_tpk) == 2
    for lt, lp in zip(lines_tpk, lines_port):
        lrs = [f for f in lt if f.startswith("lr_")]
        assert lrs and lrs == [f for f in lp if f.startswith("lr_")]
    with open(os.path.join(out_tpk, "log.log")) as f:
        newbob_tpk = [line for line in f if "[new-bob]" in line]
    with open(os.path.join(out_port, "log.log")) as f:
        newbob_port = [line for line in f if "[new-bob]" in line]
    assert newbob_port == newbob_tpk
    with open(os.path.join(out_port, "res.res")) as f:
        assert len(re.findall(r"^phases ep=\d", f.read(), re.M)) == 2

    arks = {}
    for side, out in (("tpk", out_tpk), ("port", out_port)):
        ef = os.path.join(out, "exp_files")
        name = [f for f in os.listdir(ef) if f.endswith("_to_decode.ark")]
        assert len(name) == 1
        arks[side] = dict(read_mat_ark(os.path.join(ef, name[0])))
    assert sorted(arks["port"]) == sorted(arks["tpk"])
    assert len(arks["tpk"]) == SPLITS["test"][0]
    for key, want_post in arks["tpk"].items():
        assert arks["port"][key].shape == want_post.shape == (
            want_post.shape[0], 9)
        np.testing.assert_allclose(arks["port"][key], want_post, rtol=0,
                                   atol=1e-3, err_msg=key)


def test_training_checkpoints_load_in_tpukaldi(train_runs, capsys):
    """The port's last train checkpoints carry rmsprop's state in tpukaldi's
    layout: tpukaldi's `load_checkpoint` restores it into its own
    optimizer's template without restarting the optimizer."""
    from tpukaldi.train.checkpoint import load_checkpoint

    _, out_port, _ = train_runs
    ef = os.path.join(out_port, "exp_files")
    path = os.path.join(ef, "train_TIMIT_tr_ep1_ck1_liGRU_layers.ckpt")
    exp = SimpleNamespace(name="liGRU_layers", options={}, lr=[4e-4],
                          optimizer=SimpleNamespace(kind="rmsprop", options={
                              "opt_alpha": 0.95, "opt_eps": 1e-8}))
    template_params, _, _ = load_checkpoint(path)
    template = make_optimizer(exp).init(template_params)
    _, opt_state, _ = load_checkpoint(path, template_params, template)
    assert "restarting the optimizer" not in capsys.readouterr().err
    assert int(opt_state.count) == 8  # 2 epochs x 2 chunks x 2 batches
    nu = opt_state.inner_state[0].nu
    assert set(nu) == set(template_params)
    assert all(np.asarray(v).any() for v in jax.tree_util.tree_leaves(nu))


def _results(path):
    with open(path) as f:
        return dict(re.findall(r"(\w+)=(\S+)", f.read()))


def test_run_chunk_matches_in_process_run(train_runs):
    """`tools/run_chunk.py` re-executes planner-written chunk cfgs of the
    port's run: a train chunk (restoring the previous chunk's weights and
    optimizer state, then stepping) and a valid chunk reproduce the
    in-process ledger entries bit for bit, and the train chunk writes its
    checkpoints again."""
    _, out_port, _ = train_runs
    ef = os.path.join(out_port, "exp_files")
    for base in ("train_TIMIT_tr_ep1_ck1", "valid_TIMIT_dev_ep1_trCk1_ck0"):
        info = os.path.join(ef, base + ".info")
        want = _results(info)
        os.remove(info)
        ckpts = [f for f in os.listdir(ef)
                 if f.startswith(base) and f.endswith(".ckpt")]
        for f in ckpts:
            os.remove(os.path.join(ef, f))
        assert run_chunk(os.path.join(ef, base + ".cfg"), "cpu") == info
        got = _results(info)
        assert (got["loss"], got["err"]) == (want["loss"], want["err"])
        assert all(os.path.exists(os.path.join(ef, f)) for f in ckpts)
