"""The port's per-architecture optimizers (tpukaldi_torch/train/optimizers.py)
against tpukaldi's optax chains (`tpukaldi.train.optimizers.make_optimizer`),
and their state in checkpoints, both directions.

Each kind takes the same gradients (numpy, seeded) for several steps on the
same weights (a bidirectional liGRU layer with batchnorm, so the moments
pass through the per-gate <-> fused batchnorm map).  The weights must agree
within 1e-6 absolute after 5 steps of lr 0.05: float32 on both sides, the
same update formula evaluated in other orders; the optimizer state, in tpukaldi's
checkpoint layout, within the same bound or 1e-6 relative (a centred
rmsprop's momentum trace reaches ~10 where a gradient's centred variance
is small).  Adam gets 1e-5:
optax forms its bias corrections 1 - b^t in float32, torch in float64, and
at b2 = 0.999 the float32 difference cancels to a relative error of ~1e-5
in 1 - b2, ~6e-6 in the update's denominator.
"""

from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from tpukaldi.train.checkpoint import load_checkpoint, save_checkpoint
from tpukaldi.train.optimizers import make_optimizer
from tpukaldi_torch.compat.jax_params import (
    from_jax_params,
    moments_to_jax,
    to_jax_params,
)
from tpukaldi_torch.models import liGRU
from tpukaldi_torch.train.checkpoint import load_all, read_checkpoint, save_all
from tpukaldi_torch.train.optimizers import ArchOptimizer

LIGRU = dict(ligru_lay="6", ligru_drop="0.0", ligru_use_batchnorm="True",
             ligru_use_laynorm="False", ligru_act="relu", ligru_bidir="True",
             ligru_orthinit="True")
LR = 0.05


def _arch(kind, clip=None, **opts):
    return SimpleNamespace(
        name="rnn", lr=[LR], options={"arch_grad_clip": str(clip)} if clip else {},
        optimizer=SimpleNamespace(kind=kind, options=opts))


def _module(seed=0):
    module = liGRU(LIGRU, 4)
    module.reset_parameters(torch.Generator().manual_seed(seed))
    return module


def _grads(module, step):
    rng = np.random.default_rng(100 + step)
    return {n: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32) * 0.3)
        for n, p in module.named_parameters()}


def _to_tree(module, tensors):
    # copies: the map hands out numpy views of CPU tensors, which the
    # optimizers below update in place
    return jax.tree_util.tree_map(np.array, moments_to_jax(module, tensors))


def _assert_close(got, want, atol, path="", rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_close(got[k], want[k], atol, f"{path}/{k}", rtol)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, path
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)


def _run_both(arch, n_steps=5):
    module = _module()
    opt = ArchOptimizer(arch, module)
    tx = make_optimizer(arch)
    params = _to_tree(module, dict(module.named_parameters()))
    state = tx.init(params)
    for step in range(n_steps):
        grads = _grads(module, step)
        for name, p in module.named_parameters():
            p.grad = grads[name].clone()
        opt.step()
        updates, state = tx.update(_to_tree(module, grads), state, params)
        params = optax.apply_updates(params, updates)
    return module, opt, params, state


CASES = {
    "sgd": dict(),
    "sgd_momentum": dict(opt_momentum=0.9),
    "sgd_nesterov": dict(opt_momentum=0.9, opt_nesterov=True),
    "adam": dict(opt_betas=[0.8, 0.99], opt_eps=1e-7),
    "rmsprop": dict(opt_alpha=0.95, opt_eps=1e-8),
    "rmsprop_centered": dict(opt_alpha=0.9, opt_centered=True),
    "rmsprop_momentum": dict(opt_alpha=0.95, opt_momentum=0.5),
    "rmsprop_centered_momentum_wd": dict(opt_centered=True, opt_momentum=0.5,
                                         opt_weight_decay=0.01),
    "adam_wd": dict(opt_weight_decay=0.1),
    "sgd_momentum_clip": dict(opt_momentum=0.9, clip=0.5),
    "rmsprop_clip_not_reached": dict(clip=1e3),
    "none": dict(),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_tpukaldi(case):
    """Weights after 5 steps and the optimizer state (tpukaldi's layout)."""
    opts = dict(CASES[case])
    kind = case.split("_")[0]
    module, opt, want_params, want_state = _run_both(_arch(kind, **opts))
    got_params = _to_tree(module, dict(module.named_parameters()))
    atol = 1e-5 if kind == "adam" else 1e-6
    _assert_close(got_params, want_params, atol)
    want = serialization.to_state_dict(jax.device_get(want_state))
    _assert_close(opt.state_tree(), want, atol, rtol=1e-6)
    if kind == "none":
        _assert_close(got_params, _to_tree(_module(), dict(
            _module().named_parameters())), 0.0)


def test_amsgrad_and_dampening_raise():
    """amsgrad differs between optax and torch.optim and is not ported;
    dampening with momentum is refused as tpukaldi refuses it."""
    with pytest.raises(NotImplementedError, match="amsgrad"):
        ArchOptimizer(_arch("adam", opt_amsgrad=True), _module())
    with pytest.raises(ValueError, match="dampening"):
        make_optimizer(_arch("sgd", opt_momentum=0.9, opt_dampening=0.1))
    with pytest.raises(ValueError, match="dampening"):
        ArchOptimizer(_arch("sgd", opt_momentum=0.9, opt_dampening=0.1),
                      _module())


def test_set_lr_keeps_state():
    """set_lr changes the step size only (new-bob halving)."""
    arch = _arch("rmsprop", opt_alpha=0.95)
    module, opt, _, _ = _run_both(arch, n_steps=2)
    before = opt.state_tree()
    opt.set_lr(LR / 2)
    after = opt.state_tree()
    assert float(after["hyperparams"]["lr"]) == np.float32(LR / 2)
    _assert_close(after["inner_state"], before["inner_state"], 0.0)
    assert all(g["lr"] == LR / 2 for g in opt.opt.param_groups)


# --------------------------------------------------------- (e) checkpoints
def _stats_tree(module):
    _, stats = to_jax_params(module.state_dict(), type(module).__name__)
    return jax.tree_util.tree_map(np.asarray, stats)


@pytest.mark.parametrize("case", ["rmsprop", "adam", "sgd_momentum",
                                  "rmsprop_centered_momentum_wd"])
def test_port_checkpoint_restores_in_tpukaldi(case, tmp_path, capsys):
    """A port checkpoint after 3 steps: tpukaldi's `load_checkpoint` restores
    its optimizer state into the optax template without restarting the
    optimizer, bit for bit."""
    opts = dict(CASES[case])
    arch = _arch(case.split("_")[0], **opts)
    module, opt, _, want_state = _run_both(arch, n_steps=3)
    path = str(tmp_path / "port.ckpt")
    save_all({"rnn": path}, {"rnn": module}, {"rnn": opt})
    params = _to_tree(module, dict(module.named_parameters()))
    template = make_optimizer(arch).init(params)
    got_params, got_state, got_stats = load_checkpoint(
        path, params, template, _stats_tree(module))
    assert "restarting the optimizer" not in capsys.readouterr().err
    _assert_close(jax.device_get(got_params), params, 0.0)
    got = serialization.to_state_dict(jax.device_get(got_state))
    _assert_close(got, opt.state_tree(), 0.0)
    # and it continues as tpukaldi's own state would: one more step each
    grads = _to_tree(module, _grads(module, 9))
    tx = make_optimizer(arch)
    u_got, _ = tx.update(grads, got_state, params)
    u_want, _ = tx.update(grads, want_state, params)
    _assert_close(jax.device_get(u_got), jax.device_get(u_want), 1e-5)


@pytest.mark.parametrize("case", ["rmsprop", "adam", "sgd_nesterov",
                                  "rmsprop_centered_momentum_wd"])
def test_port_resumes_from_tpukaldi_checkpoint(case, tmp_path):
    """A tpukaldi checkpoint after 3 steps, read by the port: the weights,
    the moments and the step count come back, the lr stays the cfg's, and
    the next step matches tpukaldi's next step."""
    opts = dict(CASES[case])
    arch = _arch(case.split("_")[0], **opts)
    module, _, params, state = _run_both(arch, n_steps=3)
    path = str(tmp_path / "tpk.ckpt")
    save_checkpoint(path, params, state, _stats_tree(module))

    fresh = _module(seed=5)
    opt = ArchOptimizer(arch, fresh)
    opt.set_lr(LR / 4)  # the cfg's lr overrides the checkpoint's
    load_all({"rnn": path}, {"rnn": fresh}, {"rnn": opt})
    assert opt.count == 3
    tree = opt.state_tree()
    assert float(tree["hyperparams"]["lr"]) == np.float32(LR / 4)
    want = serialization.to_state_dict(jax.device_get(state))
    _assert_close(tree["inner_state"], want["inner_state"], 0.0)
    _assert_close(_to_tree(fresh, dict(fresh.named_parameters())), params, 0.0)

    grads = _grads(fresh, 7)
    for name, p in fresh.named_parameters():
        p.grad = grads[name].clone()
    opt.set_lr(LR)
    opt.step()
    tx = make_optimizer(arch)
    updates, _ = tx.update(_to_tree(fresh, grads), state, params)
    _assert_close(_to_tree(fresh, dict(fresh.named_parameters())),
                  optax.apply_updates(params, updates), 1e-5)


def test_checkpoint_of_another_optimizer_restarts(tmp_path, capsys):
    """An rmsprop state read into an adam optimizer is dropped with
    tpukaldi's warning; the weights still load."""
    module, _, params, state = _run_both(_arch("rmsprop"), n_steps=2)
    path = str(tmp_path / "rms.ckpt")
    save_checkpoint(path, params, state, _stats_tree(module))
    fresh = _module(seed=5)
    opt = ArchOptimizer(_arch("adam"), fresh)
    load_all({"rnn": path}, {"rnn": fresh}, {"rnn": opt})
    assert "restarting the optimizer" in capsys.readouterr().err
    assert opt.count == 0 and not opt.opt.state
    _, opt_state, _ = read_checkpoint(path)
    assert opt_state["count"] == 2
    sd = from_jax_params("liGRU", params, _stats_tree(module))
    for name, p in fresh.named_parameters():
        torch.testing.assert_close(p.detach(), sd[name], rtol=0, atol=0)
