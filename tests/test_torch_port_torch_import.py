"""The port's reference `.pkl` converter
(`tpukaldi_torch/compat/torch_import.py`) against tpukaldi's
(`tpukaldi/compat/torch_import.py::convert_checkpoint_file`).

Real pytorch-kaldi `.pkl` checkpoints are not in the repository, so each
case makes one from the port's own modules, which keep the reference
state_dict layout: an MLP, a bidirectional liGRU with batchnorm and a
QLSTM, after 3 `torch.optim` steps of rmsprop, adam or momentum sgd, saved
as the reference saves a chunk (`{"model_par", "optimizer_par"}`).

- Both converters' `.ckpt` files decode to equal trees (params, batch
  statistics, optimizer state), bit for bit.
- A port optimizer that resumes from the converted file takes the same
  next step as torch continuing from the pkl's state.
- Plain sgd (no momentum) writes no optimizer state; the CLI runs.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpukaldi.compat.torch_import import (
    convert_checkpoint_file as tpk_convert,
)
from tpukaldi_torch.compat.torch_import import convert_checkpoint_file
from tpukaldi_torch.models.mlp import MLP
from tpukaldi_torch.models.quaternion import QLSTM
from tpukaldi_torch.models.recurrent import liGRU
from tpukaldi_torch.train.checkpoint import load_all, read_checkpoint
from tpukaldi_torch.train.optimizers import ArchOptimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.01
MODELS = {
    "MLP": (MLP, {"dnn_lay": "12,5", "dnn_drop": "0.0,0.0",
                  "dnn_use_batchnorm": "True,False",
                  "dnn_use_laynorm": "False,False",
                  "dnn_use_laynorm_inp": "False",
                  "dnn_use_batchnorm_inp": "False",
                  "dnn_act": "relu,softmax"}, 8),
    "liGRU": (liGRU, {"ligru_lay": "8,8", "ligru_drop": "0.0,0.0",
                      "ligru_use_batchnorm": "True,True",
                      "ligru_use_laynorm": "False,False",
                      "ligru_act": "relu,relu", "ligru_bidir": "True",
                      "ligru_orthinit": "True"}, 6),
    "QLSTM": (QLSTM, {"lstm_lay": "8", "lstm_drop": "0.0",
                      "lstm_bidir": "True", "lstm_act": "tanh",
                      "quaternion_init": "quaternion", "autograd": "True"},
              8),
}
# kind -> (torch.optim class and its arguments, the cfg's optimizer)
OPTIMIZERS = {
    "rmsprop": (torch.optim.RMSprop, {"alpha": 0.95, "eps": 1e-8},
                {"opt_alpha": 0.95, "opt_eps": 1e-8, "opt_centered": False,
                 "opt_momentum": 0.0, "opt_weight_decay": 0.0}),
    "adam": (torch.optim.Adam, {"betas": (0.9, 0.999), "eps": 1e-8},
             {"opt_betas": [0.9, 0.999], "opt_eps": 1e-8,
              "opt_weight_decay": 0.0, "opt_amsgrad": False}),
    "sgd": (torch.optim.SGD, {"momentum": 0.9},
            {"opt_momentum": 0.9, "opt_nesterov": False,
             "opt_dampening": 0.0, "opt_weight_decay": 0.0}),
    "plain_sgd": (torch.optim.SGD, {},
                  {"opt_momentum": 0.0, "opt_nesterov": False,
                   "opt_dampening": 0.0, "opt_weight_decay": 0.0}),
}
CASES = [("MLP", "rmsprop"), ("liGRU", "adam"), ("QLSTM", "sgd"),
         ("liGRU", "rmsprop"), ("MLP", "adam")]


def _module(cls_name):
    cls, opts, dim = MODELS[cls_name]
    module = cls(opts, dim)
    module.reset_parameters(torch.Generator().manual_seed(4))
    return module.train(), dim


def _batch(cls_name, dim, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (20, dim) if cls_name == "MLP" else (7, 3, dim)
    return torch.randn(shape, generator=g)


def _step(module, opt, x):
    opt.zero_grad()
    out = module(x)
    (out.float() ** 2).mean().backward()
    opt.step()


def _pkl(tmp_path, cls_name, kind):
    """(pkl path, the stepped module, its torch optimizer, the input dim)."""
    module, dim = _module(cls_name)
    opt_cls, kw, _ = OPTIMIZERS[kind]
    opt = opt_cls(module.parameters(), lr=LR, **kw)
    for s in range(3):
        _step(module, opt, _batch(cls_name, dim, s))
    path = str(tmp_path / f"{cls_name}_{kind}.pkl")
    torch.save({"model_par": module.state_dict(),
                "optimizer_par": opt.state_dict()}, path)
    return path, module, opt, dim


def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("cls_name, kind", CASES)
def test_converted_trees_equal_tpukaldis(tmp_path, cls_name, kind):
    """The port's and tpukaldi's converters write the same trees: params,
    batch statistics and the optimizer state with its moments."""
    pkl, _, _, _ = _pkl(tmp_path, cls_name, kind)
    ours, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "tpk.ckpt")
    convert_checkpoint_file(pkl, ours, cls_name)
    tpk_convert(pkl, theirs, cls_name)
    got, want = read_checkpoint(ours), read_checkpoint(theirs)
    for part, a, b in zip(("params", "opt_state", "batch_stats"), got, want):
        _assert_trees_equal(a, b, part)
    assert got[1], "the optimizer state is converted"


@pytest.mark.parametrize("cls_name, kind", CASES[:3])
def test_resume_takes_torchs_next_step(tmp_path, cls_name, kind):
    """A port module and optimizer loaded from the converted file take the
    step torch takes from the pkl's own state, on the same batch."""
    pkl, module, opt, dim = _pkl(tmp_path, cls_name, kind)
    ckpt = str(tmp_path / "conv.ckpt")
    convert_checkpoint_file(pkl, ckpt, cls_name)
    resumed, _ = _module(cls_name)
    arch = SimpleNamespace(
        name=cls_name, lr=[LR], options={},
        optimizer=SimpleNamespace(kind=kind, options=OPTIMIZERS[kind][2]))
    port_opt = ArchOptimizer(arch, resumed)
    load_all({cls_name: ckpt}, {cls_name: resumed}, {cls_name: port_opt})
    x = _batch(cls_name, dim, 99)
    _step(module, opt, x)
    port_opt.zero_grad()
    (resumed(x).float() ** 2).mean().backward()
    port_opt.step()
    for (name, want), got in zip(module.state_dict().items(),
                                 resumed.state_dict().values()):
        # batchnorm's step counter is not in tpukaldi's checkpoint format
        if want.is_floating_point():
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-7, err_msg=name)


def test_plain_sgd_writes_no_optimizer_state(tmp_path):
    """Momentum-0 sgd keeps no torch state: params and batch statistics
    only, as tpukaldi's converter writes."""
    pkl, _, _, _ = _pkl(tmp_path, "MLP", "plain_sgd")
    ours, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "tpk.ckpt")
    convert_checkpoint_file(pkl, ours, "MLP")
    tpk_convert(pkl, theirs, "MLP")
    params, opt_state, stats = read_checkpoint(ours)
    assert opt_state == {} and params and stats
    for a, b in zip(read_checkpoint(ours), read_checkpoint(theirs)):
        _assert_trees_equal(a, b)


def test_cli_converts(tmp_path):
    """`python -m tpukaldi_torch.compat.torch_import <pkl> <ckpt> <class>`,
    and the usage message with too few arguments."""
    pkl, _, _, _ = _pkl(tmp_path, "liGRU", "rmsprop")
    out = str(tmp_path / "cli.ckpt")
    r = subprocess.run(
        [sys.executable, "-m", "tpukaldi_torch.compat.torch_import", pkl, out,
         "liGRU"], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"wrote {out}" in r.stdout
    assert read_checkpoint(out)[1]
    r = subprocess.run(
        [sys.executable, "-m", "tpukaldi_torch.compat.torch_import", pkl],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 2 and "usage" in r.stderr
