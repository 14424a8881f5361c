"""Quaternion layers (counterpart of `tpukaldi/models/quaternion.py`,
reference quaternion_neural_networks.py): `QuaternionDense` and `QLSTM`.

A quaternion weight is four real matrices r, i, j, k of (in/4, out/4); the
forward is `x @ K` with K the 4x4 block Hamilton kernel
(`hamilton_kernel`).  `autograd = False` selects the reference's
hand-written backward, here `QuaternionLinearLean`: the weight gradients
in component space, without forming dK.  All of their products are
`torch.matmul`, as tpukaldi leaves them to XLA.

The QLSTM composes each layer's four recurrent quaternion weights into one
(H, 4H) Hamilton-dense U = [Uf | Ui | Uo | Uc], so its recurrence is the
zoo LSTM cell with the drop mask on the candidate.  `qlstm_impl` keeps
tpukaldi's meaning, with "on a TPU" read as "on a CUDA tensor", for tanh
layers:
- `auto`: the bf16-U recurrence (`kernels/lstm.py::LSTMLeanRecurrence`,
  K4f/K4b) on a CUDA tensor; the float32 recurrence on CPU (tpukaldi's
  scan off a TPU).
- `pallas`: the bf16-U recurrence: K4 on the card, its plain version on
  CPU (tpukaldi runs its Pallas kernel in interpret mode there).
- `scan`: the float32 recurrence (`LSTMRecurrence`): K2f/K2b on the card,
  the plain loop on CPU.
A layer with another activation runs the plain float32 loop, as tpukaldi's
scan does.  K4f takes H <= 2048 (past what shared memory holds it streams
U, `csrc/u_stream.cuh`) and K4b H <= 1024, and each raises above (a
gradient past 1024 before the forward launches); tpukaldi's TPU memory
gate (`lean_fits_vmem`) is not ported.

In the bf16 compute mode the QLSTM's K4 path passes its bf16 ff to K4's
bf16 entry (the mask widened, h cast back to bf16), as tpukaldi's kernel
branch does; its other paths carry a bf16 state, as tpukaldi's scan does.

Bidirectional layers double the batch with the length-aware time-reversed
copy (`models/recurrent.py::_reverse_time`).  The state_dict keeps the
reference layout: per layer i, `{wfx,wix,wox,wcx}.{i}.{r,i,j,k}_weight`
and `.bias`, `{ufh,uih,uoh,uch}.{i}.{r,i,j,k}_weight`.

Tensor contract: x is (T, B, D) -> (T, B, out_dim).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config.schema import to_bool
from ..kernels import ops
from ..kernels.lstm import LSTMLeanRecurrence, LSTMRecurrence, lstm_recurrence_ref
from .common import act_fun, float_list, int_list, recurrent_drop_mask
from .recurrent import _reverse_time

_COMPONENTS = ("r", "i", "j", "k")


def hamilton_kernel(r, i, j, k):
    """The (in, out) block kernel K of the components, each (in/4, out/4),
    such that x @ K is the Hamilton product (reference layout)."""
    col_r = torch.cat([r, -i, -j, -k], dim=0)
    col_i = torch.cat([i, r, -k, j], dim=0)
    col_j = torch.cat([j, k, r, -i], dim=0)
    col_k = torch.cat([k, -j, i, r], dim=0)
    return torch.cat([col_r, col_i, col_j, col_k], dim=1)


class QuaternionLinearLean(torch.autograd.Function):
    """y = x @ hamilton_kernel(r, i, j, k) with tpukaldi's component-space
    backward (`quaternion_linear_leanvjp`'s `_qbwd`): dx = g @ K^T, and each
    component's gradient as four (in/4, N) x (N, out/4) products."""

    @staticmethod
    def forward(ctx, x, r, i, j, k):
        ctx.save_for_backward(x, r, i, j, k)
        return x @ hamilton_kernel(r, i, j, k)

    @staticmethod
    def backward(ctx, g):
        x, r, i, j, k = ctx.saved_tensors
        gx = g @ hamilton_kernel(r, i, j, k).t()
        n, m = r.shape
        xr, xi, xj, xk = x.reshape(-1, 4 * n).split(n, dim=1)
        gr, gi, gj, gk = g.reshape(-1, 4 * m).split(m, dim=1)

        def ct(a, b):  # a^T @ b over all leading axes
            return a.t() @ b

        gr_w = ct(xr, gr) + ct(xi, gi) + ct(xj, gj) + ct(xk, gk)
        gi_w = -ct(xi, gr) + ct(xr, gi) - ct(xk, gj) + ct(xj, gk)
        gj_w = -ct(xj, gr) + ct(xk, gi) + ct(xr, gj) - ct(xi, gk)
        gk_w = -ct(xk, gr) - ct(xj, gi) + ct(xi, gj) + ct(xr, gk)
        return gx, gr_w, gi_w, gj_w, gk_w


def quaternion_init_arrays(in_features4: int, out_features4: int, seed: int,
                           kind: str = "quaternion", criterion: str = "glorot"):
    """The reference init schemes (quaternion_neural_networks.py:483-626),
    as tpukaldi draws them: (r, i, j, k) numpy arrays of (in/4, out/4) from
    a numpy RandomState(seed)."""
    rng = np.random.RandomState(seed)
    fan_in, fan_out = in_features4, out_features4
    if criterion == "glorot":
        s = 1.0 / np.sqrt(2 * (fan_in + fan_out))
    else:  # he
        s = 1.0 / np.sqrt(2 * fan_in)
    shape = (in_features4, out_features4)
    n = int(np.prod(shape))
    if kind == "random":
        bound = np.sqrt(3.0) * s
        return tuple(rng.uniform(-bound, bound, shape) for _ in range(4))
    if kind == "unitary":
        bound = np.sqrt(3.0) * s
        v = [rng.uniform(-bound, bound, n) for _ in range(4)]
        norm = np.sqrt(sum(c**2 for c in v)) + 1e-4
        return tuple((c / norm).reshape(shape) for c in v)
    # 'quaternion': chi(4)-modulus polar init
    modulus = np.sqrt(rng.chisquare(4, n)) * s
    phase = rng.uniform(-np.pi, np.pi, n)
    v = [rng.uniform(0, 1, n) for _ in range(3)]
    vnorm = np.sqrt(sum(c**2 for c in v)) + 1e-4
    vi, vj, vk = (c / vnorm for c in v)
    r = (modulus * np.cos(phase)).reshape(shape)
    i = (modulus * vi * np.sin(phase)).reshape(shape)
    j = (modulus * vj * np.sin(phase)).reshape(shape)
    k = (modulus * vk * np.sin(phase)).reshape(shape)
    return r, i, j, k


class QuaternionDense(nn.Module):
    """Quaternion linear layer (reference QuaternionLinear(Autograd)):
    parameters `{r,i,j,k}_weight` (in/4, out/4) and `bias` (out,); both
    widths must be multiples of 4.  `lean` selects `QuaternionLinearLean`
    (the cfg's `autograd = False`)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, weight_init: str = "quaternion",
                 lean: bool = False, device=None):
        super().__init__()
        if in_features % 4 or out_features % 4:
            raise ValueError(
                f"quaternion dims must be multiples of 4, got "
                f"{in_features}->{out_features}")
        self.weight_init = weight_init
        self.lean = lean
        shape = (in_features // 4, out_features // 4)
        for c in _COMPONENTS:
            setattr(self, f"{c}_weight",
                    nn.Parameter(torch.zeros(shape, device=device)))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if use_bias else None)

    def components(self):
        return tuple(getattr(self, f"{c}_weight") for c in _COMPONENTS)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference init from a numpy seed drawn from `generator`, one
        draw per layer so the four components share the modulus draw."""
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
        arrays = quaternion_init_arrays(*self.r_weight.shape, seed,
                                        self.weight_init)
        with torch.no_grad():
            for p, a in zip(self.components(), arrays):
                p.copy_(torch.from_numpy(a))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.lean:
            y = QuaternionLinearLean.apply(x, *self.components())
        else:
            y = x @ hamilton_kernel(*self.components())
        return y if self.bias is None else y + self.bias


class QLSTM(nn.Module):
    """Quaternion LSTM (reference quaternion_neural_networks.py:21-168): per
    gate a quaternion feed-forward projection and a quaternion recurrent
    weight, bidirectionality by flip-concat, the drop mask on the candidate.
    Options are the reference's `lstm_*` keys plus `quaternion_init`,
    `autograd` (False: the lean backward) and `qlstm_impl`."""

    FF_GATES = ("wfx", "wix", "wox", "wcx")
    REC_GATES = ("ufh", "uih", "uoh", "uch")

    def __init__(self, options: Dict[str, str], inp_dim: int, device=None):
        super().__init__()
        o = options
        self.options = options
        self.inp_dim = inp_dim
        self.lay = int_list(o["lstm_lay"])
        self.drop = float_list(o["lstm_drop"])
        self.acts = o["lstm_act"].split(",")
        self.bidir = to_bool(o["lstm_bidir"])
        winit = o.get("quaternion_init", "quaternion")
        lean = not to_bool(o.get("autograd", "True"))
        for g in self.FF_GATES + self.REC_GATES:
            setattr(self, g, nn.ModuleList())
        current = inp_dim
        for hidden in self.lay:
            for g in self.FF_GATES:
                getattr(self, g).append(QuaternionDense(
                    current, hidden, True, winit, lean, device=device))
            for g in self.REC_GATES:
                getattr(self, g).append(QuaternionDense(
                    hidden, hidden, False, winit, device=device))
            current = hidden * (2 if self.bidir else 1)

    @classmethod
    def compute_out_dim(cls, options: Dict[str, str], inp_dim: int) -> int:
        lay = int_list(options["lstm_lay"])
        return lay[-1] * (2 if to_bool(options["lstm_bidir"]) else 1)

    @property
    def out_dim(self) -> int:
        return self.compute_out_dim(self.options, self.inp_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(len(self.lay)):
            for g in self.FF_GATES + self.REC_GATES:
                getattr(self, g)[i].reset_parameters(generator)

    def recurrence(self, i: int, ff: torch.Tensor, u: torch.Tensor,
                   drop_mask: torch.Tensor) -> torch.Tensor:
        """(T, B', 4H) feed-forward gates, the Hamilton-dense u (H, 4H) ->
        (T, B', H), by `qlstm_impl` (module docstring)."""
        grad = torch.is_grad_enabled()
        if self.acts[i] != "tanh":
            if not grad:
                return ops.lstm_recurrence(ff, u, drop_mask, False,
                                           self.acts[i], None, None, 0.0)
            return lstm_recurrence_ref(ff, u, drop_mask,
                                       act_fun(self.acts[i]))[0]
        mask = drop_mask.expand(ff.shape[1], u.shape[0]).contiguous()
        impl = self.options.get("qlstm_impl", "auto")
        if not grad:
            # the custom op (kernels/ops.py) takes the branches below on
            # the device it runs on
            return ops.lstm_recurrence_lean(ff, u, mask, impl)
        if impl == "pallas" or (impl == "auto" and ff.device.type == "cuda"):
            # ff goes to K4 in its own dtype (K4's bf16 entry in the bf16
            # compute mode), h comes back float32 and the layer goes on in
            # ff's dtype, as tpukaldi's kernel branch does
            return LSTMLeanRecurrence.apply(ff, u, mask).to(ff.dtype)
        if ff.dtype == torch.bfloat16:
            # tpukaldi's scan carries its state in the layer's dtype
            return lstm_recurrence_ref(ff, u, mask)[0]
        return LSTMRecurrence.apply(ff, u, mask)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i, hidden in enumerate(self.lay):
            B = x.shape[1]
            if self.bidir:
                x = torch.cat([x, _reverse_time(x, lengths)], dim=1)
            ff = torch.cat([getattr(self, g)[i](x) for g in self.FF_GATES],
                           dim=2)
            u = torch.cat([hamilton_kernel(*getattr(self, g)[i].components())
                           for g in self.REC_GATES], dim=1)
            drop_mask = recurrent_drop_mask(
                self.training, (x.shape[1], hidden), self.drop[i], x.device,
                generator).to(x.dtype)
            h = self.recurrence(i, ff, u, drop_mask)
            if self.bidir:
                h = torch.cat([h[:, :B], _reverse_time(h[:, B:], lengths)],
                              dim=2)
            x = h
        return x
