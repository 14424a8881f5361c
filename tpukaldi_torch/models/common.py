"""Shared building blocks for the port's model zoo (counterpart of
`tpukaldi/models/common.py`, reference neural_networks.py:23-57).

- `act_fun`: relu/tanh/sigmoid/leaky_relu/elu/log-softmax/linear factory;
  softmax is log_softmax computed in float32.
- `ref_laynorm`: gamma*(x-mean)/(std+eps)+beta with the reference's
  *unbiased* std and eps added to the std, not the variance.
- `BatchNorm` / `batchnorm`: BatchNorm1d with momentum 0.05, eps 1e-5, whose
  train-mode running variance takes the *biased* batch variance, as flax's
  BatchNorm in tpukaldi does (torch's own folds in the unbiased one).
- `recurrent_drop_mask`: one Bernoulli(1-p) mask shared across time at
  train, drawn on the device from the generator it is given; the scalar
  (1-p) at eval.  Not inverted dropout.
- `inverted_dropout`: torch nn.Dropout's semantics (a Bernoulli(1-p) mask
  scaled by 1/(1-p), identity at eval), drawn the same way.
- init functions drawing from an explicit CPU `torch.Generator`, so a seed
  gives the same weights whatever device the module lives on.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import to_bool
from ..kernels._launch import widen


def act_fun(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "relu":
        return torch.relu
    if name == "tanh":
        return torch.tanh
    if name == "sigmoid":
        return torch.sigmoid
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "elu":
        return F.elu
    if name == "softmax":
        return lambda x: torch.log_softmax(x.float(), dim=-1)
    if name == "linear":
        return lambda x: x
    raise ValueError(f"unknown activation {name!r}")


def bool_list(value: str):
    return [to_bool(v) for v in value.split(",")]


def int_list(value: str):
    return [int(v) for v in value.split(",")]


def float_list(value: str):
    return [float(v) for v in value.split(",")]


def ref_laynorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Normalise over the last axis by the unbiased std, eps added to the
    std; moments in float32, result in the caller's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    n = x.shape[-1]
    var = ((xf - mean) ** 2).sum(dim=-1, keepdim=True) / max(n - 1, 1)
    y = gamma.float() * (xf - mean) / (torch.sqrt(var) + eps)
    return (y + beta.float()).to(x.dtype)


class RefLayerNorm(nn.Module):
    """The reference LayerNorm module (state_dict keys `gamma`, `beta`)."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(features, device=device))
        self.beta = nn.Parameter(torch.zeros(features, device=device))
        self.eps = eps

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x):
        return ref_laynorm(x, self.gamma, self.beta, self.eps)


# whether train-mode batchnorm normalises by the moments of the global
# batch, summed over the ranks of the process group (`global_batch_moments`)
_GLOBAL_MOMENTS = False


@contextlib.contextmanager
def global_batch_moments(on: bool = True):
    """Inside, a train-mode `BatchNorm` normalises by the moments of the
    global batch, all-reduced over the process group (the data-parallel
    train step enters it at world size > 1, tpukaldi's sharded step
    computing them over the whole sharded batch)."""
    global _GLOBAL_MOMENTS
    saved, _GLOBAL_MOMENTS = _GLOBAL_MOMENTS, on
    try:
        yield
    finally:
        _GLOBAL_MOMENTS = saved


def _global_moments(xf: torch.Tensor, dims):
    """(mean, biased variance) over `dims` of every rank's rows: the sums
    and the row count all-reduced through the differentiable
    `torch.distributed.nn.functional.all_reduce`, then the centred squares
    likewise (two passes, as a single device computes them)."""
    from torch.distributed.nn.functional import all_reduce

    n = xf.numel() // xf.shape[1]
    s = all_reduce(torch.cat([xf.sum(dim=dims),
                              xf.new_full((1,), float(n))]))
    count = s[-1]
    mean = s[:-1] / count
    shape = (1, -1, 1) if xf.ndim == 3 else (1, -1)
    var = all_reduce(((xf - mean.view(shape)) ** 2).sum(dim=dims)) / count
    return mean, var


class BatchNorm(nn.BatchNorm1d):
    """tpukaldi's `make_batchnorm` (flax BatchNorm, momentum 0.95 = torch's
    0.05).  Train mode normalises by the batch's biased variance, as torch
    does, but also folds the *biased* variance into `running_var`, as flax
    does; `nn.BatchNorm1d` folds the unbiased one, n/(n-1) times larger.
    A bf16 input (the bf16 compute mode) is normalised in float32, its
    moments and the running statistics too, with the (bf16) scale and shift
    widened, and the output returns in bf16: tpukaldi's `_F32BatchNorm`.
    An (N, C, L) input is normalised per channel over N and L, as flax's
    over every axis but the last.  Inside `global_batch_moments` the
    moments are the global batch's, over every rank of the process group.
    The state_dict keys are BatchNorm1d's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = widen(x)
        weight = None if self.weight is None else widen(self.weight)
        bias = None if self.bias is None else widen(self.bias)
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                weight, bias, False, 0.0,
                                self.eps).to(x.dtype)
        dims = (0, 2) if xf.ndim == 3 else 0
        if _GLOBAL_MOMENTS:
            mean, var = _global_moments(xf, dims)
            shape = (1, -1, 1) if xf.ndim == 3 else (1, -1)
            y = (xf - mean.view(shape)) * torch.rsqrt(
                var.view(shape) + self.eps)
            if weight is not None:
                y = y * weight.view(shape)
            if bias is not None:
                y = y + bias.view(shape)
            mean, var = mean.detach(), var.detach()
        else:
            y = F.batch_norm(xf, None, None, weight, bias, True, 0.0,
                             self.eps)
        with torch.no_grad():
            if not _GLOBAL_MOMENTS:
                var, mean = torch.var_mean(xf.detach(), dim=dims,
                                           correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return y.to(x.dtype)


def batchnorm(features: int, device=None) -> BatchNorm:
    """BatchNorm with the reference's momentum 0.05 and eps 1e-5."""
    return BatchNorm(features, momentum=0.05, eps=1e-5, device=device)


def recurrent_drop_mask(train: bool, shape, p: float, device,
                        generator: Optional[torch.Generator] = None):
    """One Bernoulli(1-p) mask reused across time at train, the scalar
    (1-p) at eval (reference neural_networks.py:421-425).  The mask is drawn
    on `device` from `generator` (a generator of that device, or None for
    its default one): no host draw, no blocking copy."""
    if train and p > 0.0:
        return torch.empty(shape, device=device).bernoulli_(
            1.0 - p, generator=generator)
    # torch.full, not torch.tensor: a fill kernel, no blocking host copy
    return torch.full((), 1.0 - p, dtype=torch.float32, device=device)


def inverted_dropout(x: torch.Tensor, p: float, train: bool,
                     generator: Optional[torch.Generator] = None):
    """x times a Bernoulli(1-p) mask over 1-p at train (tpukaldi's
    `FastDropout`, torch's nn.Dropout), x itself at eval or p = 0; the mask
    is drawn on x's device from `generator`."""
    if not train or p == 0.0:
        return x
    keep = 1.0 - p
    return x * torch.empty_like(x).bernoulli_(keep, generator=generator) / keep


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def glorot_small_uniform(shape, fan_in: int, fan_out: int,
                         generator: torch.Generator) -> torch.Tensor:
    """Reference MLP init: U(+-sqrt(0.01/(fan_in+fan_out)))."""
    return _uniform(shape, (0.01 / (fan_in + fan_out)) ** 0.5, generator)


def torch_linear_uniform(shape, fan_in: int,
                         generator: torch.Generator) -> torch.Tensor:
    """nn.Linear's default init: U(+-1/sqrt(fan_in))."""
    return _uniform(shape, 1.0 / fan_in ** 0.5, generator)


def orthogonal(n: int, generator: torch.Generator) -> torch.Tensor:
    """A random (n, n) orthogonal matrix."""
    return nn.init.orthogonal_(torch.empty(n, n), generator=generator)
