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
- init functions drawing from an explicit CPU `torch.Generator`, so a seed
  gives the same weights whatever device the module lives on.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpukaldi.config.schema import to_bool


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


class BatchNorm(nn.BatchNorm1d):
    """tpukaldi's `make_batchnorm` (flax BatchNorm, momentum 0.95 = torch's
    0.05).  Train mode normalises by the batch's biased variance, as torch
    does, but also folds the *biased* variance into `running_var`, as flax
    does; `nn.BatchNorm1d` folds the unbiased one, n/(n-1) times larger.
    The state_dict keys are BatchNorm1d's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.detach(), dim=0, correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return y


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
