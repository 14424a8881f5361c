"""Per-architecture optimizers (counterpart of tpukaldi's
`train/optimizers.py:28-122`, reference utils.py:2106-2164).

tpukaldi chains optax transforms that reproduce the reference's torch
optimizers: an optional global-norm clip (`arch_grad_clip`), coupled L2
weight decay (gradient + wd * param), then the kind's update, then
`-lr`.  For sgd (momentum or Nesterov, dampening 0), adam and rmsprop
(plain, centred or with momentum) `torch.optim` computes the same update,
eps outside the square root, so it is used here; the clip is tpukaldi's
(scale by clip / norm only when the norm reaches the clip), not
`clip_grad_norm_`'s.  Two kinds differ and raise instead:
- amsgrad: optax's `scale_by_amsgrad` keeps the maximum of the
  bias-corrected second moment, `torch.optim.Adam(amsgrad=True)` that of
  the raw moment;
- dampening with momentum, which tpukaldi refuses too.
`arch_opt = none` takes no step.

`state_tree()` / `load_state_tree()` write and read the optimizer state in
tpukaldi's checkpoint layout (flax's `to_state_dict` of the optax state):
`{"count", "hyperparams": {"lr"}, "hyperparams_states", "inner_state":
{"0": ..., "1": ...}}`, one entry per transform of the chain, whose moments
are trees in tpukaldi's parameter naming.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from tpukaldi.config.cfg import ArchSpec

from ..compat.jax_params import moments_from_jax, moments_to_jax


class ArchOptimizer:
    """The optimizer of one architecture, stepped on its module's `.grad`s."""

    def __init__(self, arch: ArchSpec, module: nn.Module):
        self.name = arch.name
        self.module = module
        self.kind = arch.optimizer.kind
        self.params: List[nn.Parameter] = list(module.parameters())
        self.lr = float(arch.lr[0])
        self.count = 0  # updates taken (optax's inject_hyperparams count)
        o = arch.optimizer.options
        wd = float(o.get("opt_weight_decay", 0.0))
        self.clip = float(arch.options.get("arch_grad_clip", 0.0) or 0.0)
        # optax chain: [clip] [add_decayed_weights] kind [trace] scale(-lr);
        # each entry maps the transform's state fields to torch state keys
        layout: List[Dict[str, str]] = [{}] * (self.clip > 0) + [{}] * (wd > 0)
        if self.kind == "sgd":
            momentum = float(o.get("opt_momentum", 0.0))
            nesterov = bool(o.get("opt_nesterov", False))
            dampening = float(o.get("opt_dampening", 0.0))
            if momentum != 0.0 and dampening != 0.0:
                raise ValueError(
                    f"arch {self.name!r}: opt_dampening={dampening} is "
                    "unsupported (tpukaldi's optax chain has no momentum "
                    "dampening); use opt_dampening=0")
            self.opt = torch.optim.SGD(self.params, lr=self.lr,
                                       momentum=momentum, nesterov=nesterov,
                                       weight_decay=wd)
            layout.append({"trace": "momentum_buffer"} if momentum else {})
        elif self.kind == "adam":
            if bool(o.get("opt_amsgrad", False)):
                raise NotImplementedError(
                    f"arch {self.name!r}: opt_amsgrad=True is not ported: "
                    "tpukaldi (optax scale_by_amsgrad) keeps the maximum of "
                    "the bias-corrected second moment, torch.optim.Adam that "
                    "of the raw moment (ROADMAP.md section 3)")
            betas = o.get("opt_betas", [0.9, 0.999])
            self.opt = torch.optim.Adam(
                self.params, lr=self.lr,
                betas=(float(betas[0]), float(betas[1])),
                eps=float(o.get("opt_eps", 1e-8)), weight_decay=wd)
            layout.append({"count": "step", "mu": "exp_avg",
                           "nu": "exp_avg_sq"})
        elif self.kind == "rmsprop":
            centered = bool(o.get("opt_centered", False))
            momentum = float(o.get("opt_momentum", 0.0))
            self.opt = torch.optim.RMSprop(
                self.params, lr=self.lr, alpha=float(o.get("opt_alpha", 0.99)),
                eps=float(o.get("opt_eps", 1e-8)), weight_decay=wd,
                momentum=momentum, centered=centered)
            layout.append({"mu": "grad_avg", "nu": "square_avg"} if centered
                          else {"nu": "square_avg"})
            if momentum > 0.0:
                layout.append({"trace": "momentum_buffer"})
        elif self.kind == "none":
            # reference arch_opt=none: the net is never updated (tpukaldi's
            # set_to_zero keeps only the step count)
            self.opt = None
            layout.append({})
        else:
            raise ValueError(f"unknown optimizer {self.kind!r}")
        self.layout = layout + [{}]  # the final scale(-lr) has no state

    def set_lr(self, lr: float) -> None:
        """New-bob's per-epoch lr; the optimizer state is untouched."""
        self.lr = float(lr)
        if self.opt is not None:
            for group in self.opt.param_groups:
                group["lr"] = self.lr

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        if self.opt is None:
            return
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.clip > 0.0 and grads:
            # optax clip_by_global_norm: g * clip / norm once norm >= clip;
            # computed on the device, no host sync
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.clip, torch.ones_like(norm),
                                self.clip / norm)
            torch._foreach_mul_(grads, scale)
        self.opt.step()

    # ------------------------------------------------ tpukaldi's layout
    def _moments(self, key: str) -> Dict[str, torch.Tensor]:
        """Torch state `key` of every parameter, by parameter name (zeros
        before the first step)."""
        out = {}
        for (name, p) in self.module.named_parameters():
            st = self.opt.state.get(p, {}) if self.opt is not None else {}
            v = st.get(key)
            out[name] = (torch.zeros_like(p) if v is None else v).detach()
        return out

    def state_tree(self) -> Dict:
        """The optimizer state in tpukaldi's checkpoint layout (numpy)."""
        inner = {}
        for i, part in enumerate(self.layout):
            inner[str(i)] = {
                field: (np.asarray(self.count, np.int32) if key == "step"
                        else moments_to_jax(self.module, self._moments(key)))
                for field, key in part.items()}
        return {"count": np.asarray(self.count, np.int32),
                "hyperparams": {"lr": np.asarray(self.lr, np.float32)},
                "hyperparams_states": {},
                "inner_state": inner}

    def load_state_tree(self, tree: Dict, source: str = "") -> None:
        """Restore moments and step count from tpukaldi's layout.  The lr
        stays the one set from the cfg (tpukaldi re-injects the scheduled
        lr after a restore).  A tree written for another optimizer is
        dropped with a warning and the fresh state stands, as tpukaldi's
        `load_checkpoint` does."""
        if not tree:
            return
        inner = tree.get("inner_state", {})
        if set(inner) != {str(i) for i in range(len(self.layout))} or any(
                set(inner[str(i)]) != set(part)
                for i, part in enumerate(self.layout)):
            print(f"[checkpoint] optimizer state in {source} does not match "
                  f"the configured optimizer ({self.kind}); restarting the "
                  "optimizer", file=sys.stderr)
            return
        self.count = int(np.asarray(tree["count"]))
        if self.opt is None:
            return
        state: Dict[nn.Parameter, Dict[str, torch.Tensor]] = {
            p: {} for p in self.params}
        named = dict(self.module.named_parameters())
        for i, part in enumerate(self.layout):
            for field, key in part.items():
                if key == "step":
                    continue
                moments = moments_from_jax(self.module, inner[str(i)][field])
                for name, v in moments.items():
                    p = named[name]
                    state[p][key] = v.to(device=p.device, dtype=p.dtype)
        if self.kind == "sgd":
            if self.layout[-2]:  # with momentum: torch keeps only the buffer
                for p, st in state.items():
                    self.opt.state[p] = st
            return
        for p, st in state.items():
            st["step"] = torch.tensor(float(self.count), dtype=torch.float32)
            self.opt.state[p] = st


def make_all_optimizers(archs: Dict[str, ArchSpec],
                        modules: Dict[str, nn.Module]) -> Dict[str, ArchOptimizer]:
    """One optimizer per architecture of the graph."""
    return {name: ArchOptimizer(archs[name], modules[name]) for name in modules}
