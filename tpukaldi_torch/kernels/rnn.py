"""The vanilla RNN's recurrence as a plain PyTorch loop (tpukaldi
`models/recurrent.py::RNN.step`, reference neural_networks.py:1438-1447).

    h_t = act(ff_t + h_{t-1} @ Uh) * mask,   h_0 = 0

tpukaldi runs it as a `lax.scan`, with no Pallas kernel, so the port has
no kernel for it either: this loop is what both a CPU and a CUDA tensor
run, differentiated by autograd.  It sits beside the cells' other plain
versions (`ligru_recurrence_ref`, `gru_recurrence_ref`,
`minimalgru_recurrence_ref`, ...).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import _launch


def rnn_recurrence_ref(
    ff: torch.Tensor,
    uh: torch.Tensor,
    mask: torch.Tensor,
    act: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
    ln: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """ff (T, B, H), uh (H, H), mask (B, H) or broadcastable -> h (T, B, H).
    The recurrent dropout mask multiplies h itself, which the next step
    reads; `ln` is a layer norm applied to each h_t after it.  bf16 inputs
    (the bf16 compute mode) carry a bf16 state (`kernels/_launch.py::carry`)
    and give bf16 h."""
    dtype = ff.dtype
    keep = _launch.carry(dtype)
    ff, uh, mask = (_launch.widen(t) for t in (ff, uh, mask))
    h = ff.new_zeros((ff.shape[1], ff.shape[2]))
    out = []
    for ff_t in ff:
        h = keep(act(ff_t + h @ uh) * mask)
        if ln is not None:
            h = keep(ln(h))
        out.append(h)
    return torch.stack(out).to(dtype)
