"""GRU recurrence: the hand-written CUDA kernels, forward and backward, and
their plain PyTorch versions.

    [uz | ur] = h @ Uzr           # Uzr = [Uz | Ur], (H, 2H)
    z, r = sigmoid(ff_z + uz), sigmoid(ff_r + ur)
    a    = ff_h + (r * h) @ Uh    # Uh (H, H)
    h_t  = z * h + (1 - z) * act(a) * mask,   h_0 = 0

ff is in tpukaldi's gate order [h | z | r]; `act_name` is relu or tanh, a
static choice as in tpukaldi's `_act`/`_dact`.  `GRURecurrence` is the
counterpart of tpukaldi's `kernels/gru.py::gru_recurrence` (a
`jax.custom_vjp`): its forward is `gru_recurrence` and saves (ff, uzr, uh,
mask, h); its backward is `gru_recurrence_bwd`.  On a CUDA tensor those
launch `csrc/gru_fwd.cu` and `csrc/gru_bwd.cu` (design notes there) or
raise.  The forward, K3f, is one persistent cooperative launch whose CTAs
each keep column slices of Uzr and Uh in shared memory for all T steps
(where they do not fit, their rows that do; the rest streamed each step,
`csrc/u_stream.cuh`) and exchange h and r * h through global buffers, two
grid barriers a step (`fwd_plan` reports its grid).  K3f takes H <= 2048,
K3b H <= 1024: `GRURecurrence` refuses a gradient past 1024 before its
forward launches.  The backward, K3b, is a gate remat over
all steps, then the dh chain as one persistent cooperative launch on K3f's
grid, whose CTAs keep the same slices in shared memory (`csrc/
gru_slices.cuh`) and exchange partial sums twice a step (`bwd_plan`
reports its grid), then the dU passes.  On a CPU tensor they
run `gru_recurrence_ref` and `gru_recurrence_bwd_ref`, the Python time
loops that mirror tpukaldi's `gru_recurrence_scan` and `_bwd_scan`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from . import _launch

SOURCE = "gru_fwd.cu"
BWD_SOURCE = "gru_bwd.cu"
ACTS = ("relu", "tanh")  # the kernels' `act` argument is the index

# kernel launches since the last reset (one per wrapper call that launched);
# chip_smoke.py reads them to show that the main path went through the
# kernels
launches = 0
bwd_launches = 0


def _act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in ACTS:
        raise ValueError(f"GRU kernels take act relu or tanh, not {name!r}")
    return torch.relu if name == "relu" else torch.tanh


def gru_recurrence_ref(
    ff: torch.Tensor,
    uzr: torch.Tensor,
    uh: torch.Tensor,
    mask: torch.Tensor,
    act: Union[str, Callable[[torch.Tensor], torch.Tensor]] = "relu",
    ln: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """ff (T, B, 3H), uzr (H, 2H), uh (H, H), mask (B, H) or broadcastable
    -> h (T, B, H).

    With `act` relu or tanh and no `ln` it is the kernel's computation; a
    callable `act` and `ln` (a layer norm applied to each h_t, which the next
    step then reads) cover the GRU layers the kernel does not take.  bf16
    inputs carry a bf16 state (`_launch.carry`) and give bf16 h."""
    act_fn = _act(act) if isinstance(act, str) else act
    dtype = ff.dtype
    keep = _launch.carry(dtype)
    ff, uzr, uh, mask = (_launch.widen(t) for t in (ff, uzr, uh, mask))
    H = ff.shape[-1] // 3
    h = ff.new_zeros((ff.shape[1], H))
    out = []
    for ff_t in ff:
        rzr = h @ uzr
        z = torch.sigmoid(ff_t[:, H:2 * H] + rzr[:, :H])
        r = torch.sigmoid(ff_t[:, 2 * H:] + rzr[:, H:])
        a = ff_t[:, :H] + (r * h) @ uh
        h = keep(z * h + (1.0 - z) * (act_fn(a) * mask))
        if ln is not None:
            h = keep(ln(h))
        out.append(h)
    return torch.stack(out).to(dtype)


def minimalgru_recurrence_ref(
    ff: torch.Tensor,
    uz: torch.Tensor,
    uh: torch.Tensor,
    mask: torch.Tensor,
    act: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
    ln: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """The minimal GRU's recurrence (tpukaldi `models/recurrent.py::
    minimalGRU.step`, reference neural_networks.py:1291-1297): the GRU's
    with the update gate standing in for the reset gate, r := z.

        z   = sigmoid(ff_z + h @ Uz)
        a   = ff_h + (z * h) @ Uh
        h_t = z * h + (1 - z) * act(a) * mask,   h_0 = 0

    ff (T, B, 2H) in tpukaldi's gate order [h | z], uz and uh (H, H), mask
    (B, H) or broadcastable -> h (T, B, H); `ln` is a layer norm applied to
    each h_t, which the next step then reads.  No kernel runs it: it is a
    plain Python loop, differentiated by autograd.  bf16 inputs carry a
    bf16 state (`_launch.carry`) and give bf16 h."""
    dtype = ff.dtype
    keep = _launch.carry(dtype)
    ff, uz, uh, mask = (_launch.widen(t) for t in (ff, uz, uh, mask))
    H = ff.shape[-1] // 2
    h = ff.new_zeros((ff.shape[1], H))
    out = []
    for ff_t in ff:
        z = torch.sigmoid(ff_t[:, H:] + h @ uz)
        a = ff_t[:, :H] + (z * h) @ uh
        h = keep(z * h + (1.0 - z) * (act(a) * mask))
        if ln is not None:
            h = keep(ln(h))
        out.append(h)
    return torch.stack(out).to(dtype)


def gru_recurrence_bwd_ref(
    ff: torch.Tensor, h: torch.Tensor, g: torch.Tensor, uzr: torch.Tensor,
    uh: torch.Tensor, mask: torch.Tensor, act_name: str = "relu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's computation as a reverse-time loop (tpukaldi's
    `_bwd_scan`): ff, h (the forward's output), g = dL/dh, uzr, uh, mask
    (B, H) -> (dff (T, B, 3H), duzr (H, 2H), duh (H, H), dmask (B, H))."""
    act = _act(act_name)
    T, B, H3 = ff.shape
    H = H3 // 3
    h_prev = torch.cat([h.new_zeros((1, B, H)), h[:-1]])
    rzr = (h_prev.reshape(T * B, H) @ uzr).reshape(T, B, 2 * H)
    z = torch.sigmoid(ff[..., H:2 * H] + rzr[..., :H])
    r = torch.sigmoid(ff[..., 2 * H:] + rzr[..., H:])
    rh = r * h_prev
    a = ff[..., :H] + (rh.reshape(T * B, H) @ uh).reshape(T, B, H)
    act_a = act(a)
    hc = act_a * mask
    dact = (a > 0.0).to(ff.dtype) if act_name == "relu" else 1.0 - act_a ** 2
    uzr_t, uh_t = uzr.t(), uh.t()
    dff = ff.new_empty((T, B, H3))
    dhc_seq = ff.new_empty((T, B, H))
    dh = ff.new_zeros((B, H))
    for t in range(T - 1, -1, -1):
        gh = g[t] + dh
        dz = gh * (h_prev[t] - hc[t])
        dff[t, :, H:2 * H] = dz * z[t] * (1.0 - z[t])
        dhc = gh * (1.0 - z[t])
        dff[t, :, :H] = dhc * mask * dact[t]
        drh = dff[t, :, :H] @ uh_t
        dff[t, :, 2 * H:] = drh * h_prev[t] * r[t] * (1.0 - r[t])
        dhc_seq[t] = dhc
        dh = gh * z[t] + drh * r[t] + dff[t, :, H:] @ uzr_t
    duzr = h_prev.reshape(T * B, H).t() @ dff[..., H:].reshape(T * B, 2 * H)
    duh = rh.reshape(T * B, H).t() @ dff[..., :H].reshape(T * B, H)
    dmask = (dhc_seq * act_a).sum(dim=0)
    return dff, duzr, duh, dmask


def gru_recurrence(ff: torch.Tensor, uzr: torch.Tensor, uh: torch.Tensor,
                   mask: torch.Tensor, act_name: str = "relu") -> torch.Tensor:
    """Forward: launch the CUDA kernel on a CUDA tensor; the plain version on
    CPU.  Builds no autograd graph of its own: `GRURecurrence` is the
    differentiable entry."""
    global launches
    _launch.refuse_bf16("gru_recurrence", ff, uzr, uh, mask)
    if ff.device.type == "cpu":
        return gru_recurrence_ref(ff, uzr, uh, mask, act_name)
    _act(act_name)
    entry, max_hidden = _launch.bind(SOURCE, "gru_fwd", 7, 4)
    T, B, H = _launch.dims("gru_recurrence", ff, 3)
    _launch.check_inputs("gru_recurrence", H, max_hidden,
                         ff=(ff, (T, B, 3 * H)), uzr=(uzr, (H, 2 * H)),
                         uh=(uh, (H, H)), mask=(mask, (B, H)))
    out = torch.empty((T, B, H), device=ff.device, dtype=torch.float32)
    if T == 0:
        return out
    # the kernel's scratch: the exchange buffers of h_{t-1} and r * h_{t-1},
    # B and H padded to 4 (the padding stays zero), and the grid barrier's
    # counter
    hbuf = torch.zeros((2, -(-B // 4) * 4, -(-H // 4) * 4), device=ff.device,
                       dtype=torch.float32)
    bar = torch.zeros(1, device=ff.device, dtype=torch.int32)
    _launch.launch("gru_fwd", entry, (ff, uzr, uh, mask, out, hbuf, bar), T,
                   B, H, (ACTS.index(act_name),))
    launches += 1
    return out


def gru_recurrence_bwd(
    ff: torch.Tensor, h: torch.Tensor, g: torch.Tensor, uzr: torch.Tensor,
    uh: torch.Tensor, mask: torch.Tensor, act_name: str = "relu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward: (dff, duzr, duh, dmask) from the CUDA kernels on CUDA
    tensors; the plain version on CPU."""
    global bwd_launches
    _launch.refuse_bf16("gru_recurrence_bwd", ff, h, g, uzr, uh, mask)
    if ff.device.type == "cpu":
        return gru_recurrence_bwd_ref(ff, h, g, uzr, uh, mask, act_name)
    _act(act_name)
    entry, max_hidden = _launch.bind(BWD_SOURCE, "gru_bwd", 13, 4)
    T, B, H = _launch.dims("gru_recurrence_bwd", ff, 3)
    _launch.check_inputs("gru_recurrence_bwd", H, max_hidden,
                         ff=(ff, (T, B, 3 * H)), h=(h, (T, B, H)),
                         g=(g, (T, B, H)), uzr=(uzr, (H, 2 * H)),
                         uh=(uh, (H, H)), mask=(mask, (B, H)))
    dff = torch.empty_like(ff)
    if T == 0:
        return (dff, torch.zeros_like(uzr), torch.zeros_like(uh),
                torch.zeros_like(mask))
    duzr = torch.empty_like(uzr)
    duh = torch.empty_like(uh)
    dmask = torch.empty_like(mask)
    rh = torch.empty_like(h)  # r * h_prev, written by the remat
    # the chain's scratch: its two buffers of partial sums (every word read
    # is written first) and the grid barrier's counter, zeroed every call
    pbuf = torch.empty(bwd_plan(B, H)["pbuf_floats"], device=ff.device,
                       dtype=torch.float32)
    bar = torch.zeros(1, device=ff.device, dtype=torch.int32)
    _launch.launch("gru_bwd", entry,
                   (ff, h, g, uzr, uh, mask, dff, duzr, duh, dmask, rh, pbuf,
                    bar), T, B, H, (ACTS.index(act_name),))
    bwd_launches += 1
    return dff, duzr, duh, dmask


def fwd_plan(B: int, H: int) -> dict:
    """K3f's launch at (B, H) on the current card: its CTAs, the hidden
    units each owns, each CTA's shared-memory bytes, the columns of h (and
    of r * h) it stages at a time, the rows of its slices of U each CTA
    keeps resident (`k_res`; H padded to 4 where the whole slices fit) and
    the bytes of U the grid streams a step past them (`stream_bytes`).
    Raises where the card cannot hold the grid at once, as the launch
    would."""
    return _launch.plan(SOURCE, "gru_fwd", B, H, "k_res", "stream_bytes")


def bwd_plan(B: int, H: int) -> dict:
    """K3b's sequential launch at (B, H) on the current card: its CTAs, the
    hidden units each owns, each CTA's shared-memory bytes, the producers'
    partial sums it stages at a time (`chunk`) and the floats of its two
    partial-sum buffers.  Raises where the card cannot hold the grid at
    once, as the launch would."""
    return _launch.plan(BWD_SOURCE, "gru_bwd", B, H, "pbuf_floats")


class GRURecurrence(torch.autograd.Function):
    """h = recurrence(ff, uzr, uh, mask) with the backward kernel as its
    gradient; mask is (B, H), act_name relu or tanh (not differentiated).
    bf16 inputs are widened to float32 at the boundary (`LiGRURecurrence`
    says how); h is float32, the gradients come back in the primal
    dtypes."""

    @staticmethod
    def forward(ctx, ff, uzr, uh, mask, act_name):
        if ff.device.type == "cuda":
            _launch.refuse_wide_backward("gru_recurrence_bwd", ctx,
                                         uh.shape[0], BWD_SOURCE, "gru_bwd")
        w = _launch.widen
        h = gru_recurrence(w(ff), w(uzr), w(uh), w(mask), act_name)
        ctx.save_for_backward(ff, uzr, uh, mask, h)
        ctx.act_name = act_name
        return h

    @staticmethod
    def backward(ctx, g):
        ff, uzr, uh, mask, h = ctx.saved_tensors
        w = _launch.widen
        grads = gru_recurrence_bwd(w(ff), h, g.contiguous(), w(uzr), w(uh),
                                   w(mask), ctx.act_name)
        return (*(d.to(p.dtype) for d, p in zip(grads, (ff, uzr, uh, mask))),
                None)
