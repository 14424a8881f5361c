"""Li-GRU recurrence: the hand-written CUDA kernels, forward and backward,
and their plain PyTorch versions.

    r    = h @ U                  # U = [Uh | Uz], (H, 2H)
    z_t  = sigmoid(ffz_t + r_z)
    hc   = relu(ffh_t + r_h) * mask
    h_t  = z_t * h + (1 - z_t) * hc,   h_0 = 0

`LiGRURecurrence` is the counterpart of tpukaldi's
`kernels/ligru.py::ligru_recurrence` (a `jax.custom_vjp`): its forward is
`ligru_recurrence` and saves (ff, u, mask, h); its backward is
`ligru_recurrence_bwd`.  On a CUDA tensor those launch `csrc/ligru_fwd.cu`
and `csrc/ligru_bwd.cu` (design notes there) or raise.  The forward, K1f,
is one persistent cooperative launch whose CTAs each keep the (Uh, Uz)
column pairs of their hidden units in shared memory for all T steps
(packed once per call by `_pack`; where a slice does not fit, its rows
that do, the rest streamed each step, `csrc/u_stream.cuh`) and exchange h
through a global ping-pong buffer, one grid barrier a step (`fwd_plan`
reports its grid).  K1f takes H <= 2048, K1b H <= 1024: `LiGRURecurrence` refuses a
gradient past 1024 before its forward launches.
The backward, K1b, is three launches: a gate remat over all T * B rows, a
persistent cooperative dh chain on K1f's grid whose CTAs each keep their
units' rows of [Uh | Uz] in shared memory (packed once per call by
`_pack_bwd`) and stream dA through a global ping-pong buffer, one grid
barrier a step (`bwd_plan` reports its grid), then the dU pass.  On a
CPU tensor they run
`ligru_recurrence_ref` and `ligru_recurrence_bwd_ref`, the Python time
loops that mirror tpukaldi's `ligru_recurrence_scan` and `_bwd_scan`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _launch

SOURCE = "ligru_fwd.cu"
BWD_SOURCE = "ligru_bwd.cu"

# kernel launches since the last reset (one per wrapper call that launched:
# the backward's call runs its remat, chain and dU kernels); chip_smoke.py
# reads them to show that the main path went through the kernels
launches = 0
bwd_launches = 0


def ligru_recurrence_ref(
    ff: torch.Tensor,
    u: torch.Tensor,
    mask: torch.Tensor,
    act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
    ln: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """ff (T, B, 2H), u (H, 2H), mask (B, H) or broadcastable -> h (T, B, H).

    With the defaults it is the kernel's computation.  `act` and `ln` (a
    layer norm applied to each h_t, reference neural_networks.py:1130-1141)
    cover the liGRU layers the kernel does not take.  bf16 inputs (the bf16
    compute mode's scan) carry a bf16 state (`_launch.carry`) and give bf16
    h."""
    dtype = ff.dtype
    keep = _launch.carry(dtype)
    ff, u, mask = (_launch.widen(t) for t in (ff, u, mask))
    H = ff.shape[-1] // 2
    h = ff.new_zeros((ff.shape[1], H))
    out = []
    for ff_t in ff:
        r = h @ u
        zt = torch.sigmoid(ff_t[:, H:] + r[:, H:])
        hc = act(ff_t[:, :H] + r[:, :H]) * mask
        h = keep(zt * h + (1 - zt) * hc)
        if ln is not None:
            h = keep(ln(h))
        out.append(h)
    return torch.stack(out).to(dtype)


def ligru_recurrence_bwd_ref(
    ff: torch.Tensor, h: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's computation as a reverse-time loop (tpukaldi's
    `_bwd_scan`): ff, h (the forward's output), g = dL/dh, u, mask (B, H) ->
    (dff (T, B, 2H), du (H, 2H), dmask (B, H))."""
    T, B, H2 = ff.shape
    H = H2 // 2
    h_prev = torch.cat([h.new_zeros((1, B, H)), h[:-1]])
    r = (h_prev.reshape(T * B, H) @ u).reshape(T, B, H2)
    a_h = ff[..., :H] + r[..., :H]
    zt = torch.sigmoid(ff[..., H:] + r[..., H:])
    relu_ah = torch.clamp_min(a_h, 0.0)
    hc = relu_ah * mask
    apos = (a_h > 0.0).to(ff.dtype)
    ut = u.t()
    dff = ff.new_empty((T, B, H2))
    dhc_seq = ff.new_empty((T, B, H))
    dh = ff.new_zeros((B, H))
    for t in range(T - 1, -1, -1):
        gh = g[t] + dh
        dz = gh * (h_prev[t] - hc[t])
        dff[t, :, H:] = dz * zt[t] * (1.0 - zt[t])
        dhc = gh * (1.0 - zt[t])
        dff[t, :, :H] = dhc * mask * apos[t]
        dhc_seq[t] = dhc
        dh = gh * zt[t] + dff[t] @ ut
    du = h_prev.reshape(T * B, H).t() @ dff.reshape(T * B, H2)
    dmask = (dhc_seq * relu_ah).sum(dim=0)
    return dff, du, dmask


def ligru_recurrence(ff: torch.Tensor, u: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Forward: launch the CUDA kernel on a CUDA tensor (u is packed once
    per call); the plain version on CPU.  Builds no autograd graph of its
    own: `LiGRURecurrence` is the differentiable entry."""
    global launches
    _launch.refuse_bf16("ligru_recurrence", ff, u, mask)
    if ff.device.type == "cpu":
        return ligru_recurrence_ref(ff, u, mask)
    entry, max_hidden = _launch.bind(SOURCE, "ligru_fwd", 6, 4)
    T, B, H = _launch.dims("ligru_recurrence", ff, 2)
    _launch.check_inputs("ligru_recurrence", H, max_hidden,
                         ff=(ff, (T, B, 2 * H)), u=(u, (H, 2 * H)),
                         mask=(mask, (B, H)))
    out = torch.empty((T, B, H), device=ff.device, dtype=torch.float32)
    if T == 0:
        return out
    plan = fwd_plan(B, H)
    # the kernel's scratch: the ping-pong buffer of h, B and H padded to 4
    # (the padding stays zero), and the grid barrier's counter
    hbuf = torch.zeros((2, -(-B // 4) * 4, -(-H // 4) * 4), device=ff.device,
                       dtype=torch.float32)
    bar = torch.zeros(1, device=ff.device, dtype=torch.int32)
    _launch.launch("ligru_fwd", entry,
                   (ff, _pack(u, H, plan["units"], plan["row_floats"]), mask,
                    out, hbuf, bar), T, B, H, (plan["units"],))
    launches += 1
    return out


def _pack(u: torch.Tensor, H: int, units: int, ld: int) -> torch.Tensor:
    """K1f's U operand for the plan's `units` a CTA and `ld` floats a row
    (`fwd_plan`'s `row_floats`): (P, H, ld) with P = ceil(H / units),
    [q, k, 2 jj : 2 jj + 2] = (Uh[k, j], Uz[k, j]) for unit j = q units + jj
    of CTA q, zeros past its units (and past H), so that CTA q's slice is
    one contiguous run and each 16-byte word holds whole pairs."""
    # [k, j] = (Uh[k, j], Uz[k, j])
    return _pack_pairs(u.view(H, 2, H).transpose(1, 2), H, units, ld)


def _pack_bwd(u: torch.Tensor, H: int, units: int, ld: int) -> torch.Tensor:
    """K1b's U operand, `_pack`'s layout over U's rows instead of its
    columns (`bwd_plan`'s `units` and `row_floats`): [q, k, 2 jj : 2 jj + 2]
    = (Uh[j, k], Uz[j, k]) for unit j = q units + jj of CTA q, what dh[j] =
    sum over k of da_h[k] Uh[j, k] + da_z[k] Uz[j, k] reads."""
    # [k, j] = (Uh[j, k], Uz[j, k])
    return _pack_pairs(u.view(H, 2, H).permute(2, 0, 1), H, units, ld)


def _pack_pairs(pairs: torch.Tensor, H: int, units: int,
                ld: int) -> torch.Tensor:
    """(H, H, 2) pairs [k, j] -> (P, H, ld): CTA q's units' pairs of every
    row k side by side, zero-padded past its units, past H and to ld."""
    P = -(-H // units)
    pairs = F.pad(pairs, (0, 0, 0, P * units - H)).reshape(H, P, 2 * units)
    rows = F.pad(pairs, (0, ld - 2 * units))
    return rows.transpose(0, 1).contiguous()


def fwd_plan(B: int, H: int) -> dict:
    """K1f's launch at (B, H) on the current card: its CTAs, the hidden
    units each owns, each CTA's shared-memory bytes, the columns of h it
    stages at a time, the floats of a packed U row, the rows of its slice
    of U each CTA keeps resident (`k_res`; H padded to 4 where the whole
    slice fits) and the bytes of U the grid streams a step past them
    (`stream_bytes`).  Raises where the card cannot hold the grid at once,
    as the launch would."""
    return _launch.plan(SOURCE, "ligru_fwd", B, H, "row_floats", "k_res",
                        "stream_bytes")


def ligru_recurrence_bwd(
    ff: torch.Tensor, h: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward: (dff, du, dmask) from the CUDA kernels on CUDA tensors (u
    is packed once per call); the plain version on CPU."""
    global bwd_launches
    _launch.refuse_bf16("ligru_recurrence_bwd", ff, h, g, u, mask)
    if ff.device.type == "cpu":
        return ligru_recurrence_bwd_ref(ff, h, g, u, mask)
    entry, max_hidden = _launch.bind(BWD_SOURCE, "ligru_bwd", 11, 4)
    T, B, H = _launch.dims("ligru_recurrence_bwd", ff, 2)
    _launch.check_inputs("ligru_recurrence_bwd", H, max_hidden,
                         ff=(ff, (T, B, 2 * H)), h=(h, (T, B, H)),
                         g=(g, (T, B, H)), u=(u, (H, 2 * H)),
                         mask=(mask, (B, H)))
    dff = torch.empty_like(ff)
    if T == 0:
        return dff, torch.zeros_like(u), torch.zeros_like(mask)
    du = torch.empty_like(u)
    dmask = torch.empty_like(mask)
    plan = bwd_plan(B, H)
    # the chain's scratch: the ping-pong buffer of dA, zeroed (its padding
    # pairs meet U's zero rows), and the grid barrier's counter
    dabuf = torch.zeros(plan["dabuf_floats"], device=ff.device,
                        dtype=torch.float32)
    bar = torch.zeros(1, device=ff.device, dtype=torch.int32)
    _launch.launch("ligru_bwd", entry,
                   (ff, h, g, u,
                    _pack_bwd(u, H, plan["units"], plan["row_floats"]), mask,
                    dff, du, dmask, dabuf, bar), T, B, H, (plan["units"],))
    bwd_launches += 1
    return dff, du, dmask


def bwd_plan(B: int, H: int) -> dict:
    """K1b's chain at (B, H) on the current card: its CTAs, the hidden
    units each owns, each CTA's shared-memory bytes, the units' dA pairs it
    stages at a time (`chunk`), the floats of a packed U row and of the dA
    ping-pong buffer.  Raises where the card cannot hold the grid at once,
    as the launch would."""
    return _launch.plan(BWD_SOURCE, "ligru_bwd", B, H, "row_floats",
                        "dabuf_floats")


class LiGRURecurrence(torch.autograd.Function):
    """h = recurrence(ff, u, mask) with the backward kernel as its
    gradient; mask is (B, H).  bf16 inputs (the bf16 compute mode) are
    widened to float32 at the boundary, as tpukaldi's wrapper casts them:
    the kernels compute and return h in float32 and the gradients come
    back in the primal dtypes.  The primal tensors are what is saved."""

    @staticmethod
    def forward(ctx, ff, u, mask):
        if ff.device.type == "cuda":
            _launch.refuse_wide_backward("ligru_recurrence_bwd", ctx,
                                         u.shape[0], BWD_SOURCE, "ligru_bwd")
        w = _launch.widen
        h = ligru_recurrence(w(ff), w(u), w(mask))
        ctx.save_for_backward(ff, u, mask, h)
        return h

    @staticmethod
    def backward(ctx, g):
        ff, u, mask, h = ctx.saved_tensors
        w = _launch.widen
        grads = ligru_recurrence_bwd(w(ff), h, g.contiguous(), w(u), w(mask))
        return tuple(d.to(p.dtype) for d, p in zip(grads, (ff, u, mask)))
