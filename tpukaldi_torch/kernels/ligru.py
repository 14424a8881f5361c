"""Li-GRU forward recurrence: the hand-written CUDA kernel and its plain
PyTorch version.

    r    = h @ U                  # U = [Uh | Uz], (H, 2H)
    z_t  = sigmoid(ffz_t + r_z)
    hc   = relu(ffh_t + r_h) * mask
    h_t  = z_t * h + (1 - z_t) * hc,   h_0 = 0

`ligru_recurrence` is the counterpart of tpukaldi's
`kernels/ligru.py::ligru_recurrence` (forward only).  On a CUDA tensor it
launches `csrc/ligru_fwd.cu` (design notes there); on a CPU tensor it runs
`ligru_recurrence_ref`, the Python time loop that mirrors tpukaldi's
`ligru_recurrence_scan`.  The backward kernel is not ported yet, so the CUDA
path refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from . import _build

SOURCE = "ligru_fwd.cu"

# kernel launches since the last reset; chip_smoke.py reads it to show that
# the main path went through the kernel
launches = 0


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
    cover the liGRU layers the kernel does not take."""
    H = ff.shape[-1] // 2
    h = ff.new_zeros((ff.shape[1], H))
    out = []
    for ff_t in ff:
        r = h @ u
        zt = torch.sigmoid(ff_t[:, H:] + r[:, H:])
        hc = act(ff_t[:, :H] + r[:, :H]) * mask
        h = zt * h + (1 - zt) * hc
        if ln is not None:
            h = ln(h)
        out.append(h)
    return torch.stack(out)


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    lib.tpk_ligru_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.tpk_ligru_fwd.restype = ctypes.c_int
    lib.tpk_ligru_fwd_max_hidden.argtypes = []
    lib.tpk_ligru_fwd_max_hidden.restype = ctypes.c_int
    return lib


def _check_cuda_inputs(ff, u, mask) -> None:
    T, B, H2 = ff.shape
    H = H2 // 2
    if H2 != 2 * H or u.shape != (H, 2 * H) or mask.shape != (B, H):
        raise ValueError(
            f"ligru_recurrence: expected ff (T, B, 2H), u (H, 2H), mask (B, H); "
            f"got {tuple(ff.shape)}, {tuple(u.shape)}, {tuple(mask.shape)}")
    for name, t in (("ff", ff), ("u", u), ("mask", mask)):
        if t.device != ff.device or t.device.type != "cuda":
            raise ValueError(f"ligru_recurrence: {name} is on {t.device}, "
                             f"expected the CUDA device of ff ({ff.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"ligru_recurrence: {name} is {t.dtype}, "
                            "the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"ligru_recurrence: {name} is not contiguous")
        if t.requires_grad:
            raise NotImplementedError(
                f"ligru_recurrence: {name} requires grad, but the backward "
                "kernel is not ported yet; call under torch.inference_mode()")


def ligru_recurrence(ff: torch.Tensor, u: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; the plain version on CPU."""
    global launches
    if ff.device.type == "cpu":
        return ligru_recurrence_ref(ff, u, mask)
    _check_cuda_inputs(ff, u, mask)
    T, B, H2 = ff.shape
    H = H2 // 2
    lib = _lib()
    max_h = lib.tpk_ligru_fwd_max_hidden()
    if H > max_h:
        raise ValueError(
            f"ligru_recurrence: H={H} exceeds the kernel's limit of {max_h} "
            "(one thread per hidden unit)")
    out = torch.empty((T, B, H), device=ff.device, dtype=torch.float32)
    if T == 0:
        return out
    with torch.cuda.device(ff.device):
        stream = torch.cuda.current_stream(ff.device).cuda_stream
        err = lib.tpk_ligru_fwd(ff.data_ptr(), u.data_ptr(), mask.data_ptr(),
                                out.data_ptr(), T, B, H, stream)
    if err != 0:
        raise RuntimeError(
            f"ligru_fwd kernel launch failed with CUDA error {err} "
            f"(T={T}, B={B}, H={H})")
    launches += 1
    return out
