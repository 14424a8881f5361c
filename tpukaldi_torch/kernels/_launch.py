"""What every recurrence kernel's wrapper does around its launch: bind the
library's C entry, check the tensors it is given, and launch on PyTorch's
current stream, raising on a refused launch.

Each library built from `csrc/<source>` exports `tpk_<name>(pointers...,
ints..., stream)`, which returns `cudaGetLastError()`, and
`tpk_<name>_max_hidden()`, the largest H it takes (one thread per hidden
unit).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from . import _build


def bind(source: str, name: str, n_ptrs: int,
         n_ints: int) -> Tuple[Callable[..., int], int]:
    """Build (if needed) and load `csrc/<source>`; returns its entry
    `tpk_<name>` and that kernel's largest H."""
    lib = _build.load(source)
    entry = getattr(lib, f"tpk_{name}")
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    entry.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                      + [ctypes.c_void_p])
    entry.restype = ctypes.c_int
    max_hidden = getattr(lib, f"tpk_{name}_max_hidden")
    max_hidden.argtypes = []
    max_hidden.restype = ctypes.c_int
    return entry, max_hidden()


def dims(fn: str, ff: torch.Tensor, gates: int) -> Tuple[int, int, int]:
    """(T, B, H) of a (T, B, gates * H) feed-forward input."""
    if ff.dim() != 3 or ff.shape[2] % gates:
        raise ValueError(f"{fn}: ff must be (T, B, {gates}H), got "
                         f"{tuple(ff.shape)}")
    T, B, GH = ff.shape
    return T, B, GH // gates


def check_inputs(fn: str, H: int, max_hidden: int,
                 **tensors: Tuple[torch.Tensor, Tuple[int, ...]]) -> None:
    """Each (tensor, expected shape) float32, contiguous, on one CUDA
    device, with its shape; H within the kernel's limit."""
    got = {name: tuple(t.shape) for name, (t, _) in tensors.items()}
    want = {name: tuple(shape) for name, (_, shape) in tensors.items()}
    if got != want:
        raise ValueError(f"{fn}: expected shapes {want}, got {got}")
    device = next(iter(tensors.values()))[0].device
    for name, (t, _) in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}, expected one "
                             f"CUDA device ({device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} is {t.dtype}, the kernel takes "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    if H > max_hidden:
        raise ValueError(f"{fn}: H={H} exceeds the kernel's limit of "
                         f"{max_hidden} (one thread per hidden unit)")


def launch(name: str, entry: Callable[..., int], ptrs, T: int, B: int,
           H: int, extra_ints=()) -> None:
    """Call `entry(ptrs..., T, B, H, extra_ints..., stream)` on the current
    stream of the first tensor's device; raise if the launch was refused."""
    device = ptrs[0].device
    with torch.cuda.device(device):
        err = entry(*(t.data_ptr() for t in ptrs), T, B, H, *extra_ints,
                    torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err} (T={T}, B={B}, H={H})")
