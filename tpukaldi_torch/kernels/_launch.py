"""What every kernel's wrapper does around its launch: bind the library's C
entry, check the tensors it is given, and launch on PyTorch's current
stream, raising on a refused launch.

Each library built from `csrc/<source>` exports `tpk_<name>(arguments...,
stream)`, which returns `cudaGetLastError()`, or SMEM_REFUSED where the
shapes need more shared memory than a block may use (the conv stack's
entries, `csrc/stack_tile.cuh::kErrSmem`).  A recurrence kernel's takes
(pointers..., T, B, H, ints...) and comes with `tpk_<name>_max_hidden()`,
the largest H it takes.

Each wrapper counts its launches in a module counter (`COUNTERS`).  A step
captured into a CUDA graph runs its wrappers once, at capture, and never
on a replay: the graph keeps what the capture counted (`read_counters`)
and adds it again at each replay (`add_counters`).
"""

from __future__ import annotations

import ctypes
import importlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import _build

SMEM_REFUSED = -1

# every wrapper module's launch counters (one per kernel)
COUNTERS = {
    "ligru": ("launches", "bwd_launches"),
    "lstm": ("launches", "bwd_launches", "lean_launches", "lean_bwd_launches",
             "lean_bf16_launches", "lean_bf16_bwd_launches"),
    "gru": ("launches", "bwd_launches"),
    "conv1d": ("launches", "bwd_launches", "ln_launches", "ln_bwd_launches"),
    "conv_stack": ("launches", "bwd_launches"),
}


def _module(name: str):
    return importlib.import_module(f"{__package__}.{name}")


def read_counters() -> Dict[Tuple[str, str], int]:
    """Every launch counter, by (module, counter)."""
    return {(mod, c): getattr(_module(mod), c)
            for mod, names in COUNTERS.items() for c in names}


def add_counters(delta: Dict[Tuple[str, str], int]) -> None:
    """Add `delta` (what `read_counters` gives) to the counters."""
    for (mod, c), n in delta.items():
        if n:
            m = _module(mod)
            setattr(m, c, getattr(m, c) + n)


def entry(source: str, name: str, argtypes: Sequence) -> Callable[..., int]:
    """Build (if needed) and load `csrc/<source>`; returns its C entry
    `tpk_<name>` taking `argtypes` and then the stream.  Pointers and the
    stream are c_void_p: as plain ints ctypes would cut them to 32 bits."""
    fn = getattr(_build.load(source), f"tpk_{name}")
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(name: str, fn: Callable[..., int], device: torch.device, args,
         what: str) -> None:
    """`fn(args..., stream)` on the current stream of `device`; raise if the
    launch was refused (ValueError for shapes past the shared memory)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err == SMEM_REFUSED:
        raise ValueError(f"{name}: {what} needs more shared memory than a "
                         f"block may use")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err} ({what})")


def bind(source: str, name: str, n_ptrs: int,
         n_ints: int) -> Tuple[Callable[..., int], int]:
    """Build (if needed) and load `csrc/<source>`; returns its entry
    `tpk_<name>` and that kernel's largest H."""
    entry_fn = entry(source, name,
                     [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints)
    return entry_fn, max_hidden(source, name)


def max_hidden(source: str, name: str) -> int:
    """The largest H of the kernel `tpk_<name>` of `csrc/<source>` (built
    if needed)."""
    fn = getattr(_build.load(source), f"tpk_{name}_max_hidden")
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


def check_hidden(fn: str, H: int, limit: int) -> None:
    """Raise a ValueError naming `fn` and its limit where H exceeds it."""
    if H > limit:
        raise ValueError(f"{fn}: H={H} exceeds the kernel's limit of {limit}")


def refuse_wide_backward(fn: str, ctx, H: int, source: str,
                         name: str) -> None:
    """In an autograd Function's forward on the card: where a gradient is
    wanted and H exceeds the backward kernel's limit (1024, below the
    forward kernels' 2048), raise the backward's ValueError before
    anything launches, so that no forward runs whose backward would be
    refused."""
    if any(ctx.needs_input_grad):
        check_hidden(fn, H, max_hidden(source, name))


def dims(fn: str, ff: torch.Tensor, gates: int) -> Tuple[int, int, int]:
    """(T, B, H) of a (T, B, gates * H) feed-forward input."""
    if ff.dim() != 3 or ff.shape[2] % gates:
        raise ValueError(f"{fn}: ff must be (T, B, {gates}H), got "
                         f"{tuple(ff.shape)}")
    T, B, GH = ff.shape
    return T, B, GH // gates


def check_tensors(fn: str, **tensors: Tuple[torch.Tensor, Tuple[int, ...],
                                            torch.dtype]) -> None:
    """Each (tensor, expected shape, dtype) given, contiguous, on one CUDA
    device, with its shape and dtype."""
    missing = [name for name, (t, _, _) in tensors.items() if t is None]
    if missing:
        raise ValueError(f"{fn}: {', '.join(missing)} not given")
    got = {name: tuple(t.shape) for name, (t, _, _) in tensors.items()}
    want = {name: tuple(shape) for name, (_, shape, _) in tensors.items()}
    if got != want:
        raise ValueError(f"{fn}: expected shapes {want}, got {got}")
    device = next(iter(tensors.values()))[0].device
    for name, (t, _, dtype) in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}, expected one "
                             f"CUDA device ({device})")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, the kernel takes "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")


def widen(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor widened to float32 (exact), any other as it is: the
    boundary cast in front of a kernel that takes float32 (tpukaldi's
    Pallas wrappers cast their bf16 inputs the same way)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def carry(dtype: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """How a plain recurrence loop keeps its state for inputs of `dtype`.
    In the bf16 compute mode tpukaldi's scan carries its state in bf16 while
    XLA computes each step's chain of elementwise ops in float32 (excess
    precision): so a loop given bf16 inputs widens them, computes each step
    in float32 and rounds the state it carries (and outputs) to bf16, which
    this returns; for any other dtype, the identity."""
    if dtype != torch.bfloat16:
        return lambda x: x
    return lambda x: x.to(torch.bfloat16).float()


def refuse_bf16(fn: str, *tensors: torch.Tensor) -> None:
    """Raise if a bf16 tensor reaches an entry without a bf16 path, on any
    device: the caller casts at the boundary (`widen`), nothing falls back
    to a plain version in bf16."""
    if any(t is not None and t.dtype == torch.bfloat16 for t in tensors):
        raise TypeError(f"{fn} takes float32: widen bf16 inputs at the "
                        "boundary (kernels/_launch.py::widen)")


def check_inputs(fn: str, H: int, limit: int,
                 dtypes: Optional[Dict[str, torch.dtype]] = None,
                 **tensors: Tuple[torch.Tensor, Tuple[int, ...]]) -> None:
    """Each (tensor, expected shape) contiguous, on one CUDA device, with
    its shape and dtype: float32, or what `dtypes` names for it (K4's bf16
    ff); H within the kernel's limit."""
    dtypes = dtypes or {}
    check_tensors(fn, **{name: (t, shape, dtypes.get(name, torch.float32))
                         for name, (t, shape) in tensors.items()})
    check_hidden(fn, H, limit)


def launch(name: str, entry_fn: Callable[..., int], ptrs, T: int, B: int,
           H: int, extra_ints=()) -> None:
    """Call `entry_fn(ptrs..., T, B, H, extra_ints..., stream)` on the
    current stream of the first tensor's device; raise if the launch was
    refused."""
    call(name, entry_fn, ptrs[0].device,
         (*(t.data_ptr() for t in ptrs), T, B, H, *extra_ints),
         f"T={T}, B={B}, H={H}")


def plan(source: str, name: str, B: int, H: int, *extra: str) -> dict:
    """A persistent kernel's launch at (B, H) from its `tpk_<name>_plan`,
    which fills 4 ints and then one for each name in `extra`."""
    fn = getattr(_build.load(source), f"tpk_{name}_plan")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keys = ("ctas", "units", "smem_bytes", "chunk", *extra)
    out = (ctypes.c_int * len(keys))()
    err = fn(B, H, out)
    if err != 0:
        raise RuntimeError(f"{name}: no cooperative launch at B={B}, "
                           f"H={H} (CUDA error {err})")
    return dict(zip(keys, out))
