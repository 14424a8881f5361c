"""What the kernel tools share: reading a build's sources, building several
builds at once, launching the port's wrappers on one of them, and timing a
call on the card.

The tools that use it (`conv_envelope`, `recurrence_envelope` and the
`*_phases` tools) run on the card; nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Tuple

import torch

from ..kernels import _build


def median_ms(fn, reps: int = 5) -> float:
    """The median of `reps` timed calls of `fn` after one untimed call, in
    ms, each between two CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def sources(src_dir: str, files: Tuple[str, ...]) -> Dict[str, str]:
    """The files as they are in `src_dir`, leaving out any it lacks (a
    design before a header has none)."""
    out = {}
    for name in files:
        path = os.path.join(src_dir, name)
        if os.path.exists(path):
            with open(path) as f:
                out[name] = f.read()
    return out


def build_variants(files: Dict[str, Dict[str, str]], stem: str,
                   srcs: Tuple[str, ...]) -> Dict[str, Dict[str, ctypes.CDLL]]:
    """The entries `srcs` of every build (name -> file -> text), one nvcc
    each, all at once, into build/tpukaldi_torch/variants/<stem>_v<i>/;
    prints ptxas's registers of each."""
    procs = {}
    for i, (name, texts) in enumerate(files.items()):
        d = os.path.join(_build.BUILD_DIR, "variants", f"{stem}_v{i}")
        os.makedirs(d, exist_ok=True)
        for fname, text in texts.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        for src in srcs:
            lib = os.path.join(d, f"lib{src[:-3]}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o", lib,
                   os.path.join(d, src)]
            procs[name, src] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs: Dict[str, Dict[str, ctypes.CDLL]] = {}
    for (name, src), (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {src}:\n{report}")
        regs = [line.split(":", 1)[1].strip() for line in report.splitlines()
                if "registers" in line]
        print(f"{name} {src}: {'; '.join(regs)}", flush=True)
        libs.setdefault(name, {})[src] = ctypes.CDLL(lib)
    return libs


class Use:
    """The port's wrappers launch `libs` (source -> library) inside."""

    def __init__(self, libs: Dict[str, ctypes.CDLL]):
        self.libs = libs

    def __enter__(self):
        self.saved = dict(_build._loaded)
        _build._loaded.update(self.libs)

    def __exit__(self, *exc):
        _build._loaded.clear()
        _build._loaded.update(self.saved)
