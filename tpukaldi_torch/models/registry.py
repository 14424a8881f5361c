"""Model registry: `arch_class` name -> the port's nn.Module class.

Cfgs name `arch_library = tpukaldi.models` (or the reference's
`neural_networks`); the port resolves those names from its own table and
never imports `tpukaldi.models`, which needs JAX.
"""

from __future__ import annotations

from typing import Dict, Type

from torch import nn

from .mlp import MLP
from .recurrent import GRU, LSTM, liGRU

LIBRARIES = ("tpukaldi.models", "tpukaldi_torch.models", "neural_networks")

_REGISTRY: Dict[str, Type[nn.Module]] = {
    "MLP": MLP, "liGRU": liGRU, "LSTM": LSTM, "GRU": GRU}

# tpukaldi's classes the port does not have yet (ROADMAP.md, queue 1)
NOT_PORTED = (
    "RNN", "minimalGRU", "QLSTM", "CNN", "SincNet",
    "logMelFb", "channel_averaging", "LSTM_cudnn", "GRU_cudnn", "RNN_cudnn",
    "fusionRNN", "fusionRNN_jit", "SRU", "PASE",
)


def resolve(class_name: str, library: str = "tpukaldi.models") -> Type[nn.Module]:
    if library not in LIBRARIES:
        raise KeyError(
            f"arch_library {library!r} is not one the port resolves "
            f"({', '.join(LIBRARIES)})")
    if class_name in _REGISTRY:
        return _REGISTRY[class_name]
    if class_name in NOT_PORTED:
        raise NotImplementedError(
            f"model class {class_name!r} is still to be ported to "
            f"tpukaldi_torch (ported: {', '.join(sorted(_REGISTRY))})")
    raise KeyError(f"unknown model class {class_name!r}")
