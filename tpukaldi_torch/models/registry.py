"""Model registry: `arch_class` name -> the port's nn.Module class.

Cfgs name `arch_library = tpukaldi.models` (or the reference's
`neural_networks`); the port resolves those names from its own table and
never imports `tpukaldi.models` (nor anything else of tpukaldi).
"""

from __future__ import annotations

from typing import Dict, Type

from torch import nn

from .cnn import CNN, SincNet, channel_averaging, logMelFb
from .cudnn_like import GRU_cudnn, LSTM_cudnn, RNN_cudnn
from .fusion import fusionRNN, fusionRNN_jit
from .mlp import MLP
from .pase import PASE
from .quaternion import QLSTM
from .recurrent import GRU, LSTM, RNN, liGRU, minimalGRU
from .sru import SRU

LIBRARIES = ("tpukaldi.models", "tpukaldi_torch.models", "neural_networks")

_REGISTRY: Dict[str, Type[nn.Module]] = {
    "MLP": MLP, "liGRU": liGRU, "LSTM": LSTM, "GRU": GRU, "QLSTM": QLSTM,
    "CNN": CNN, "SincNet": SincNet, "RNN": RNN, "minimalGRU": minimalGRU,
    "LSTM_cudnn": LSTM_cudnn, "GRU_cudnn": GRU_cudnn, "RNN_cudnn": RNN_cudnn,
    "SRU": SRU, "fusionRNN": fusionRNN, "fusionRNN_jit": fusionRNN_jit,
    "logMelFb": logMelFb, "channel_averaging": channel_averaging,
    "PASE": PASE}


def resolve(class_name: str, library: str = "tpukaldi.models") -> Type[nn.Module]:
    if library not in LIBRARIES:
        raise KeyError(
            f"arch_library {library!r} is not one the port resolves "
            f"({', '.join(LIBRARIES)})")
    if class_name in _REGISTRY:
        return _REGISTRY[class_name]
    raise KeyError(f"unknown model class {class_name!r}")
