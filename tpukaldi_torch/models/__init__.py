from .cnn import CNN, SincNet, channel_averaging, logMelFb
from .common import RefLayerNorm, act_fun  # noqa: F401
from .cudnn_like import GRU_cudnn, LSTM_cudnn, RNN_cudnn
from .fusion import FusionLinear, fusionRNN, fusionRNN_jit
from .mlp import MLP
from .pase import PASE
from .quaternion import QLSTM, QuaternionDense
from .recurrent import GRU, LSTM, RNN, liGRU, minimalGRU
from .registry import resolve  # noqa: F401
from .sru import SRU

__all__ = ["CNN", "GRU", "GRU_cudnn", "FusionLinear", "LSTM", "LSTM_cudnn",
           "MLP", "PASE", "QLSTM", "QuaternionDense", "RNN", "RNN_cudnn",
           "SRU", "SincNet", "channel_averaging", "fusionRNN",
           "fusionRNN_jit", "liGRU", "logMelFb", "minimalGRU",
           "RefLayerNorm", "act_fun", "resolve"]
