from .cnn import CNN, SincNet
from .common import RefLayerNorm, act_fun  # noqa: F401
from .mlp import MLP
from .quaternion import QLSTM, QuaternionDense
from .recurrent import GRU, LSTM, liGRU
from .registry import resolve  # noqa: F401

__all__ = ["CNN", "GRU", "LSTM", "MLP", "QLSTM", "QuaternionDense",
           "SincNet", "liGRU", "RefLayerNorm", "act_fun", "resolve"]
