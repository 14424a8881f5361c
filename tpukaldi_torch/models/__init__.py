from .common import RefLayerNorm, act_fun  # noqa: F401
from .mlp import MLP
from .quaternion import QLSTM, QuaternionDense
from .recurrent import GRU, LSTM, liGRU
from .registry import resolve  # noqa: F401

__all__ = ["GRU", "LSTM", "MLP", "QLSTM", "QuaternionDense", "liGRU",
           "RefLayerNorm", "act_fun", "resolve"]
