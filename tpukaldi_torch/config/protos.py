"""Built-in proto schemas (the type contracts of the INI config surface).

The reference ships these as `proto/*.proto` INI files; here they are
embedded Python tables so configs keep working without a proto directory.
When a cfg points `arch_proto`/`cfg_proto` at a file that exists on disk it
is parsed (same format); otherwise the basename resolves to a builtin.

Field sets mirror the reference's proto/ (global.proto, global_chunk.proto,
per-arch protos, optimizer protos, decoding.proto) so every shipped cfg of
the reference validates identically.
"""

from __future__ import annotations

import configparser
import os
from typing import Dict

Proto = Dict[str, Dict[str, str]]

GLOBAL: Proto = {
    "cfg_proto": {"cfg_proto": "path", "cfg_proto_chunk": "path"},
    "exp": {
        "cmd": "str",
        "run_nn_script": "str",
        "out_folder": "str",
        "seed": "int(-inf,inf)",
        "use_cuda": "bool",
        "multi_gpu": "bool",
        "save_gpumem": "bool",
        "N_epochs_tr": "int(1,inf)",
    },
    "dataset": {
        "data_name": "str",
        "fea": "str",
        "lab": "str",
        "N_chunks": "int(1,inf)",
    },
    "data_use": {
        "train_with": "list_str",
        "valid_with": "list_str",
        "forward_with": "list_str",
    },
    "batches": {
        "batch_size_train": "list_str",
        "max_seq_length_train": "list_str",
        "increase_seq_length_train": "bool",
        "start_seq_len_train": "int(20,inf)",
        "multply_factor_seq_len_train": "int(0,inf)",
        "batch_size_valid": "int(1,inf)",
        "max_seq_length_valid": "int(20,inf)",
    },
    "architecture": {
        "arch_name": "str",
        "arch_proto": "path",
        "arch_library": "str",
        "arch_class": "str",
        "arch_pretrain_file": "str",
        "arch_freeze": "bool",
        "arch_seq_model": "bool",
        "arch_lr": "list_str",
        "arch_halving_factor": "float(0,inf)",
        "arch_improvement_threshold": "float(0,inf)",
        "arch_opt": "{sgd,rmsprop,adam,none}",
    },
    "model": {"model_proto": "path", "model": "str"},
    "forward": {
        "forward_out": "str",
        "normalize_posteriors": "bool_list",
        "normalize_with_counts_from": "str",
        "save_out_file": "bool_list",
        "require_decoding": "bool_list",
    },
    "decoding": {
        "decoding_script_folder": "path",
        "decoding_script": "str",
        "decoding_proto": "path",
    },
}

GLOBAL_CHUNK: Proto = {
    "cfg_proto": GLOBAL["cfg_proto"],
    "exp": {
        "cmd": "str",
        "run_nn_script": "str",
        "to_do": "{train,valid,forward}",
        "seed": "int(-inf,inf)",
        "use_cuda": "bool",
        "multi_gpu": "bool",
        "save_gpumem": "bool",
        "out_info": "str",
        "N_epochs_tr": "int(1,inf)",
    },
    "data_chunk": {"fea": "str", "lab": "str"},
    "batches": {
        "batch_size_train": "int(0,inf)",
        "max_seq_length_train": "int(20,inf)",
        "batch_size_valid": "int(1,inf)",
        "max_seq_length_valid": "int(20,inf)",
    },
    "architecture": {
        **GLOBAL["architecture"],
        "arch_lr": "float(0,inf)",
    },
    "model": GLOBAL["model"],
    "forward": GLOBAL["forward"],
}

DECODING: Proto = {
    "proto": {
        "min_active": "int(0,inf)",
        "max_active": "int(0,inf)",
        "max_mem": "int(0,inf)",
        "beam": "float(0,inf)",
        "latbeam": "float(0,inf)",
        "acwt": "float(0,inf)",
        "max_arcs": "int(-inf,inf)",
        "scoring_opts": "str",
        "norm_vars": "bool",
        "skip_scoring": "bool",
    }
}


def _recurrent_proto(prefix: str) -> Proto:
    return {
        "proto": {
            f"{prefix}_lay": "str_list",
            f"{prefix}_drop": "str_list",
            f"{prefix}_use_laynorm_inp": "bool",
            f"{prefix}_use_batchnorm_inp": "bool",
            f"{prefix}_use_laynorm": "bool_list",
            f"{prefix}_use_batchnorm": "bool_list",
            f"{prefix}_bidir": "bool",
            f"{prefix}_act": "str_list",
            f"{prefix}_orthinit": "bool",
            f"{prefix}_remat": "bool",  # optional tpukaldi extension
        }
    }


def _cudnn_proto(extra: Dict[str, str] = None) -> Proto:
    base = {
        "hidden_size": "int",
        "num_layers": "int",
        "bias": "bool",
        "batch_first": "bool",
        "dropout": "float(0,1)",
        "bidirectional": "bool",
    }
    if extra:
        base.update(extra)
    return {"proto": base}


ARCH_PROTOS: Dict[str, Proto] = {
    "MLP.proto": {
        "proto": {
            "dnn_lay": "str_list",
            "dnn_drop": "str_list",
            "dnn_use_laynorm_inp": "bool",
            "dnn_use_batchnorm_inp": "bool",
            "dnn_use_batchnorm": "bool_list",
            "dnn_use_laynorm": "bool_list",
            "dnn_act": "str_list",
        }
    },
    "LSTM.proto": _recurrent_proto("lstm"),
    "GRU.proto": _recurrent_proto("gru"),
    "RNN.proto": _recurrent_proto("rnn"),
    "liGRU.proto": _recurrent_proto("ligru"),
    "minimalGRU.proto": _recurrent_proto("minimalgru"),
    "LSTM_cudnn.proto": _cudnn_proto(),
    "GRU_cudnn.proto": _cudnn_proto(),
    "RNN_cudnn.proto": _cudnn_proto({"nonlinearity": "str"}),
    "CNN.proto": {
        "proto": {
            "cnn_N_filt": "int_list(1,inf)",
            "cnn_len_filt": "int_list(1,inf)",
            "cnn_max_pool_len": "int_list(1,inf)",
            "cnn_use_laynorm_inp": "bool",
            "cnn_use_batchnorm_inp": "bool",
            "cnn_use_laynorm": "bool_list",
            "cnn_use_batchnorm": "bool_list",
            "cnn_act": "list_str",
            "cnn_drop": "str_list",
        }
    },
    "SincNet.proto": {
        "proto": {
            "sinc_N_filt": "int_list(1,inf)",
            "sinc_len_filt": "int_list(1,inf)",
            "sinc_max_pool_len": "int_list(1,inf)",
            "sinc_sample_rate": "int",
            "sinc_min_low_hz": "int",
            "sinc_min_band_hz": "int",
            "sinc_use_laynorm_inp": "bool",
            "sinc_use_batchnorm_inp": "bool",
            "sinc_use_laynorm": "bool_list",
            "sinc_use_batchnorm": "bool_list",
            "sinc_act": "list_str",
            "sinc_drop": "str_list",
        }
    },
    "SRU.proto": {
        "proto": {
            "sru_hidden_size": "int",
            "sru_num_layers": "int",
            "sru_dropout": "float(0,1)",
            "sru_rnn_dropout": "float(0,1)",
            "sru_use_tanh": "bool",
            "sru_use_relu": "bool",
            "sru_use_selu": "bool",
            "sru_weight_norm": "bool",
            "sru_layer_norm": "bool",
            "sru_bidirectional": "bool",
            "sru_is_input_normalized": "bool",
            "sru_has_skip_term": "bool",
            "sru_rescale": "bool",
            "sru_highway_bias": "float(-inf,0)",
            "sru_n_proj": "int",
        }
    },
    "QLSTM.proto": {
        "proto": {
            "lstm_lay": "str_list",
            "lstm_drop": "float_list(0.0,1.0)",
            "lstm_bidir": "bool",
            "lstm_act": "str_list",
            "quaternion_init": "str",
            "autograd": "bool",
        }
    },
    "PASE.proto": {"proto": {"pase_cfg": "str", "pase_model": "path"}},
    # the reference's DIRHA cfg names proto/fusionRNN.proto but never ships
    # it; this builtin supplies the schema
    "fusionRNN.proto": {
        "proto": {
            "fusionRNN_lay": "str_list",
            "fusionRNN_drop": "str_list",
            "fusionRNN_bidir": "bool",
            "fusionRNN_act": "str_list",
            "fusionRNN_do_fusion": "bool",
            "fusionRNN_fusion_layer_size": "int",
            "fusionRNN_number_of_mic": "int",
            "fusionRNN_fusion_act": "str",
            "fusionRNN_fusion_reduce": "str",
            "batches": "int",
        }
    },
    "logMelFb.proto": {
        "proto": {
            "logmelfb_nr_filt": "int",
            "logmelfb_stft_window_size": "int",
            "logmelfb_stft_window_shift": "int",
        }
    },
    "channelAvg.proto": {"proto": {"chAvg_channelWeights": "str"}},
}

# extension fields beyond the reference schema; never required in cfgs
# fusionRNN "batches" is injected at runtime by the reference, never
# present in cfgs; our implementation does not need it
OPTIONAL_FIELDS = {"ligru_impl", "lstm_impl", "gru_impl", "qlstm_impl",
                   "batches", "arch_grad_clip"} | {
    f"{p}_remat" for p in ("lstm", "gru", "rnn", "ligru", "minimalgru")
}
ARCH_PROTOS["liGRU.proto"]["proto"]["ligru_impl"] = "{auto,pallas,scan}"
ARCH_PROTOS["LSTM.proto"]["proto"]["lstm_impl"] = "{auto,pallas,scan}"
ARCH_PROTOS["GRU.proto"]["proto"]["gru_impl"] = "{auto,pallas,scan}"
ARCH_PROTOS["QLSTM.proto"]["proto"]["qlstm_impl"] = "{auto,pallas,scan}"

OPT_PROTOS: Dict[str, Proto] = {
    "sgd.proto": {
        "proto": {
            "opt_momentum": "float(0,inf)",
            "opt_weight_decay": "float(0,inf)",
            "opt_dampening": "float(0,inf)",
            "opt_nesterov": "bool",
        }
    },
    "adam.proto": {
        "proto": {
            "opt_betas": "float_list(0,inf)",
            "opt_eps": "float",
            "opt_weight_decay": "float(0,inf)",
            "opt_amsgrad": "bool",
        }
    },
    "rmsprop.proto": {
        "proto": {
            "opt_momentum": "float(0,inf)",
            "opt_alpha": "float(0,inf)",
            "opt_eps": "float",
            "opt_centered": "bool",
            "opt_weight_decay": "float(0,inf)",
        }
    },
    # refac01's arch_opt=none: no optimizer, no option fields
    "none.proto": {"proto": {}},
}

BUILTIN: Dict[str, Proto] = {
    "global.proto": GLOBAL,
    "global_refac01.proto": GLOBAL,
    "global_chunk.proto": GLOBAL_CHUNK,
    "global_chunk_refac01.proto": GLOBAL_CHUNK,
    "decoding.proto": DECODING,
    **ARCH_PROTOS,
    **OPT_PROTOS,
}


def load_proto_file(path: str) -> Proto:
    """Parse an on-disk .proto file (INI of `field=typespec` lines)."""
    parser = configparser.ConfigParser()
    parser.optionxform = str  # preserve case
    with open(path) as f:
        parser.read_string(f.read())
    return {sec: dict(parser[sec]) for sec in parser.sections()}


def resolve_proto(path: str) -> Proto:
    """Load a proto from disk if present, else fall back to the builtin with
    the same basename."""
    if path and os.path.isfile(path):
        return load_proto_file(path)
    base = os.path.basename(path) if path else ""
    if base in BUILTIN:
        return BUILTIN[base]
    raise KeyError(f"unknown proto {path!r} (not on disk, no builtin {base!r})")
