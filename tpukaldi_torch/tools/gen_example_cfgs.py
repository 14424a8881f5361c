"""Generate the shipped example cfgs (cfg/) — tpukaldi equivalents of the
reference baseline corpus: 27 TIMIT (incl. TIMIT_rev joint training), 5
Librispeech, 5 DIRHA recipes (reference cfg/TIMIT_baselines/*,
Librispeech_baselines/*, DIRHA_baselines/*), plus a minimalGRU extra.
Data paths use $KALDI_TIMIT / $KALDI_LIBRI / $KALDI_DIRHA placeholders the
user substitutes for their Kaldi egs tree.

  python -m tpukaldi_torch.tools.gen_example_cfgs [cfg_dir]
"""

from __future__ import annotations

import os
import sys

HEADER = """\
[cfg_proto]
cfg_proto = proto/global.proto
cfg_proto_chunk = proto/global_chunk.proto

[exp]
cmd =
run_nn_script = run_nn
out_folder = exp/{exp_name}
seed = 2234
use_cuda = False
multi_gpu = False
save_gpumem = False
n_epochs_tr = {n_epochs}
"""

SGD_TAIL = """\
arch_lr = {lr}
arch_halving_factor = 0.5
arch_improvement_threshold = 0.001
arch_opt = sgd
opt_momentum = 0.0
opt_weight_decay = 0.0
opt_dampening = 0.0
opt_nesterov = False
"""

RMSPROP_TAIL = """\
arch_lr = {lr}
arch_halving_factor = 0.5
arch_improvement_threshold = 0.001
arch_opt = rmsprop
opt_momentum = 0.0
opt_alpha = 0.95
opt_eps = 1e-8
opt_centered = False
opt_weight_decay = 0.0
"""

ADAM_TAIL = """\
arch_lr = {lr}
arch_halving_factor = 0.5
arch_improvement_threshold = 0.001
arch_opt = adam
opt_betas = 0.9,0.999
opt_eps = 1e-8
opt_weight_decay = 1e-7
opt_amsgrad = False
"""


def _fea_opts(root, split, sub, deltas):
    return (
        f"apply-cmvn --utt2spk=ark:{root}/data/{split}/utt2spk "
        f"ark:{root}/{sub}/cmvn_{split}.ark ark:- ark:- | "
        f"add-deltas --delta-order={deltas} ark:- ark:- |"
    )


def _fea_stream(root, split, name, sub, cw, deltas=0, lst=None, opts=None):
    lst = lst or f"{root}/data/{split}/feats_{name}.scp"
    opts = opts if opts is not None else _fea_opts(root, split, sub, deltas)
    return (
        f"fea_name={name}\n"
        f"\tfea_lst={lst}\n"
        f"\tfea_opts={opts}\n"
        f"\tcw_left={cw}\n"
        f"\tcw_right={cw}\n"
    )


# the three standard TIMIT feature streams (mfcc has delta-order 2, like the
# reference quick_test recipes)
def timit_streams(root, split, cw, only=None):
    streams = {
        "mfcc": _fea_stream(root, split, "mfcc", "mfcc", cw, deltas=2),
        "fbank": _fea_stream(root, split, "fbank", "fbank", cw),
        "fmllr": _fea_stream(root, split, "fmllr", "fmllr", cw),
    }
    names = only or list(streams)
    return [streams[n] for n in names]


def lab_block(root, split, ali, mono=True):
    lab = f"""lab = lab_name=lab_cd
\tlab_folder={root}/exp/{ali}
\tlab_opts=ali-to-pdf
\tlab_count_file=auto
\tlab_data_folder={root}/data/{split}/
\tlab_graph={root}/exp/tri3/graph
"""
    if mono:
        lab = lab.rstrip("\n") + f"""
\tlab_name=lab_mono
\tlab_folder={root}/exp/{ali}
\tlab_opts=ali-to-phones --per-frame=true
\tlab_count_file=none
\tlab_data_folder={root}/data/{split}/
\tlab_graph={root}/exp/tri3/graph
"""
    return lab


PROD_LAB = """lab = lab_name=none
\tlab_data_folder={root}/data/{split}/
\tlab_graph={root}/exp/tri3/graph
"""


def dataset_block(idx, name, streams, lab, n_chunks):
    # join streams with the blank-tab separator the reference uses
    fea = "fea = " + "\n\t\n\t".join(s.rstrip("\n") for s in streams)
    return f"""
[dataset{idx}]
data_name = {name}
{fea}

{lab}
n_chunks = {n_chunks}
"""


DATA_USE = """
[data_use]
train_with = {tr}
valid_with = {dev}
forward_with = {te}
"""

BATCHES = """
[batches]
batch_size_train = {bs}
max_seq_length_train = {msl}
increase_seq_length_train = {curr}
start_seq_len_train = 100
multply_factor_seq_len_train = 2
batch_size_valid = {bs_valid}
max_seq_length_valid = 1000
"""

FORWARD_DECODING = """
[forward]
forward_out = {fwd_out}
normalize_posteriors = True
normalize_with_counts_from = lab_cd
save_out_file = False
require_decoding = True

[decoding]
decoding_script_folder = kaldi_decoding_scripts/
decoding_script = decode_dnn.sh
decoding_proto = proto/decoding.proto
min_active = 200
max_active = 7000
max_mem = 50000000
beam = 13.0
latbeam = 8.0
acwt = {acwt}
max_arcs = -1
skip_scoring = false
scoring_script = local/score.sh
scoring_opts = "--min-lmwt 1 --max-lmwt 10"
norm_vars = False
"""


def mlp_arch(idx, name, lay, drop, bn, act, lr, tail=None):
    n = len(lay.split(","))
    return f"""
[architecture{idx}]
arch_name = {name}
arch_proto = proto/MLP.proto
arch_library = tpukaldi.models
arch_class = MLP
arch_pretrain_file = none
arch_freeze = False
arch_seq_model = False
dnn_lay = {lay}
dnn_drop = {drop}
dnn_use_laynorm_inp = False
dnn_use_batchnorm_inp = False
dnn_use_batchnorm = {bn}
dnn_use_laynorm = {",".join(["False"] * n)}
dnn_act = {act}
""" + (tail or SGD_TAIL).format(lr=lr)


def recurrent_arch(idx, name, cls, prefix, lay, drop, bn, act, lr,
                   opt_tail=None, extra=""):
    n = len(lay.split(","))
    return f"""
[architecture{idx}]
arch_name = {name}
arch_proto = proto/{cls}.proto
arch_library = tpukaldi.models
arch_class = {cls}
arch_pretrain_file = none
arch_freeze = False
arch_seq_model = True
{prefix}_lay = {lay}
{prefix}_drop = {drop}
{prefix}_use_laynorm_inp = False
{prefix}_use_batchnorm_inp = False
{prefix}_use_laynorm = {",".join(["False"] * n)}
{prefix}_use_batchnorm = {bn}
{prefix}_bidir = True
{prefix}_act = {act}
{prefix}_orthinit = True
{extra}""" + (opt_tail or RMSPROP_TAIL).format(lr=lr)


def model_block(lines, fwd_out=None):
    joined = "\n\t".join(lines)
    return f"""
[model]
model_proto = proto/model.proto
model = {joined}
"""


TIMIT_ALI = {"train": "dnn4_pretrain-dbn_dnn_ali",
             "dev": "dnn4_pretrain-dbn_dnn_ali_dev",
             "test": "dnn4_pretrain-dbn_dnn_ali_test"}
TIMIT_SPLITS = [("TIMIT_tr", "train", 5), ("TIMIT_dev", "dev", 1),
                ("TIMIT_test", "test", 1)]
ROOT_TIMIT = "$KALDI_TIMIT"


def timit_datasets(cw, mono=True, only=None, prod=False):
    out = ""
    for i, (name, split, nck) in enumerate(TIMIT_SPLITS, start=1):
        out += dataset_block(
            i, name, timit_streams(ROOT_TIMIT, split, cw, only=only),
            lab_block(ROOT_TIMIT, split, TIMIT_ALI[split], mono=mono), nck,
        )
    if prod:
        out += dataset_block(
            4, "TIMIT_prod",
            timit_streams(ROOT_TIMIT, "test", cw, only=only),
            PROD_LAB.format(root=ROOT_TIMIT, split="test"), 1,
        )
    return out


# ---------------------------------------------------------------------------
# TIMIT: MLP family
# ---------------------------------------------------------------------------


def timit_mlp_mfcc_basic():
    """Reference TIMIT_MLP_mfcc_basic.cfg: the 4x1024 tutorial recipe
    (PER ~18.1, README.md:219)."""
    cfg = HEADER.format(exp_name="TIMIT_MLP_mfcc_basic", n_epochs=24)
    cfg += timit_datasets(5, mono=False, only=["mfcc"])
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_test")
    cfg += BATCHES.format(bs=128, msl=1000, curr="False", bs_valid=128)
    cfg += mlp_arch(
        1, "MLP_layers1", "1024,1024,1024,1024,N_out_lab_cd",
        "0.15,0.15,0.15,0.15,0.0", "True,True,True,True,False",
        "relu,relu,relu,relu,softmax", 0.08,
    )
    cfg += model_block(
        ["out_dnn1=compute(MLP_layers1,mfcc)",
         "loss_final=cost_nll(out_dnn1,lab_cd)",
         "err_final=cost_err(out_dnn1,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn1", acwt=0.2)
    return cfg


def timit_mlp_mfcc_basic_flex():
    """Reference TIMIT_MLP_mfcc_basic_flex.cfg: per-epoch scheduler syntax
    (val*N | val*M) on batch size, seq length, lr, and dropout."""
    cfg = timit_mlp_mfcc_basic()
    cfg = cfg.replace("out_folder = exp/TIMIT_MLP_mfcc_basic",
                      "out_folder = exp/TIMIT_MLP_mfcc_basic_flex")
    cfg = cfg.replace("batch_size_train = 128",
                      "batch_size_train = 128*12 | 64*10 | 32*2")
    cfg = cfg.replace("max_seq_length_train = 1000",
                      "max_seq_length_train = 1000*18 | 500*6")
    cfg = cfg.replace(
        "arch_lr = 0.08",
        "arch_lr = 0.08*10|0.04*5|0.02*3|0.01*2|0.005*2|0.0025*2",
    )
    cfg = cfg.replace(
        "dnn_drop = 0.15,0.15,0.15,0.15,0.0",
        "dnn_drop = 0.15*12|0.20*12,0.15,0.15*10|0.20*14,0.15,0.0",
    )
    return cfg


def timit_mlp(fea):
    """Reference TIMIT_MLP_{mfcc,fbank,fmllr}.cfg: 5x1024 MLP body with
    joint cd+mono heads; all three corpus streams listed, one computed."""
    cfg = HEADER.format(exp_name=f"TIMIT_MLP_{fea}", n_epochs=24)
    cfg += timit_datasets(5)
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_test")
    cfg += BATCHES.format(bs=128, msl=1000, curr="False", bs_valid=128)
    cfg += mlp_arch(
        1, "MLP_layers1", "1024,1024,1024,1024,1024",
        "0.15,0.15,0.15,0.15,0.15", "True,True,True,True,True",
        "relu,relu,relu,relu,relu", 0.08,
    )
    cfg += mlp_arch(2, "MLP_layers2", "N_out_lab_cd", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += mlp_arch(3, "MLP_layers3", "N_out_lab_mono", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += model_block(
        [f"out_dnn1=compute(MLP_layers1,{fea})",
         "out_dnn2=compute(MLP_layers2,out_dnn1)",
         "out_dnn3=compute(MLP_layers3,out_dnn1)",
         "loss_mono=cost_nll(out_dnn3,lab_mono)",
         "loss_mono_w=mult_constant(loss_mono,1.0)",
         "loss_cd=cost_nll(out_dnn2,lab_cd)",
         "loss_final=sum(loss_cd,loss_mono_w)",
         "err_final=cost_err(out_dnn2,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn2", acwt=0.2)
    return cfg


def timit_mlp_fbank_autoencoder():
    """Reference TIMIT_MLP_fbank_autoencoder.cfg: bottleneck encoder/decoder
    trained with mse reconstruction; forward emits the 100-d bottleneck
    without posterior normalization or decoding."""
    cfg = HEADER.format(exp_name="TIMIT_MLP_fbank_autoencoder", n_epochs=24)
    cfg += timit_datasets(5, mono=False, only=["fbank"])
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_test")
    cfg += BATCHES.format(bs=128, msl=1000, curr="False", bs_valid=128)
    cfg += mlp_arch(1, "MLP_encoder", "1024,100", "0.15,0.15", "True,True",
                    "relu,linear", 0.08)
    # decoder reconstructs the 440-d spliced fbank (40 x (5+5+1))
    cfg += mlp_arch(2, "MLP_decoder", "1024,440", "0.15,0.0", "True,False",
                    "relu,linear", 0.08)
    cfg += model_block(
        ["enc_out=compute(MLP_encoder,fbank)",
         "dec_out=compute(MLP_decoder,enc_out)",
         "loss_final=mse(dec_out,fbank)",
         "err_final=cost_err(dec_out,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="enc_out", acwt=0.2)
    cfg = cfg.replace("normalize_posteriors = True",
                      "normalize_posteriors = False")
    cfg = cfg.replace("normalize_with_counts_from = lab_cd",
                      "normalize_with_counts_from = None")
    cfg = cfg.replace("save_out_file = False", "save_out_file = True")
    cfg = cfg.replace("require_decoding = True", "require_decoding = False")
    return cfg


def timit_mlp_fbank_prod():
    """Reference TIMIT_MLP_fbank_prod.cfg: a 4th dataset with lab_name=none
    (production/transcription mode) — decode targets come from the
    lab_data_folder/lab_graph kept in the none block."""
    cfg = HEADER.format(exp_name="TIMIT_MLP_fbank", n_epochs=24)
    cfg += timit_datasets(5, prod=True)
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_prod")
    cfg += BATCHES.format(bs=128, msl=1000, curr="False", bs_valid=128)
    cfg += mlp_arch(
        1, "MLP_layers1", "1024,1024,1024,1024,1024",
        "0.15,0.15,0.15,0.15,0.15", "True,True,True,True,True",
        "relu,relu,relu,relu,relu", 0.08,
    )
    cfg += mlp_arch(2, "MLP_layers2", "N_out_lab_cd", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += mlp_arch(3, "MLP_layers3", "N_out_lab_mono", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += model_block(
        ["out_dnn1=compute(MLP_layers1,fbank)",
         "out_dnn2=compute(MLP_layers2,out_dnn1)",
         "out_dnn3=compute(MLP_layers3,out_dnn1)",
         "loss_mono=cost_nll(out_dnn3,lab_mono)",
         "loss_mono_w=mult_constant(loss_mono,1.0)",
         "loss_cd=cost_nll(out_dnn2,lab_cd)",
         "loss_final=sum(loss_cd,loss_mono_w)",
         "err_final=cost_err(out_dnn2,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn2", acwt=0.2)
    return cfg


# ---------------------------------------------------------------------------
# TIMIT: recurrent family (LSTM / GRU / liGRU / RNN / minimalGRU x features)
# ---------------------------------------------------------------------------

RECURRENT_ACTS = {"LSTM": "tanh", "GRU": "tanh", "RNN": "tanh",
                  "liGRU": "relu", "minimalGRU": "tanh"}
RECURRENT_PREFIX = {"LSTM": "lstm", "GRU": "gru", "RNN": "rnn",
                    "liGRU": "ligru", "minimalGRU": "minimalgru"}


def timit_recurrent(cls, fea, lr_schedule=False, exp_suffix="",
                    compute_dtype=None):
    """Reference TIMIT_{LSTM,GRU,RNN,liGRU}_{mfcc,fbank,fmllr}.cfg: 5x550
    bidirectional body + joint cd/mono MLP heads, rmsprop 0.0004.
    `compute_dtype` emits the tpukaldi mixed-precision extension field."""
    prefix = RECURRENT_PREFIX[cls]
    act = RECURRENT_ACTS[cls]
    name = f"TIMIT_{cls}_{fea}{exp_suffix}"
    cfg = HEADER.format(exp_name=name, n_epochs=24)
    if compute_dtype:
        cfg = cfg.replace(
            "run_nn_script = run_nn",
            f"run_nn_script = run_nn\ncompute_dtype = {compute_dtype}",
            1,
        )
    cfg += timit_datasets(0)
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_test")
    cfg += BATCHES.format(bs=8, msl=1000, curr="True", bs_valid=8)
    lr = ("0.0004*10|0.0002*4|0.0001*4|0.00005*2|0.000025*2|0.0000125*2"
          if lr_schedule else 0.0004)
    extra = "ligru_impl = auto\n" if cls == "liGRU" else ""
    cfg += recurrent_arch(
        1, f"{cls}_layers", cls, prefix, ",".join(["550"] * 5),
        ",".join(["0.2"] * 5), ",".join(["True"] * 5),
        ",".join([act] * 5), lr, extra=extra,
    )
    cfg += mlp_arch(2, "MLP_layers", "N_out_lab_cd", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += mlp_arch(3, "MLP_layers2", "N_out_lab_mono", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += model_block(
        [f"out_dnn1=compute({cls}_layers,{fea})",
         "out_dnn2=compute(MLP_layers,out_dnn1)",
         "out_dnn3=compute(MLP_layers2,out_dnn1)",
         "loss_mono=cost_nll(out_dnn3,lab_mono)",
         "loss_mono_w=mult_constant(loss_mono,1.0)",
         "loss_cd=cost_nll(out_dnn2,lab_cd)",
         "loss_final=sum(loss_cd,loss_mono_w)",
         "err_final=cost_err(out_dnn2,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn2", acwt=0.2)
    return cfg


def timit_lstm_fmllr_cudnn():
    """Reference TIMIT_LSTM_fmllr_cudnn.cfg: the stacked-kernel LSTM variant
    (nn.LSTM there; fused multi-layer scan here)."""
    cfg = HEADER.format(exp_name="TIMIT_LSTM_fmllr_cudnn", n_epochs=24)
    cfg += timit_datasets(0)
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_test")
    cfg += BATCHES.format(bs=8, msl=1000, curr="True", bs_valid=8)
    cfg += f"""
[architecture1]
arch_name = LSTM_cudnn_layers
arch_proto = proto/LSTM_cudnn.proto
arch_library = tpukaldi.models
arch_class = LSTM_cudnn
arch_pretrain_file = none
arch_freeze = False
arch_seq_model = True
hidden_size = 550
num_layers = 4
bias = True
batch_first = True
dropout = 0.2
bidirectional = True
""" + RMSPROP_TAIL.format(lr=0.0016)
    cfg += mlp_arch(2, "MLP_layers", "N_out_lab_cd", "0.0", "False",
                    "softmax", 0.0016, tail=RMSPROP_TAIL)
    cfg += mlp_arch(3, "MLP_layers2", "N_out_lab_mono", "0.0", "False",
                    "softmax", 0.0016, tail=RMSPROP_TAIL)
    cfg += model_block(
        ["out_dnn1=compute(LSTM_cudnn_layers,fmllr)",
         "out_dnn2=compute(MLP_layers,out_dnn1)",
         "out_dnn3=compute(MLP_layers2,out_dnn1)",
         "loss_mono=cost_nll(out_dnn3,lab_mono)",
         "loss_mono_w=mult_constant(loss_mono,1.0)",
         "loss_cd=cost_nll(out_dnn2,lab_cd)",
         "loss_final=sum(loss_cd,loss_mono_w)",
         "err_final=cost_err(out_dnn2,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn2", acwt=0.2)
    return cfg


def timit_sru_fbank():
    """Reference TIMIT_SRU_fbank.cfg (PER 16.6): native SRU, adam."""
    cfg = HEADER.format(exp_name="TIMIT_SRU_fbank", n_epochs=24)
    cfg += timit_datasets(0)
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_test")
    cfg += BATCHES.format(bs=8, msl=1000, curr="True", bs_valid=8)
    cfg += f"""
[architecture1]
arch_name = SRU_layers
arch_proto = proto/SRU.proto
arch_library = tpukaldi.models
arch_class = SRU
arch_pretrain_file = none
arch_freeze = False
arch_seq_model = True
sru_hidden_size = 550
sru_num_layers = 4
sru_dropout = 0.1
sru_rnn_dropout = 0.1
sru_use_tanh = False
sru_use_relu = False
sru_use_selu = False
sru_weight_norm = False
sru_layer_norm = False
sru_bidirectional = True
sru_is_input_normalized = False
sru_has_skip_term = True
sru_rescale = True
sru_highway_bias = -1
sru_n_proj = 0
""" + ADAM_TAIL.format(lr=0.001)
    cfg += mlp_arch(2, "MLP_layers", "N_out_lab_cd", "0.0", "False",
                    "softmax", 0.001, tail=ADAM_TAIL)
    cfg += mlp_arch(3, "MLP_layers2", "N_out_lab_mono", "0.0", "False",
                    "softmax", 0.001, tail=ADAM_TAIL)
    cfg += model_block(
        ["out_dnn1=compute(SRU_layers,fbank)",
         "out_dnn2=compute(MLP_layers,out_dnn1)",
         "out_dnn3=compute(MLP_layers2,out_dnn1)",
         "loss_mono=cost_nll(out_dnn3,lab_mono)",
         "loss_mono_w=mult_constant(loss_mono,1.0)",
         "loss_cd=cost_nll(out_dnn2,lab_cd)",
         "loss_final=sum(loss_cd,loss_mono_w)",
         "err_final=cost_err(out_dnn2,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn2", acwt=0.2)
    return cfg


# ---------------------------------------------------------------------------
# TIMIT: convolutional / raw-waveform family
# ---------------------------------------------------------------------------


def timit_cnn_fbank():
    """Reference TIMIT_CNN_fbank.cfg: 1-D CNN over spliced fbank + MLP."""
    cfg = HEADER.format(exp_name="TIMIT_CNN_fbank", n_epochs=24)
    cfg += timit_datasets(5, mono=False, only=["fbank"])
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_test")
    cfg += BATCHES.format(bs=128, msl=1000, curr="False", bs_valid=128)
    cfg += f"""
[architecture1]
arch_name = CNN_layers
arch_proto = proto/CNN.proto
arch_library = tpukaldi.models
arch_class = CNN
arch_pretrain_file = none
arch_freeze = False
arch_seq_model = False
cnn_n_filt = 80,60,60
cnn_len_filt = 10,3,3
cnn_max_pool_len = 3,2,1
cnn_use_laynorm_inp = False
cnn_use_batchnorm_inp = False
cnn_use_laynorm = True,True,True
cnn_use_batchnorm = False,False,False
cnn_act = relu,relu,relu
cnn_drop = 0.15,0.15,0.15
""" + SGD_TAIL.format(lr=0.08)
    cfg += mlp_arch(
        2, "MLP_layers", "1024,N_out_lab_cd", "0.15,0.0", "True,False",
        "relu,softmax", 0.08,
    )
    cfg += model_block(
        ["out_cnn=compute(CNN_layers,fbank)",
         "out_dnn=compute(MLP_layers,out_cnn)",
         "loss_final=cost_nll(out_dnn,lab_cd)",
         "err_final=cost_err(out_dnn,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn", acwt=0.2)
    return cfg


RAW_STREAM = """fea_name=raw
\tfea_lst={root}/data/raw_200ms/{split}/feats_raw.scp
\tfea_opts=copy-feats ark:- ark:- |
\tcw_left=0
\tcw_right=0
"""


def _timit_raw_datasets():
    out = ""
    for i, (name, split, nck) in enumerate(TIMIT_SPLITS, start=1):
        out += dataset_block(
            i, name, [RAW_STREAM.format(root=ROOT_TIMIT, split=split)],
            lab_block(ROOT_TIMIT, split, TIMIT_ALI[split], mono=False), nck,
        )
    return out


def timit_cnn_raw():
    """Reference TIMIT_CNN_raw.cfg (PER 18.1): plain conv front-end over raw
    samples (SincNet class with standard conv init there too)."""
    cfg = HEADER.format(exp_name="TIMIT_CNN_raw", n_epochs=24)
    cfg += _timit_raw_datasets()
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_test")
    cfg += BATCHES.format(bs=128, msl=1000, curr="False", bs_valid=128)
    cfg += f"""
[architecture1]
arch_name = CNN_layers
arch_proto = proto/CNN.proto
arch_library = tpukaldi.models
arch_class = CNN
arch_pretrain_file = none
arch_freeze = False
arch_seq_model = False
cnn_n_filt = 128,60,60,60
cnn_len_filt = 129,5,5,3
cnn_max_pool_len = 3,3,3,2
cnn_use_laynorm_inp = True
cnn_use_batchnorm_inp = False
cnn_use_laynorm = True,True,True,True
cnn_use_batchnorm = False,False,False,False
cnn_act = relu,relu,relu,relu
cnn_drop = 0.15,0.15,0.15,0.15
""" + RMSPROP_TAIL.format(lr=0.0008)
    cfg += mlp_arch(
        2, "MLP_layers", "2048,2048,N_out_lab_cd", "0.15,0.15,0.0",
        "True,True,False", "leaky_relu,leaky_relu,softmax", 0.0008,
        tail=RMSPROP_TAIL,
    )
    cfg += model_block(
        ["out_cnn=compute(CNN_layers,raw)",
         "out_dnn=compute(MLP_layers,out_cnn)",
         "loss_final=cost_nll(out_dnn,lab_cd)",
         "err_final=cost_err(out_dnn,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn", acwt=0.2)
    return cfg


def timit_sincnet_raw():
    """Reference TIMIT_SincNet_raw.cfg (PER 17.2): parametric sinc filters
    over raw 200 ms windows."""
    cfg = HEADER.format(exp_name="TIMIT_SincNet_raw", n_epochs=24)
    cfg += _timit_raw_datasets()
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_test")
    cfg += BATCHES.format(bs=128, msl=1000, curr="False", bs_valid=128)
    cfg += f"""
[architecture1]
arch_name = SincNet_layers
arch_proto = proto/SincNet.proto
arch_library = tpukaldi.models
arch_class = SincNet
arch_pretrain_file = none
arch_freeze = False
arch_seq_model = False
sinc_n_filt = 80,60,60
sinc_len_filt = 129,5,3
sinc_max_pool_len = 3,3,3
sinc_sample_rate = 16000
sinc_min_low_hz = 50
sinc_min_band_hz = 50
sinc_use_laynorm_inp = True
sinc_use_batchnorm_inp = False
sinc_use_laynorm = True,True,True
sinc_use_batchnorm = False,False,False
sinc_act = leaky_relu,leaky_relu,leaky_relu
sinc_drop = 0.0,0.0,0.0
""" + SGD_TAIL.format(lr=0.08)
    cfg += mlp_arch(
        2, "MLP_layers", "2048,2048,N_out_lab_cd", "0.15,0.15,0.0",
        "True,True,False", "leaky_relu,leaky_relu,softmax", 0.08,
    )
    cfg += model_block(
        ["out_cnn=compute(SincNet_layers,raw)",
         "out_dnn=compute(MLP_layers,out_cnn)",
         "loss_final=cost_nll(out_dnn,lab_cd)",
         "err_final=cost_err(out_dnn,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn", acwt=0.2)
    return cfg


# ---------------------------------------------------------------------------
# TIMIT: ensemble + joint training
# ---------------------------------------------------------------------------


def timit_best_ensemble():
    """Reference TIMIT_mfcc_fbank_fmllr_liGRU_best.cfg (PER 13.8): three
    concatenated feature streams through MLP -> liGRU -> MLP with joint
    cd/mono heads — 5 architectures, 2 concatenate ops."""
    cfg = HEADER.format(exp_name="TIMIT_mfcc_fbank_fmllr_liGRU_best",
                        n_epochs=24)
    cfg += timit_datasets(0)
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_test")
    cfg += BATCHES.format(bs=8, msl=1000, curr="True", bs_valid=8)
    cfg += mlp_arch(1, "MLP_layers_first", "1024", "0.15", "True",
                    "leaky_relu", 0.0004, tail=RMSPROP_TAIL)
    cfg += recurrent_arch(
        2, "liGRU_layers", "liGRU", "ligru", ",".join(["550"] * 5),
        ",".join(["0.2"] * 5), ",".join(["True"] * 5),
        ",".join(["relu"] * 5), 0.0004, extra="ligru_impl = auto\n",
    )
    cfg += mlp_arch(3, "MLP_layers_second", "1024", "0.15", "True",
                    "leaky_relu", 0.0004, tail=RMSPROP_TAIL)
    cfg += mlp_arch(4, "MLP_layers_last", "N_out_lab_cd", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += mlp_arch(5, "MLP_layers_last2", "N_out_lab_mono", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += model_block(
        ["conc1=concatenate(mfcc,fbank)",
         "conc2=concatenate(conc1,fmllr)",
         "out_dnn1=compute(MLP_layers_first,conc2)",
         "out_dnn2=compute(liGRU_layers,out_dnn1)",
         "out_dnn3=compute(MLP_layers_second,out_dnn2)",
         "out_dnn4=compute(MLP_layers_last,out_dnn3)",
         "out_dnn5=compute(MLP_layers_last2,out_dnn3)",
         "loss_mono=cost_nll(out_dnn5,lab_mono)",
         "loss_mono_w=mult_constant(loss_mono,1.0)",
         "loss_cd=cost_nll(out_dnn4,lab_cd)",
         "loss_final=sum(loss_cd,loss_mono_w)",
         "err_final=cost_err(out_dnn4,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn4", acwt=0.2)
    return cfg


REV_STREAMS = """fea_name=fbankrev
\tfea_lst={root}/data_rev/{split}/feats_fbank.scp
\tfea_opts=apply-cmvn --utt2spk=ark:{root}/data_rev/{split}/utt2spk ark:{root}/fbank/cmvn_{split}_rev.ark ark:- ark:- |
\tcw_left=0
\tcw_right=0

\tfea_name=fbankclean
\tfea_lst={root}/data/{split}/feats_fbank.scp
\tfea_opts=apply-cmvn --utt2spk=ark:{root}/data/{split}/utt2spk ark:{root}/fbank/cmvn_{split}.ark ark:- ark:- |
\tcw_left=0
\tcw_right=0
"""


def timit_rev_joint():
    """Reference TIMIT_rev/TIMIT_joint_training_liGRU_fbank.cfg (PER 28.1
    on reverberated TIMIT): speech-enhancement liGRU trained with mse
    against clean fbank, feeding the recognizer liGRU — joint multi-loss."""
    cfg = HEADER.format(exp_name="TIMIT_rev_joint_training_liGRU_fbank",
                        n_epochs=24)
    for i, (name, split, nck) in enumerate(TIMIT_SPLITS, start=1):
        cfg += dataset_block(
            i, name, [REV_STREAMS.format(root=ROOT_TIMIT, split=split)],
            lab_block(ROOT_TIMIT, split, TIMIT_ALI[split], mono=True), nck,
        )
    cfg += DATA_USE.format(tr="TIMIT_tr", dev="TIMIT_dev", te="TIMIT_test")
    cfg += BATCHES.format(bs=8, msl=1000, curr="True", bs_valid=8)
    cfg += recurrent_arch(
        1, "liGRU_SE", "liGRU", "ligru", "550,550,550", "0.2,0.2,0.2",
        "True,True,True", "relu,relu,relu", 0.0004,
        extra="ligru_impl = auto\n",
    )
    cfg += mlp_arch(2, "MLP_SE", "40", "0.0", "False", "linear", 0.0004,
                    tail=RMSPROP_TAIL)
    cfg += recurrent_arch(
        3, "liGRU_SR", "liGRU", "ligru", "550,550,550,550",
        "0.2,0.2,0.2,0.2", "True,True,True,True", "relu,relu,relu,relu",
        0.0004, extra="ligru_impl = auto\n",
    )
    cfg += mlp_arch(4, "MLP_layers", "N_out_lab_cd", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += mlp_arch(5, "MLP_layers2", "N_out_lab_mono", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += model_block(
        ["out_dnn1=compute(liGRU_SE,fbankrev)",
         "out_dnn_SE=compute(MLP_SE,out_dnn1)",
         "out_dnn2=compute(liGRU_SR,out_dnn_SE)",
         "out_dnn3=compute(MLP_layers,out_dnn2)",
         "out_dnn4=compute(MLP_layers2,out_dnn2)",
         "loss_mono=cost_nll(out_dnn4,lab_mono)",
         "loss_mono_w=mult_constant(loss_mono,1.0)",
         "loss_se=mse(out_dnn_SE,fbankclean)",
         "loss_se_w=mult_constant(loss_se,1.0)",
         "loss_cd=cost_nll(out_dnn3,lab_cd)",
         "loss_sum1=sum(loss_cd,loss_mono_w)",
         "loss_final=sum(loss_sum1,loss_se_w)",
         "err_final=cost_err(out_dnn3,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn3", acwt=0.2)
    return cfg


# ---------------------------------------------------------------------------
# Librispeech + DIRHA
# ---------------------------------------------------------------------------

LIBRI_SPLITS = [("libri_tr", "train_clean_100", 40),
                ("libri_dev", "dev_clean", 2), ("libri_test", "test_clean", 2)]
ROOT_LIBRI = "$KALDI_LIBRI"


def libri_datasets():
    out = ""
    for i, (name, split, nck) in enumerate(LIBRI_SPLITS, start=1):
        out += dataset_block(
            i, name,
            [_fea_stream(ROOT_LIBRI, split, "fmllr", "fmllr", 0,
                         lst=f"{ROOT_LIBRI}/data/{split}/feats.scp")],
            lab_block(ROOT_LIBRI, split, "tri4b_ali_clean_100", mono=False),
            nck,
        )
    return out


def libri_recurrent(cls):
    """Reference libri_{LSTM,GRU,RNN,liGRU}_fmllr.cfg: Librispeech-100h,
    5x550 bidir body + cd head (WER 6.2-6.5 with rescoring)."""
    prefix = RECURRENT_PREFIX[cls]
    act = RECURRENT_ACTS[cls]
    cfg = HEADER.format(exp_name=f"libri_{cls}_fmllr", n_epochs=8)
    cfg += libri_datasets()
    cfg += DATA_USE.format(tr="libri_tr", dev="libri_dev", te="libri_test")
    cfg += BATCHES.format(bs=16, msl=500, curr="True", bs_valid=16)
    extra = "ligru_impl = auto\n" if cls == "liGRU" else ""
    cfg += recurrent_arch(
        1, f"{cls}_layers", cls, prefix, ",".join(["550"] * 5),
        ",".join(["0.2"] * 5), ",".join(["True"] * 5), ",".join([act] * 5),
        0.0004, extra=extra,
    )
    cfg += mlp_arch(2, "MLP_layers", "N_out_lab_cd", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += model_block(
        [f"out_dnn1=compute({cls}_layers,fmllr)",
         "out_dnn2=compute(MLP_layers,out_dnn1)",
         "loss_final=cost_nll(out_dnn2,lab_cd)",
         "err_final=cost_err(out_dnn2,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn2", acwt=0.1)
    return cfg


def libri_mlp():
    cfg = HEADER.format(exp_name="libri_MLP_fmllr", n_epochs=8)
    cfg += libri_datasets()
    cfg = cfg.replace("cw_left=0", "cw_left=5").replace("cw_right=0",
                                                        "cw_right=5")
    cfg += DATA_USE.format(tr="libri_tr", dev="libri_dev", te="libri_test")
    cfg += BATCHES.format(bs=128, msl=1000, curr="False", bs_valid=128)
    cfg += mlp_arch(
        1, "MLP_layers1", "1024,1024,1024,1024,1024,N_out_lab_cd",
        "0.15,0.15,0.15,0.15,0.15,0.0", "True,True,True,True,True,False",
        "relu,relu,relu,relu,relu,softmax", 0.08,
    )
    cfg += model_block(
        ["out_dnn1=compute(MLP_layers1,fmllr)",
         "loss_final=cost_nll(out_dnn1,lab_cd)",
         "err_final=cost_err(out_dnn1,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn1", acwt=0.1)
    return cfg


DIRHA_SPLITS = [("DIRHA_tr", "train", 5), ("DIRHA_dev", "dev", 1),
                ("DIRHA_test", "test", 1)]
ROOT_DIRHA = "$KALDI_DIRHA"


def dirha_datasets(fea="fmllr", cw=0):
    out = ""
    for i, (name, split, nck) in enumerate(DIRHA_SPLITS, start=1):
        out += dataset_block(
            i, name,
            [_fea_stream(ROOT_DIRHA, split, fea, fea, cw,
                         lst=f"{ROOT_DIRHA}/data/{split}/feats.scp")],
            lab_block(ROOT_DIRHA, split, "dnn4_pretrain-dbn_dnn_ali",
                      mono=False),
            nck,
        )
    return out


def dirha_recurrent(cls):
    """Reference DIRHA_{GRU,liGRU}_fmllr.cfg: distant-talking (LA6 mic),
    WER 23.8-25.3."""
    prefix = RECURRENT_PREFIX[cls]
    act = RECURRENT_ACTS[cls]
    cfg = HEADER.format(exp_name=f"DIRHA_{cls}_fmllr", n_epochs=24)
    cfg += dirha_datasets()
    cfg += DATA_USE.format(tr="DIRHA_tr", dev="DIRHA_dev", te="DIRHA_test")
    cfg += BATCHES.format(bs=16, msl=1000, curr="False", bs_valid=16)
    extra = "ligru_impl = auto\n" if cls == "liGRU" else ""
    cfg += recurrent_arch(
        1, f"{cls}_layers", cls, prefix, ",".join(["550"] * 5),
        ",".join(["0.2"] * 5), ",".join(["True"] * 5), ",".join([act] * 5),
        0.0004, extra=extra,
    )
    cfg += mlp_arch(2, "MLP_layers", "N_out_lab_cd", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += model_block(
        [f"out_dnn1=compute({cls}_layers,fmllr)",
         "out_dnn2=compute(MLP_layers,out_dnn1)",
         "loss_final=cost_nll(out_dnn2,lab_cd)",
         "err_final=cost_err(out_dnn2,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn2", acwt=0.1)
    return cfg


def dirha_mlp():
    cfg = HEADER.format(exp_name="DIRHA_MLP_fmllr", n_epochs=24)
    cfg += dirha_datasets(cw=5)
    cfg += DATA_USE.format(tr="DIRHA_tr", dev="DIRHA_dev", te="DIRHA_test")
    cfg += BATCHES.format(bs=128, msl=1000, curr="False", bs_valid=128)
    cfg += mlp_arch(
        1, "MLP_layers1", "1024,1024,1024,1024,1024,N_out_lab_cd",
        "0.15,0.15,0.15,0.15,0.15,0.0", "True,True,True,True,True,False",
        "relu,relu,relu,relu,relu,softmax", 0.08,
    )
    cfg += model_block(
        ["out_dnn1=compute(MLP_layers1,fmllr)",
         "loss_final=cost_nll(out_dnn1,lab_cd)",
         "err_final=cost_err(out_dnn1,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn1", acwt=0.1)
    return cfg


def dirha_qlstm_mfcc():
    """Reference DIRHA_QLSTM_MFCC.cfg: quaternion LSTM over 4-d-multiple
    spliced mfcc."""
    cfg = HEADER.format(exp_name="DIRHA_QLSTM_mfcc", n_epochs=24)
    cfg += dirha_datasets(fea="mfcc", cw=2)
    cfg += DATA_USE.format(tr="DIRHA_tr", dev="DIRHA_dev", te="DIRHA_test")
    cfg += BATCHES.format(bs=16, msl=1000, curr="False", bs_valid=16)
    cfg += f"""
[architecture1]
arch_name = QLSTM_layers
arch_proto = proto/QLSTM.proto
arch_library = tpukaldi.models
arch_class = QLSTM
arch_pretrain_file = none
arch_freeze = False
arch_seq_model = True
lstm_lay = 1024,1024
lstm_drop = 0.2,0.2
lstm_bidir = True
lstm_act = tanh,tanh
quaternion_init = quaternion
autograd = False
""" + RMSPROP_TAIL.format(lr=0.0016)
    cfg += mlp_arch(2, "MLP_layers", "N_out_lab_cd", "0.0", "False",
                    "softmax", 0.0016, tail=RMSPROP_TAIL)
    cfg += model_block(
        ["out_dnn1=compute(QLSTM_layers,mfcc)",
         "out_dnn2=compute(MLP_layers,out_dnn1)",
         "loss_final=cost_nll(out_dnn2,lab_cd)",
         "err_final=cost_err(out_dnn2,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn2", acwt=0.1)
    return cfg


def dirha_fusion_6ch():
    """Reference DIRHA_fusionRNN_MFCC_6ch.cfg: 6-microphone shared-weight
    fusion Li-GRU."""
    cfg = HEADER.format(exp_name="DIRHA_fusionRNN_mfcc_6ch", n_epochs=24)
    cfg += dirha_datasets(fea="mfcc_6ch", cw=0)
    cfg += DATA_USE.format(tr="DIRHA_tr", dev="DIRHA_dev", te="DIRHA_test")
    cfg += BATCHES.format(bs=16, msl=1000, curr="False", bs_valid=16)
    cfg += f"""
[architecture1]
arch_name = fusionRNN_layers
arch_proto = proto/fusionRNN.proto
arch_library = tpukaldi.models
arch_class = fusionRNN_jit
arch_pretrain_file = none
arch_freeze = False
arch_seq_model = True
fusionRNN_lay = 512,512,512,512
fusionRNN_drop = 0.2,0.2,0.2,0.2
fusionRNN_bidir = True
fusionRNN_act = prelu,prelu,prelu,prelu
fusionRNN_do_fusion = True
fusionRNN_fusion_layer_size = 3072
fusionRNN_number_of_mic = 6
fusionRNN_fusion_act = prelu
fusionRNN_fusion_reduce = sum
batches = 16
""" + RMSPROP_TAIL.format(lr=0.0004)
    cfg += mlp_arch(2, "MLP_layers", "N_out_lab_cd", "0.0", "False",
                    "softmax", 0.0004, tail=RMSPROP_TAIL)
    cfg += model_block(
        ["out_dnn1=compute(fusionRNN_layers,mfcc_6ch)",
         "out_dnn2=compute(MLP_layers,out_dnn1)",
         "loss_final=cost_nll(out_dnn2,lab_cd)",
         "err_final=cost_err(out_dnn2,lab_cd)"],
    )
    cfg += FORWARD_DECODING.format(fwd_out="out_dnn2", acwt=0.1)
    return cfg


# ---------------------------------------------------------------------------
# the full matrix (reference: 27 TIMIT + 5 Librispeech + 5 DIRHA = 37,
# plus a minimalGRU extra this framework also ships)
# ---------------------------------------------------------------------------

GENERATORS = {
    # TIMIT MLP family
    "TIMIT/MLP_mfcc_basic.cfg": timit_mlp_mfcc_basic,
    "TIMIT/MLP_mfcc_basic_flex.cfg": timit_mlp_mfcc_basic_flex,
    "TIMIT/MLP_mfcc.cfg": lambda: timit_mlp("mfcc"),
    "TIMIT/MLP_fbank.cfg": lambda: timit_mlp("fbank"),
    "TIMIT/MLP_fmllr.cfg": lambda: timit_mlp("fmllr"),
    "TIMIT/MLP_fbank_autoencoder.cfg": timit_mlp_fbank_autoencoder,
    "TIMIT/MLP_fbank_prod.cfg": timit_mlp_fbank_prod,
    # TIMIT recurrent x feature matrix
    "TIMIT/LSTM_mfcc.cfg": lambda: timit_recurrent("LSTM", "mfcc"),
    "TIMIT/LSTM_fbank.cfg": lambda: timit_recurrent("LSTM", "fbank"),
    "TIMIT/LSTM_fmllr.cfg": lambda: timit_recurrent("LSTM", "fmllr"),
    "TIMIT/LSTM_fmllr_cudnn.cfg": timit_lstm_fmllr_cudnn,
    "TIMIT/GRU_mfcc.cfg": lambda: timit_recurrent("GRU", "mfcc"),
    "TIMIT/GRU_fbank.cfg": lambda: timit_recurrent("GRU", "fbank"),
    "TIMIT/GRU_fmllr.cfg": lambda: timit_recurrent("GRU", "fmllr"),
    "TIMIT/liGRU_mfcc.cfg": lambda: timit_recurrent("liGRU", "mfcc"),
    "TIMIT/liGRU_fbank.cfg": lambda: timit_recurrent("liGRU", "fbank"),
    "TIMIT/liGRU_fmllr.cfg": lambda: timit_recurrent("liGRU", "fmllr"),
    "TIMIT/liGRU_fmllr_lr_schedule.cfg": lambda: timit_recurrent(
        "liGRU", "fmllr", lr_schedule=True, exp_suffix="_lr_schedule"),
    # tpukaldi extension: the flagship recipe under the bf16 compute mode
    # (f32 masters; see train/step.py)
    "TIMIT/liGRU_fmllr_bf16.cfg": lambda: timit_recurrent(
        "liGRU", "fmllr", exp_suffix="_bf16", compute_dtype="bfloat16"),
    "TIMIT/RNN_mfcc.cfg": lambda: timit_recurrent("RNN", "mfcc"),
    "TIMIT/RNN_fbank.cfg": lambda: timit_recurrent("RNN", "fbank"),
    "TIMIT/RNN_fmllr.cfg": lambda: timit_recurrent("RNN", "fmllr"),
    "TIMIT/minimalGRU_fbank.cfg": lambda: timit_recurrent(
        "minimalGRU", "fbank"),
    "TIMIT/SRU_fbank.cfg": timit_sru_fbank,
    # TIMIT conv / raw
    "TIMIT/CNN_fbank.cfg": timit_cnn_fbank,
    "TIMIT/CNN_raw.cfg": timit_cnn_raw,
    "TIMIT/SincNet_raw.cfg": timit_sincnet_raw,
    # TIMIT ensemble + joint training
    "TIMIT/mfcc_fbank_fmllr_liGRU_best.cfg": timit_best_ensemble,
    "TIMIT/TIMIT_rev/joint_training_liGRU_fbank.cfg": timit_rev_joint,
    # Librispeech
    "Librispeech/MLP_fmllr.cfg": libri_mlp,
    "Librispeech/LSTM_fmllr.cfg": lambda: libri_recurrent("LSTM"),
    "Librispeech/GRU_fmllr.cfg": lambda: libri_recurrent("GRU"),
    "Librispeech/RNN_fmllr.cfg": lambda: libri_recurrent("RNN"),
    "Librispeech/liGRU_fmllr.cfg": lambda: libri_recurrent("liGRU"),
    # DIRHA
    "DIRHA/MLP_fmllr.cfg": dirha_mlp,
    "DIRHA/GRU_fmllr.cfg": lambda: dirha_recurrent("GRU"),
    "DIRHA/liGRU_fmllr.cfg": lambda: dirha_recurrent("liGRU"),
    "DIRHA/QLSTM_mfcc.cfg": dirha_qlstm_mfcc,
    "DIRHA/fusionRNN_mfcc_6ch.cfg": dirha_fusion_6ch,
}


def generate_all(cfg_dir: str) -> list:
    paths = []
    for rel, gen in GENERATORS.items():
        path = os.path.join(cfg_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(gen())
        paths.append(path)
    return paths


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    cfg_dir = argv[0] if argv else "cfg"
    for p in generate_all(cfg_dir):
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
