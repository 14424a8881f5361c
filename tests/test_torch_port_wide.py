"""The recurrent families past the backward kernels' limit: H = 2048 (the
forward kernels' limit, K1f-K4f streaming their slices of U) and 1036, on
the CPU, against tpukaldi.

1. Each of liGRU, LSTM, GRU and QLSTM, one bidirectional layer in eval mode
   (batchnorm, the recipes' activations; the QLSTM under `qlstm_impl =
   auto`), tpukaldi's flax module (its scan at these widths) and the port's
   module given the same weights through `from_jax_params`, on a padded
   forward batch (lengths [7, 5, 0]): the valid frames within ATOL, every
   frame finite.  Both sides compute in float32, each step's product a sum
   of up to 2048 terms in another order; the largest difference seen was
   7.7e-7 (the liGRU's, on outputs up to 2.6; the QLSTM's 3.7e-8 on
   outputs up to 0.13), so the model-parity files' 1e-5 holds.
2. The weight maps at H = 2048: tpukaldi's params -> `from_jax_params` ->
   `to_jax_params` gives them back bitwise, for the four families.
3. The flagship's production forward at `ligru_lay = 1100,1100` through
   both packages' `run_experiment`, from the same final checkpoints: every
   posterior row within 1e-4 (`tests/test_torch_port_slice.py` says why).
4. What needs no card: the limits in the CUDA sources, the refusal of a
   wide backward, the bound's streamed share of U in `chip_smoke.py`, and
   the builds `tools/recurrence_envelope.py` makes.
"""

import ast
import os
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.io import read_mat_ark
from tpukaldi.models import quaternion as jax_q
from tpukaldi.models.recurrent import GRU as JaxGRU
from tpukaldi.models.recurrent import LSTM as JaxLSTM
from tpukaldi.models.recurrent import liGRU as JaxLiGRU
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi_torch.compat.jax_params import from_jax_params, to_jax_params
from tpukaldi_torch.kernels import _build, _launch
from tpukaldi_torch.models import GRU, LSTM, QLSTM, liGRU
from tpukaldi_torch.tools import recurrence_envelope
from tpukaldi_torch.tools.flagship_tree import write_kaldi_tree, write_prod_cfg
from tpukaldi_torch.tools.run_exp import run_experiment
from torch_port_helpers import (
    assert_trees_equal,
    final_ckpts,
    jax_init,
    port_module,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
D = 12  # a multiple of 4, for the QLSTM
T, B = 7, 3
LENGTHS = np.array([7, 5, 0], np.int64)
WIDTHS = (2048, 1036)
FWD_MAX_HIDDEN, BWD_MAX_HIDDEN = 2048, 1024


def _opts(family, H):
    """One bidirectional layer of `family` at width H, as its recipe has
    it (batchnorm, its activation, recurrent dropout off in eval)."""
    if family == "QLSTM":
        return dict(lstm_lay=str(H), lstm_drop="0.2", lstm_bidir="True",
                    lstm_act="tanh", quaternion_init="quaternion",
                    autograd="False", qlstm_impl="auto")
    p = family.lower()
    return {f"{p}_lay": str(H), f"{p}_drop": "0.2",
            f"{p}_use_batchnorm": "True", f"{p}_use_laynorm": "False",
            f"{p}_act": "relu" if family == "liGRU" else "tanh",
            f"{p}_bidir": "True", f"{p}_orthinit": "True",
            f"{p}_use_laynorm_inp": "False", f"{p}_use_batchnorm_inp": "False"}


FAMILIES = {"liGRU": (JaxLiGRU, liGRU), "LSTM": (JaxLSTM, LSTM),
            "GRU": (JaxGRU, GRU), "QLSTM": (jax_q.QLSTM, QLSTM)}


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_tpukaldi_past_1024(family, H):
    jcls, pcls = FAMILIES[family]
    opts = _opts(family, H)
    x = np.random.default_rng(H).standard_normal((T, B, D)).astype(np.float32)
    valid = np.arange(T)[:, None] < LENGTHS[None, :]
    x[~valid] = 0.0
    jmod, params, stats = jax_init(jcls, opts, np.zeros((4, 2, D), np.float32),
                                   seed=5)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False,
                                 lengths=jnp.asarray(LENGTHS, jnp.int32)))
    port = port_module(pcls, opts, D, params, stats, family)
    with torch.inference_mode():
        got = port(torch.from_numpy(x),
                   lengths=torch.from_numpy(LENGTHS)).numpy()
    assert got.shape == want.shape == (T, B, 2 * H)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=ATOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_weight_maps_round_trip_at_2048(family):
    jcls, _ = FAMILIES[family]
    _, params, stats = jax_init(jcls, _opts(family, 2048),
                                np.zeros((4, 2, D), np.float32), seed=11)
    back_params, back_stats = to_jax_params(
        from_jax_params(family, params, stats), family)
    assert_trees_equal(back_params, params)
    assert_trees_equal(back_stats, stats)


# ---------------------------------------------------------- 3. serving
DIM = 10
WIDE = {
    "ligru_lay = 550,550,550,550,550": "ligru_lay = 1100,1100",
    "ligru_drop = 0.2,0.2,0.2,0.2,0.2": "ligru_drop = 0.2,0.2",
    "ligru_use_laynorm = False,False,False,False,False":
        "ligru_use_laynorm = False,False",
    "ligru_use_batchnorm = True,True,True,True,True":
        "ligru_use_batchnorm = True,True",
    "ligru_act = relu,relu,relu,relu,relu": "ligru_act = relu,relu",
}
SPLITS = {"train": (4, 40, 80), "dev": (2, 40, 60), "test": (5, 30, 120)}


def _arks(out):
    ef = os.path.join(out, "exp_files")
    arks = [f for f in os.listdir(ef) if f.endswith("_to_decode.ark")]
    assert len(arks) == 1, os.listdir(ef)
    return dict(read_mat_ark(os.path.join(ef, arks[0])))


def test_production_forward_at_1100_matches_tpukaldi(tmp_path):
    tree = write_kaldi_tree(str(tmp_path / "timit"), DIM, n_phones=3,
                            n_pdfs=9, splits=SPLITS)
    outs = {k: str(tmp_path / k) for k in ("tpk", "port")}
    cfgs = {}
    for k, out in outs.items():
        os.makedirs(out)
        cfgs[k] = write_prod_cfg(tree, out, os.path.join(out, "run.cfg"), WIDE)
    final_ckpts(cfgs["tpk"], list(outs.values()), DIM)
    tpk_run_experiment(cfgs["tpk"])
    run_experiment(cfgs["port"], device="cpu")
    want, got = _arks(outs["tpk"]), _arks(outs["port"])
    assert sorted(got) == sorted(want) and len(got) == SPLITS["test"][0]
    for key in want:
        assert got[key].shape == want[key].shape and got[key].shape[1] == 9
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4,
                                   err_msg=key)


# ---------------------------------------------------------- 4. no card
FWD_SOURCES = ("ligru_fwd.cu", "lstm_fwd.cu", "gru_fwd.cu", "lstm_lean_fwd.cu")
BWD_SOURCES = ("ligru_bwd.cu", "lstm_bwd.cu", "gru_bwd.cu", "lstm_lean_bwd.cu")


@pytest.mark.parametrize("source", FWD_SOURCES + BWD_SOURCES)
def test_recurrence_limits_in_the_sources(source):
    """Each forward kernel takes H up to 2048 and streams U past what fits
    (csrc/u_stream.cuh); each backward keeps 1024."""
    with open(os.path.join(_build._CSRC, source)) as f:
        text = f.read()
    limit = re.search(r"constexpr int kMaxHidden = (\d+);", text).group(1)
    fwd = source in FWD_SOURCES
    assert int(limit) == (FWD_MAX_HIDDEN if fwd else BWD_MAX_HIDDEN)
    assert ('#include "u_stream.cuh"' in text) == fwd


def test_wide_backward_refused_where_a_gradient_is_wanted(monkeypatch):
    """An autograd Function's forward on the card refuses an H past the
    backward kernel's limit where a gradient is wanted, naming the
    backward entry and its limit, and lets every other call through."""
    monkeypatch.setattr(_launch, "max_hidden",
                        lambda source, name: BWD_MAX_HIDDEN)
    grad = SimpleNamespace(needs_input_grad=(True, False, False))
    no_grad = SimpleNamespace(needs_input_grad=(False, False, False))
    with pytest.raises(ValueError, match=r"ligru_recurrence_bwd: H=2048 "
                                         r"exceeds the kernel's limit of 1024"):
        _launch.refuse_wide_backward("ligru_recurrence_bwd", grad, 2048,
                                     "ligru_bwd.cu", "ligru_bwd")
    _launch.refuse_wide_backward("ligru_recurrence_bwd", no_grad, 2048,
                                 "ligru_bwd.cu", "ligru_bwd")
    _launch.refuse_wide_backward("ligru_recurrence_bwd", grad, 1024,
                                 "ligru_bwd.cu", "ligru_bwd")
    with pytest.raises(ValueError, match="limit of 2048"):
        _launch.check_hidden("ligru_recurrence", 2049, FWD_MAX_HIDDEN)


@pytest.mark.parametrize("cell", ["ligru", "lstm", "gru", "lstm_lean"])
def test_functions_on_cpu_take_any_width(cell):
    """On a CPU tensor the Functions run their plain versions at any H,
    gradient and all (the refusal is the card's backward kernels')."""
    from tpukaldi_torch.kernels import gru, ligru, lstm
    H, gates = 1100, {"ligru": 2, "lstm": 4, "gru": 3, "lstm_lean": 4}[cell]
    rng = np.random.default_rng(0)
    ff = torch.from_numpy(rng.standard_normal((2, 1, gates * H)).astype(
        np.float32)).requires_grad_()
    mask = torch.ones(1, H)
    if cell == "gru":
        ws = [torch.zeros(H, 2 * H), torch.zeros(H, H)]
        h = gru.GRURecurrence.apply(ff, *ws, mask, "tanh")
    else:
        fn = {"ligru": ligru.LiGRURecurrence, "lstm": lstm.LSTMRecurrence,
              "lstm_lean": lstm.LSTMLeanRecurrence}[cell]
        h = fn.apply(ff, torch.zeros(H, gates * H), mask)
    h.sum().backward()
    assert h.shape == (2, 1, H) and torch.isfinite(ff.grad).all()


def _chip_smoke():
    """chip_smoke.py's module (importing it runs nothing: main is guarded)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# an L2 of the H100's 50 MiB read at 5.5 TB/s: a stand-in for the rate
# chip_smoke.py measures on the card (`measure_l2`)
L2_STANDIN = {"bytes": 50 << 20, "rate": 5.5e12}


def test_bound_counts_the_streamed_share_of_u():
    """The bound of a forward at (T, B, H) = (778, 16, 2048), worked out by
    hand.  Both LSTMs read 6 T B H + 4 H^2 + B H float32 words once:
    679,084,032 bytes, 0.2027 ms at 3.35 TB/s.  Past the card's 132 x
    232,448 = 30,683,136 bytes of shared memory, K2f's float32 U (67,108,864
    bytes) leaves 36,425,728 and K4f's bf16 U (33,554,432) 2,871,296, both
    within the 50 MiB L2, read again at each of the 777 later steps: through
    L2, (679,084,032 + 777 x 36,425,728) / 5.5e12 = 5.2694 ms for K2f, under
    its 8 T B H^2 float32 operations at 67 TFLOP/s, 6.2341 ms; and
    (679,084,032 + 777 x 2,871,296) / 5.5e12 = 0.52911 ms for K4f, over its
    bf16 operations at 989 TFLOP/s, 0.42233 ms.  At H = 1024 every U fits
    on chip and the bound is the once-read bytes' or the operations'."""
    cs = _chip_smoke()
    got = {name: cs.bound_ms(name, 778, 16, 2048, l2=L2_STANDIN)
           for name in ("lstm_fwd", "lstm_lean_fwd")}
    assert got["lstm_fwd"][1] == "operations"
    assert got["lstm_fwd"][0] == pytest.approx(6.2341130, rel=1e-7)
    assert got["lstm_lean_fwd"][1] == "bytes"
    assert got["lstm_lean_fwd"][0] == pytest.approx(0.52910564, rel=1e-7)
    # the L2 probe is read only past the shared memory: without it, H = 1024
    # gives (6 x 778 x 16 x 1024 + 4 x 1024^2 + 16 x 1024) x 4 bytes =
    # 343,080,960 at 3.35 TB/s, 0.10241 ms, under K2f's 1.5585 ms of operations
    assert cs.bound_ms("lstm_fwd", 778, 16, 1024, l2={}) == pytest.approx(
        (8 * 778 * 16 * 1024 ** 2 / 67e12 * 1e3, "operations"))
    assert cs.bound_ms("ligru_bwd", 778, 16, 2048, l2={})[1] == "operations"
    assert not any(name.endswith("_bwd") for name in cs.U_BYTES)


def test_envelope_builds_replace_what_they_name():
    """`stream forced` replaces each source's resident check; `all
    streamed, chunk 16` also the resident rows and the chunk."""
    files = recurrence_envelope.sources(_build._CSRC, recurrence_envelope.FILES)
    forced = recurrence_envelope._variant(files, False)
    every = recurrence_envelope._variant(files, True)
    for src in recurrence_envelope.SRCS:
        for v in (forced, every):
            assert recurrence_envelope.RESIDENT_CHECK not in v[src]
            assert v[src].count("if (true) {") == 1
    assert forced["u_stream.cuh"] == files["u_stream.cuh"]
    assert "*k_res = 0;" in every["u_stream.cuh"]
    assert "kStreamChunk = 16;" in every["u_stream.cuh"]
    assert every["u_stream.cuh"].count("\n") == files["u_stream.cuh"].count("\n")


def test_envelope_tool_imports_only_the_port():
    tree = ast.parse(open(recurrence_envelope.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module}
    assert not names & {"jax", "tpukaldi", "flax"}
