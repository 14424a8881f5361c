"""The port's production forward stage end to end, against tpukaldi's.

A shrunk flagship production run (cfg/TIMIT/liGRU_fmllr.cfg with a
`lab_name=none` forward dataset; 2x32 bidirectional liGRU with batchnorm
and recurrent dropout, cd head 9 pdfs) over a synthetic Kaldi tree in real
formats.  Both `run_experiment`s read the same final checkpoints, written by
tpukaldi's `save_all` from its `init_graph` with batchnorm parameters and
statistics drawn from numpy.  Every utterance's posterior rows must agree
within 1e-4 absolute: the log-posteriors minus log-priors are of order 10,
and both sides compute in float32 with sums in different orders.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from tpukaldi.io import read_mat_ark
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi.train.chunk_runtime import read_info
from tpukaldi_torch.kernels import ligru
from tpukaldi_torch.tools.flagship_tree import (
    forward_outputs,
    forward_utterances,
    save_seeded_finals,
    write_kaldi_tree,
    write_prod_cfg,
)
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train import chunk_runtime
from torch_port_helpers import final_ckpts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 10
SHRINK = {
    "ligru_lay = 550,550,550,550,550": "ligru_lay = 32,32",
    "ligru_drop = 0.2,0.2,0.2,0.2,0.2": "ligru_drop = 0.2,0.2",
    "ligru_use_laynorm = False,False,False,False,False":
        "ligru_use_laynorm = False,False",
    "ligru_use_batchnorm = True,True,True,True,True":
        "ligru_use_batchnorm = True,True",
    "ligru_act = relu,relu,relu,relu,relu": "ligru_act = relu,relu",
}
SPLITS = {"train": (8, 40, 80), "dev": (2, 40, 60), "test": (12, 30, 160)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_kaldi_tree(str(tmp_path_factory.mktemp("timit")), DIM,
                            n_phones=3, n_pdfs=9, splits=SPLITS)


def _cfg(tree, out):
    os.makedirs(out, exist_ok=True)
    return write_prod_cfg(tree, out, os.path.join(out, "run.cfg"), SHRINK)


def _forward_outputs(out):
    ef = os.path.join(out, "exp_files")
    arks = [f for f in os.listdir(ef) if f.endswith("_to_decode.ark")]
    infos = [f for f in os.listdir(ef) if f.startswith("forward_")
             and f.endswith(".info")]
    assert len(arks) == 1 and len(infos) == 1, os.listdir(ef)
    return (dict(read_mat_ark(os.path.join(ef, arks[0]))), arks[0],
            read_info(os.path.join(ef, infos[0])))


def test_production_forward_matches_tpukaldi(tree, tmp_path):
    out_tpk, out_port = str(tmp_path / "tpk"), str(tmp_path / "port")
    cfg_tpk, cfg_port = _cfg(tree, out_tpk), _cfg(tree, out_port)
    final_ckpts(cfg_tpk, [out_tpk, out_port], DIM)
    tpk_run_experiment(cfg_tpk)
    run_experiment(cfg_port, device="cpu")

    want, want_name, want_info = _forward_outputs(out_tpk)
    got, got_name, got_info = _forward_outputs(out_port)
    assert got_name == want_name
    assert sorted(got) == sorted(want) and len(got) == SPLITS["test"][0]
    for key in want:
        assert got[key].shape == want[key].shape
        assert got[key].shape[1] == 9
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4,
                                   err_msg=key)
    assert set(got_info) == set(want_info)
    assert got_info["frames"] == want_info["frames"]


def test_forward_utterances_match_the_run(tree, tmp_path):
    """The port's per-utterance forward (the second path that chip_smoke.py
    holds the card's arks to) against the batched run's ark, on the CPU,
    and the run's batch count.  1e-4 absolute: the same weights and inputs
    in float32, but each utterance alone instead of in a padded batch, so
    the GEMMs sum in other orders."""
    out = str(tmp_path / "out")
    cfg = _cfg(tree, out)
    save_seeded_finals(cfg, DIM)
    chunk_runtime.forward_batches = 0
    launches = ligru.launches
    exp = run_experiment(cfg, device="cpu")
    # 12 utterances in forward batches of at most 8 (the CPU default)
    assert chunk_runtime.forward_batches >= 2
    assert ligru.launches == launches  # CPU tensors never launch the kernel
    posts, info = forward_outputs(out)
    posts = dict(posts)
    assert len(posts) == SPLITS["test"][0]
    assert info["frames"] == sum(p.shape[0] for p in posts.values())
    names = sorted(posts)[:3]
    got = forward_utterances(exp, names, "cpu")
    for name in names:
        np.testing.assert_allclose(got[name], posts[name], rtol=0, atol=1e-4,
                                   err_msg=name)


_NO_JAX = r"""
import importlib, importlib.abc, os, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "tpukaldi")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked: the port must not need it")


assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import tpukaldi_torch

for info in pkgutil.walk_packages(tpukaldi_torch.__path__, "tpukaldi_torch."):
    importlib.import_module(info.name)

from tpukaldi_torch import native
from tpukaldi_torch.tools.flagship_tree import (
    forward_outputs, recipe_cfg, save_seeded_finals, write_kaldi_tree,
    write_prod_cfg, write_train_cfg)
from tpukaldi_torch.tools.run_exp import run_experiment

# the native host library builds beside the port, never inside a package
assert os.path.dirname(native.library_path()) == os.path.join(
    sys.argv[1], "build", "tpukaldi_torch"), native.library_path()
work = sys.argv[2]
splits = {"train": (4, 30, 50), "dev": (2, 30, 50), "test": (5, 30, 90)}
tree = write_kaldi_tree(os.path.join(work, "tree"), 10, 3, 9, splits)
shrink = {
    "ligru_lay = 550,550,550,550,550": "ligru_lay = 8",
    "ligru_drop = 0.2,0.2,0.2,0.2,0.2": "ligru_drop = 0.2",
    "ligru_use_laynorm = False,False,False,False,False": "ligru_use_laynorm = False",
    "ligru_use_batchnorm = True,True,True,True,True": "ligru_use_batchnorm = True",
    "ligru_act = relu,relu,relu,relu,relu": "ligru_act = relu"}
out = os.path.join(work, "out")
os.makedirs(out)
cfg = write_prod_cfg(tree, out, os.path.join(out, "run.cfg"), shrink)
save_seeded_finals(cfg, 10)
run_experiment(cfg, device="cpu")
posts, _ = forward_outputs(out)
assert len(list(posts)) == 5
# and the training path: one epoch of train and valid chunks, then forward
out = os.path.join(work, "train")
os.makedirs(out)
cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"), {
    **shrink, "n_epochs_tr = 24": "n_epochs_tr = 1", "n_chunks = 5": "n_chunks = 1"})
run_experiment(cfg, device="cpu")
with open(os.path.join(out, "res.res")) as f:
    assert f.read().startswith("ep=0 ")
posts, _ = forward_outputs(out)
assert len(list(posts)) == 5
# and a tiny DIRHA QLSTM run (a 12-dim stream: 60 spliced inputs, a
# multiple of 4), trained for one epoch, then forward
tree = write_kaldi_tree(os.path.join(work, "dirha"), 12, 3, 9, splits,
                        corpus="DIRHA")
out = os.path.join(work, "qlstm")
os.makedirs(out)
cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"), {
    "lstm_lay = 1024,1024": "lstm_lay = 8", "lstm_drop = 0.2,0.2": "lstm_drop = 0.2",
    "lstm_act = tanh,tanh": "lstm_act = tanh", "n_epochs_tr = 24": "n_epochs_tr = 1",
    "n_chunks = 5": "n_chunks = 1"}, recipe=recipe_cfg("QLSTM"))
run_experiment(cfg, device="cpu")
with open(os.path.join(out, "res.res")) as f:
    assert f.read().startswith("ep=0 ")
posts, _ = forward_outputs(out)
assert len(list(posts)) == 5
# and tiny CNN and SincNet raw-waveform runs (400-sample windows), trained
# for one epoch with dropout, the CNN's layer 0 through K6's plain version
# with its hash mask, then forward
tree = write_kaldi_tree(os.path.join(work, "raw"), 10, 3, 9, splits,
                        raw_wlen=400)
for recipe, widths, impl in (
        ("CNN", {"cnn_n_filt = 128,60,60,60": "cnn_n_filt = 8,4,4,4"}, "pallas"),
        ("SincNet", {"sinc_n_filt = 80,60,60": "sinc_n_filt = 8,4,4"}, "auto")):
    os.environ["TPUKALDI_CONV_IMPL"] = impl
    out = os.path.join(work, recipe)
    os.makedirs(out)
    cfg = write_train_cfg(tree, out, os.path.join(out, "run.cfg"), {
        **widths, "dnn_lay = 2048,2048,N_out_lab_cd": "dnn_lay = 8,N_out_lab_cd",
        "dnn_drop = 0.15,0.15,0.0": "dnn_drop = 0.15,0.0",
        "dnn_use_batchnorm = True,True,False": "dnn_use_batchnorm = True,False",
        "dnn_use_laynorm = False,False,False": "dnn_use_laynorm = False,False",
        "dnn_act = leaky_relu,leaky_relu,softmax": "dnn_act = leaky_relu,softmax",
        "batch_size_train = 128": "batch_size_train = 32",
        "n_epochs_tr = 24": "n_epochs_tr = 1", "n_chunks = 5": "n_chunks = 1"},
        recipe=recipe_cfg(recipe))
    run_experiment(cfg, device="cpu")
    with open(os.path.join(out, "res.res")) as f:
        assert f.read().startswith("ep=0 ")
    posts, _ = forward_outputs(out)
    assert len(list(posts)) == 5
# the data-parallel mesh, the serving export and the .pkl converter, named
# (the package walk above imported them too): the last CNN run exported
# and served at a symbolic batch, its MLP as a reference pkl converted
import torch
from tpukaldi_torch import dist
from tpukaldi_torch.compat import torch_import
from tpukaldi_torch.tools import export_model
assert dist.data_parallel_mesh().world_size == 1
art = export_model.export_forward(cfg, os.path.join(work, "art"))
served = export_model.load_exported(art, device="cpu")
outs = served.call(torch.zeros((1, 3, served.meta["inp_dim"])))
assert all(v.shape[0] == 3 for v in outs.values())
from tpukaldi_torch.models.mlp import MLP
mlp = MLP({"dnn_lay": "4,3", "dnn_drop": "0.0,0.0",
           "dnn_use_batchnorm": "True,False", "dnn_use_laynorm": "False,False",
           "dnn_use_laynorm_inp": "False", "dnn_use_batchnorm_inp": "False",
           "dnn_act": "relu,softmax"}, 5)
opt = torch.optim.RMSprop(mlp.parameters(), lr=0.01, alpha=0.95)
mlp(torch.randn(6, 5)).sum().backward()
opt.step()
pkl = os.path.join(work, "ref.pkl")
torch.save({"model_par": mlp.state_dict(), "optimizer_par": opt.state_dict()},
           pkl)
torch_import.convert_checkpoint_file(pkl, os.path.join(work, "ref.ckpt"), "MLP")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("NO_JAX_OK")
"""


def test_port_runs_without_jax(tmp_path):
    """Every tpukaldi_torch module imports, and the tiny production slice,
    a tiny training run, a tiny QLSTM run and tiny CNN and SincNet runs go
    through on the CPU, then an export of the last and a .pkl conversion,
    with jax/flax/optax/msgpack and tpukaldi itself unimportable."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches tpukaldi only through tpukaldi_torch: no import
    of jax/flax/optax or of the JAX package itself."""
    tree_ = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    roots = set()
    for node in ast.walk(tree_):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "tpukaldi_torch" in roots
    assert not roots & {"tpukaldi", "jax", "jaxlib", "flax", "optax"}, roots


def test_port_sources_import_nothing_of_tpukaldi():
    """No file of the port, nor chip_smoke.py, has an absolute import whose
    root is tpukaldi (or JAX): the port keeps its own copy of every module
    it uses.  Relative imports stay inside tpukaldi_torch."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tpukaldi_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), node.lineno, m) for m in mods
                    if m.split(".")[0] in ("tpukaldi", "jax", "flax", "optax")]
    assert not bad, bad


def test_cli_applies_overrides(tree, tmp_path):
    """`python -m tpukaldi_torch.tools.run_exp <cfg> --device cpu
    --section,field=value`: the override reaches the run."""
    from tpukaldi_torch.tools.run_exp import main

    out = str(tmp_path / "out")
    cfg = _cfg(tree, out)
    save_seeded_finals(cfg, DIM)
    assert main([cfg, "--device", "cpu", "--forward,normalize_posteriors=False"]) == 0
    assert "normalize_posteriors = False" in open(os.path.join(out, "conf.cfg")).read()
    posts, _, _ = _forward_outputs(out)
    # no prior subtraction: each row is a log-softmax, so it sums to 1
    for post in posts.values():
        np.testing.assert_allclose(np.exp(post).sum(axis=1), 1.0, atol=1e-5)


def test_cuda_device_without_card_raises(tree, tmp_path):
    """`device="cuda"` never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_experiment(_cfg(tree, out), device="cuda")
