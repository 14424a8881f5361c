"""The port's user tools (`tpukaldi_torch/tools/{metrics,diagram,
plot_acc_and_loss,tune_hyperparameters,gen_example_cfgs,check_data}.py`),
what its `run_exp` writes besides the ledger, and tpukaldi's progress line,
against tpukaldi's originals on the same inputs, on the CPU.

- `tests/test_tools.py`'s tuner, metrics and diagram cases, run through
  both packages: the same files, parses, exports and SVG.
- `tests/test_check_data.py`'s six cases through both validators: the same
  issues.
- The usage exit codes of the port's console entry points
  (`pyproject.toml`'s `tpukaldi-torch-*`), as `tests/test_cli.py` checks
  tpukaldi's.
- A shrunk `run_experiment` in both packages from the same weights at
  dropout 0, on a fake tty: the same set of files, `model.svg` byte-equal,
  the curves' txt exports equal to the parity tolerance, and tpukaldi's
  progress line; with TPUKALDI_PROGRESS=0 the port prints none.
"""

import contextlib
import io
import os
import re
import shutil

import numpy as np
import pytest

from tpukaldi.compat import ref_harness as rh
from tpukaldi.config import load_config as tpk_load_config
from tpukaldi.config.model_dsl import parse_model as tpk_parse_model
from tpukaldi.data.synth import generate_corpus, load_corpus, write_cfg
from tpukaldi.tools import check_data as tpk_check_data
from tpukaldi.tools import diagram as tpk_diagram
from tpukaldi.tools import gen_example_cfgs as tpk_gen
from tpukaldi.tools import metrics as tpk_metrics
from tpukaldi.tools import tune_hyperparameters as tpk_tune
from tpukaldi.tools.run_exp import run_experiment as tpk_run_experiment
from tpukaldi_torch.config import load_config
from tpukaldi_torch.config.model_dsl import parse_model
from tpukaldi_torch.tools import (
    check_data,
    diagram,
    export_model,
    gen_example_cfgs,
    metrics,
    plot_acc_and_loss,
    run_chunk,
    run_exp,
    save_raw_fea,
    tune_hyperparameters,
)
from tpukaldi_torch.tools.flagship_tree import save_seeded_init

# the curves' txt exports of the two runs: res.res rounds to 3 decimals,
# and the runs' losses agree to 1e-3 (tests/test_torch_port_train.py), so
# one rounding step apart at most
EXPORT_ATOL = 1e-3 + 1e-9
# the progress line's train loss (3 decimals): the same bound
PROGRESS_ATOL = EXPORT_ATOL


# ------------------------------------------------- tests/test_tools.py
def test_tuner_matches_tpukaldi(tmp_path):
    base = tmp_path / "base.cfg"
    base.write_text(
        "[exp]\nout_folder = /old\narch_lr = 0.1\nbatch_size_train = 64\n"
        "dnn_act = relu,softmax\n"
    )
    specs = ["arch_lr=randfloat(0.001,0.01)",
             "batch_size_train=randint(32,256)",
             "dnn_act=choose_str{relu,softmax|tanh,softmax}"]
    out = str(tmp_path / "tune")
    cfgs = tune_hyperparameters.generate_tuning_cfgs(str(base), out, 5, specs)
    texts = [open(p).read() for p in cfgs]
    want = tpk_tune.generate_tuning_cfgs(str(base), out, 5, specs)
    assert cfgs == want
    assert texts == [open(p).read() for p in want]
    lrs = set()
    for i, text in enumerate(texts):
        assert f"out_folder = {tmp_path}/tune/exp{i}" in text
        lr = float([l for l in text.splitlines()
                    if l.startswith("arch_lr")][0].split("=")[1])
        assert 0.001 <= lr <= 0.01
        lrs.add(lr)
        bs = int([l for l in text.splitlines()
                  if l.startswith("batch_size")][0].split("=")[1])
        assert 32 <= bs <= 256
        act = [l for l in text.splitlines() if l.startswith("dnn_act")][0]
        assert act.split("=")[1].strip() in ("relu,softmax", "tanh,softmax")
    assert len(lrs) > 1


RES = ("ep=0 tr=['tr'] loss=2.100 err=0.747 valid=dev loss=2.025 err=0.538 "
       "lr_a=0.15 time(s)=16\n"
       "ep=1 tr=['tr'] loss=1.636 err=0.453 valid=dev loss=1.695 err=0.308 "
       "lr_a=0.075 time(s)=12\n"
       "%WER 23.2 [x] -> y\n")


def test_metrics_match_tpukaldi(tmp_path):
    res = tmp_path / "res.res"
    res.write_text(RES)
    data = metrics.parse_res(str(res))
    assert data == tpk_metrics.parse_res(str(res))
    assert data["train_loss"] == [2.1, 1.636]
    assert data["valid"]["dev"]["err"] == [0.538, 0.308]
    assert data["lr"]["a"] == [0.15, 0.075]
    assert data["time"] == [16, 12]
    assert data["wer"] == [23.2]
    ours, theirs = tmp_path / "port", tmp_path / "tpk"
    files = metrics.export_txt(str(res), str(ours))
    want = tpk_metrics.export_txt(str(res), str(theirs))
    assert [os.path.basename(f) for f in files] == [
        os.path.basename(f) for f in want]
    assert any(f.endswith("train_loss.txt") for f in files)
    for f, w in zip(files, want):
        assert open(f).read() == open(w).read()
    accs = open(ours / "valid_dev_acc.txt").read().split()
    assert float(accs[1]) > float(accs[0])
    # [] where matplotlib is not installed, as tpukaldi's
    pngs = metrics.create_curves(str(res), str(ours))
    assert [os.path.basename(p) for p in pngs] == [
        os.path.basename(p) for p in tpk_metrics.create_curves(
            str(res), str(theirs))]
    for p in pngs:
        assert os.path.getsize(p) > 0


def test_diagram_matches_tpukaldi():
    program = ("out1=compute(arch1,mfcc)\nout2=compute(arch2,out1)\n"
               "loss_final=cost_nll(out2,lab_cd)\n"
               "err_final=cost_err(out2,lab_cd)")
    svg = diagram.render_svg(parse_model(program), ["mfcc"], ["lab_cd"])
    assert svg == tpk_diagram.render_svg(tpk_parse_model(program), ["mfcc"],
                                         ["lab_cd"])
    assert svg.startswith("<svg")
    assert "out2" in svg and "mfcc" in svg and "</svg>" in svg


def test_gen_example_cfgs_match_tpukaldi(tmp_path):
    ours = gen_example_cfgs.generate_all(str(tmp_path / "port"))
    want = tpk_gen.generate_all(str(tmp_path / "tpk"))
    assert len(ours) == len(want) > 30
    for p, w in zip(ours, want):
        assert os.path.relpath(p, tmp_path / "port") == os.path.relpath(
            w, tmp_path / "tpk")
        assert open(p).read() == open(w).read()


# ------------------------------------------- tests/test_check_data.py
def _setup(tmp_path):
    tree = rh.build_parity_tree(str(tmp_path / "tree"), seed=11)
    cfg = rh.write_parity_cfg(tree, str(tmp_path / "exp"),
                              str(tmp_path / "exp.cfg"), "tpukaldi",
                              arch="MLP")
    return tree, cfg


def _issues(cfg):
    """The port's issues, after holding them to tpukaldi's."""
    got = [(i.severity, i.where, i.message)
           for i in check_data.check_experiment_data(load_config(cfg, []))]
    want = [(i.severity, i.where, i.message) for i in
            tpk_check_data.check_experiment_data(tpk_load_config(cfg, []))]
    assert got == want
    return [msg for sev, _, msg in got if sev == "error"]


def _missing_ark(tree):
    ark = open(tree.scp("train")).readline().split()[1].rpartition(":")[0]
    os.remove(ark)
    return lambda msgs: any("does not exist" in m and ark in m for m in msgs)


def _corrupt_offset(tree):
    scp = tree.scp("train")
    lines = open(scp).read().splitlines()
    utt, rx = lines[0].split(None, 1)
    lines[0] = f"{utt} {rx.rpartition(':')[0]}:999999999"
    open(scp, "w").write("\n".join(lines) + "\n")
    return lambda msgs: any("fails to decode" in m for m in msgs)


def _missing_final_mdl(tree):
    alidir = tree.alidir("train")
    for fn in os.listdir(alidir):
        if fn.endswith(".ark"):
            os.remove(os.path.join(alidir, fn))
    mdl = os.path.join(alidir, "final.mdl")
    if os.path.exists(mdl):
        os.remove(mdl)
    return lambda msgs: any("final.mdl" in m for m in msgs)


def _wrong_counts(tree):
    with open(tree.counts_file, "w") as f:
        f.write("[ " + " ".join(["1.0"] * 3) + " ]\n")
    return lambda msgs: any("classes but the network output" in m
                            for m in msgs)


def _empty_scp(tree):
    open(tree.scp("train"), "w").close()
    return lambda msgs: any("is empty" in m for m in msgs)


@pytest.mark.parametrize("defect", [None, _missing_ark, _corrupt_offset,
                                    _missing_final_mdl, _wrong_counts,
                                    _empty_scp])
def test_check_data_matches_tpukaldi(tmp_path, defect, capsys):
    """A clean tree validates (rc 0, no error), each seeded defect is
    reported (rc 1 where tpukaldi's gives 1), and the port's issues are
    tpukaldi's."""
    tree, cfg = _setup(tmp_path)
    if defect is None:
        assert _issues(cfg) == []
        assert check_data.run_check(cfg) == 0
        assert run_exp.main([cfg, "--check-data"]) == 0
        return
    found = defect(tree)
    msgs = _issues(cfg)
    assert found(msgs), msgs
    assert check_data.run_check(cfg) == tpk_check_data.run_check(cfg) == 1
    capsys.readouterr()


# ---------------------------------------------- tests/test_cli.py:50
def test_console_entry_points_usage_exit_codes():
    """Every `tpukaldi-torch-*` script of pyproject.toml names a port
    `main`; without arguments each gives usage's exit code 2 (the argparse
    ones through SystemExit), plot 1 on a folder without res.res."""
    import tomllib

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items()
            if k.startswith("tpukaldi-torch-")}
    assert sorted(port) == sorted(
        f"tpukaldi-torch-{n}" for n in ("run", "run-chunk", "tune",
                                        "save-raw-fea", "plot", "gen-cfgs",
                                        "export"))
    for target in port.values():
        assert target.startswith("tpukaldi_torch.tools.")
        assert target.endswith(":main")
    assert metrics.main([]) == 2
    assert plot_acc_and_loss.main([]) == 2
    assert plot_acc_and_loss.main(["/nonexistent"]) == 1
    assert tune_hyperparameters.main([]) == 2
    for main in (run_exp.main, run_chunk.main, save_raw_fea.main,
                 export_model.main):
        with pytest.raises(SystemExit) as e:
            main([])
        assert e.value.code == 2


# ----------------------------------------------- a run in both packages
class _Tty(io.StringIO):
    """Standard output that says it is a terminal."""

    def isatty(self):
        return True


def _run(fn, cfg, **kw):
    out = _Tty()
    with contextlib.redirect_stdout(out):
        fn(cfg, **kw)
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same shrunk MLP run (2 epochs of 2 chunks, dropout 0, the same
    initial weights) through tpukaldi and the port on a fake tty, with
    TPUKALDI_PROGRESS unset: {side: (out folder, stdout)}."""
    root = tmp_path_factory.mktemp("tools_run")
    generate_corpus(str(root / "corpus"), n_utts=16, feat_dim=10,
                    n_classes=12, min_len=30, max_len=80, seed=3)
    corpus = load_corpus(str(root / "corpus"))
    saved = os.environ.pop("TPUKALDI_PROGRESS", None)
    runs, init = {}, None
    try:
        # write_cfg writes each cfg to one path in the corpus: run it at once
        for side in ("tpk", "port"):
            out = str(root / side)
            cfg = write_cfg(corpus, out, arch="MLP", n_epochs=2, n_chunks=2,
                            batch_size=16, cw=2, lr=0.05)
            if init is None:
                # dropout 0: torch cannot draw JAX's threefry masks
                init = save_seeded_init(cfg, 10, str(root / "init")) + [
                    "--architecture1,dnn_drop=0.0,0.0"]
                runs[side] = (out, _run(tpk_run_experiment, cfg,
                                        overrides=init))
            else:
                runs[side] = (out, _run(run_exp.run_experiment, cfg,
                                        overrides=init, device="cpu"))
    finally:
        if saved is not None:
            os.environ["TPUKALDI_PROGRESS"] = saved
    return runs


def _files(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, names in os.walk(out) for f in names)


def test_run_writes_tpukaldi_files(runs):
    (tpk_out, _), (port_out, _) = runs["tpk"], runs["port"]
    assert _files(port_out) == _files(tpk_out)
    for name in ("model.svg", "train_loss.txt", "train_acc.txt"):
        assert name in _files(port_out)
    with open(os.path.join(tpk_out, "model.svg"), "rb") as f:
        want = f.read()
    with open(os.path.join(port_out, "model.svg"), "rb") as f:
        assert f.read() == want
    txts = [f for f in _files(tpk_out) if f.endswith(".txt")]
    assert len(txts) >= 4
    for name in txts:
        got = np.loadtxt(os.path.join(port_out, name))
        np.testing.assert_allclose(
            got, np.loadtxt(os.path.join(tpk_out, name)), rtol=0,
            atol=EXPORT_ATOL, err_msg=name)
        assert got.shape == (2,)


_PROGRESS = re.compile(r"\r((?:Training|Validating) \| \(Batch \d+/\d+\))"
                       r"(?: \| L:([\d.]+))?")


def test_progress_line_matches_tpukaldi(runs):
    want = _PROGRESS.findall(runs["tpk"][1])
    got = _PROGRESS.findall(runs["port"][1])
    assert len(want) > 8
    assert [w[0] for w in got] == [w[0] for w in want]
    assert [bool(w[1]) for w in got] == [bool(w[1]) for w in want]
    losses = [(float(g[1]), float(w[1])) for g, w in zip(got, want) if w[1]]
    assert losses
    np.testing.assert_allclose(*zip(*losses), rtol=0, atol=PROGRESS_ATOL)


def test_progress_off(runs, tmp_path, monkeypatch):
    """TPUKALDI_PROGRESS=0 on a tty: no progress line, the run otherwise the
    same."""
    port_out = runs["port"][0]
    cfg = os.path.join(tmp_path, "run.cfg")
    text = open(os.path.join(port_out, "conf.cfg")).read()
    out = str(tmp_path / "quiet")
    open(cfg, "w").write(text.replace(port_out, out))
    monkeypatch.setenv("TPUKALDI_PROGRESS", "0")
    printed = _run(run_exp.run_experiment, cfg, device="cpu")
    assert "\r" not in printed and "(Batch " not in printed
    assert printed.count("ep=") == 2
    shutil.rmtree(out)
