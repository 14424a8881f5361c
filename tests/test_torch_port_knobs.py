"""The knobs the port reads as tpukaldi does, and the ones it does not
implement yet, which raise instead of running something else.

1. `compute_dtype` (`[exp] compute_dtype`, overridden by
   `TPUKALDI_COMPUTE_DTYPE`), read where the port builds its `ChunkRuntime`,
   as tpukaldi's `ChunkRuntime._compute_dtype` reads it
   (`tests/test_bf16.py::test_bad_compute_dtype_rejected`): float32 names
   run in float32, bfloat16 names in the bf16 compute mode, through
   `run_experiment` (the shipped `cfg/TIMIT/liGRU_fmllr_bf16.cfg`) and
   through `run_chunk`, and any other name raises `ValueError`.
2. `[exp] multi_gpu` runs (on the CPU with no process group, world size
   1, as tpukaldi's mesh over one CPU device), `TPUKALDI_NUM_HOSTS=2` runs
   this host's half of the forward tasks (`TPUKALDI_HOST_ID`);
   `TPUKALDI_MATMUL_PRECISION` runs with torch's matching precision for the
   run and the previous one restored after it, and a name it does not know
   raises `ValueError` before any output.
3. `TPUKALDI_PROFILE_DIR` gets a profiler trace of the whole run, as
   tpukaldi's `run_experiment` writes one, also when the run raises; and
   `TPUKALDI_FORWARD_BATCH` defaults to 8, tpukaldi's default off a TPU.
"""

import json
import os

import pytest
import torch

from tpukaldi_torch.plan.chunk_cfg import write_chunk_cfg
from tpukaldi_torch.tools.flagship_tree import (
    recipe_cfg,
    save_seeded_finals,
    train_plan,
    write_kaldi_tree,
    write_prod_cfg,
    write_train_cfg,
)
from tpukaldi_torch.tools.run_chunk import run_chunk
from tpukaldi_torch.tools import run_exp as run_exp_module
from tpukaldi_torch.tools.run_exp import run_experiment
from tpukaldi_torch.train import chunk_runtime
from tpukaldi_torch.train.chunk_runtime import ChunkRuntime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_CFG = os.path.join(REPO, "cfg", "TIMIT", "liGRU_fmllr_bf16.cfg")
SPLITS = {"train": (4, 30, 50), "dev": (2, 30, 50), "test": (3, 30, 60)}
SHRINK = {
    "ligru_lay = 550,550,550,550,550": "ligru_lay = 8",
    "ligru_drop = 0.2,0.2,0.2,0.2,0.2": "ligru_drop = 0.0",
    "ligru_use_laynorm = False,False,False,False,False":
        "ligru_use_laynorm = False",
    "ligru_use_batchnorm = True,True,True,True,True": "ligru_use_batchnorm = True",
    "ligru_act = relu,relu,relu,relu,relu": "ligru_act = relu",
    "n_epochs_tr = 24": "n_epochs_tr = 1",
    "n_chunks = 5": "n_chunks = 1",
}
# every architecture's rmsprop as adam with amsgrad, which the port refuses
AMSGRAD = ("arch_opt = rmsprop\nopt_momentum = 0.0\nopt_alpha = 0.95\n"
           "opt_eps = 1e-8\nopt_centered = False\nopt_weight_decay = 0.0",
           "arch_opt = adam\nopt_betas = 0.9,0.999\nopt_eps = 1e-8\n"
           "opt_weight_decay = 0.0\nopt_amsgrad = True")
KNOBS = ("TPUKALDI_COMPUTE_DTYPE", "TPUKALDI_NUM_HOSTS", "TPUKALDI_HOST_ID",
         "TPUKALDI_MATMUL_PRECISION", "TPUKALDI_PROFILE_DIR",
         "TPUKALDI_FORWARD_BATCH")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_kaldi_tree(str(tmp_path_factory.mktemp("timit")), 10,
                            n_phones=3, n_pdfs=9, splits=SPLITS)


@pytest.fixture(autouse=True)
def no_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


def _bf16_cfg(tree, tmp_path, dtype="bfloat16"):
    out = str(tmp_path / "out")
    return write_train_cfg(
        tree, out, str(tmp_path / "run.cfg"),
        {**SHRINK, "compute_dtype = bfloat16": f"compute_dtype = {dtype}"},
        recipe=BF16_CFG), out


@pytest.mark.parametrize("dtype", ["float32", " F32 ", ""])
def test_float32_names_build_the_runtime(tree, tmp_path, dtype):
    """float32, f32 and the empty name, in any case and with spaces, are
    float32: the runtime's compute dtype is None."""
    cfg, _ = _bf16_cfg(tree, tmp_path, dtype)
    exp, _ = train_plan(cfg)
    rt = ChunkRuntime(exp, "cpu")
    assert rt.device.type == "cpu" and rt.compute_dtype is None


@pytest.mark.parametrize("dtype", ["float16", "fp8"])
def test_bad_compute_dtype_rejected(tree, tmp_path, dtype):
    """A name that is neither float32 nor bfloat16 raises ValueError, with
    tpukaldi's message."""
    cfg, _ = _bf16_cfg(tree, tmp_path, dtype)
    exp, _ = train_plan(cfg)
    with pytest.raises(ValueError, match="compute_dtype must be float32 or "
                                         "bfloat16"):
        ChunkRuntime(exp, "cpu")


@pytest.mark.parametrize("dtype", ["bfloat16", "BF16"])
def test_bf16_cfg_raises_instead_of_running_float32(tree, tmp_path, dtype):
    """The shipped bf16 recipe (its own `compute_dtype` line), shrunk, runs
    through `run_experiment` in the bf16 compute mode, not in float32: its
    runtime computes in torch.bfloat16, and the run trains, validates and
    writes its ledger."""
    cfg, out = _bf16_cfg(tree, tmp_path, dtype)
    exp, _ = train_plan(cfg)
    assert ChunkRuntime(exp, "cpu").compute_dtype == torch.bfloat16
    run_experiment(cfg, device="cpu")
    with open(os.path.join(out, "res.res")) as f:
        assert f.read().startswith("ep=0 ")


@pytest.mark.parametrize("env, raises", [
    ("bfloat16", None), (" bf16", None), ("float16", ValueError),
    ("float32", None)])
def test_compute_dtype_env_overrides_the_cfg(tree, tmp_path, monkeypatch, env,
                                             raises):
    """TPUKALDI_COMPUTE_DTYPE overrides the cfg field, both ways: over the
    float32 recipe bf16 names give the bf16 compute mode (another name
    raises), over the bf16 recipe float32 gives float32."""
    monkeypatch.setenv("TPUKALDI_COMPUTE_DTYPE", env)
    recipe = BF16_CFG if env == "float32" else recipe_cfg("liGRU")
    cfg = write_train_cfg(tree, str(tmp_path / "out"), str(tmp_path / "r.cfg"),
                          SHRINK, recipe=recipe)
    exp, _ = train_plan(cfg)
    if raises is not None:
        with pytest.raises(raises, match="compute_dtype"):
            ChunkRuntime(exp, "cpu")
        return
    want = None if env == "float32" else torch.bfloat16
    assert ChunkRuntime(exp, "cpu").compute_dtype == want


def test_run_chunk_reads_compute_dtype(tree, tmp_path):
    """A chunk cfg carries `compute_dtype` (`plan/chunk_cfg.py`), and the
    standalone chunk runner runs the chunk in bf16: its ledger and
    checkpoints are the in-process runtime's, bit for bit."""
    cfg, _ = _bf16_cfg(tree, tmp_path)
    exp, plan = train_plan(cfg)
    task = plan.epochs[0].tasks[0]
    task.write_lst_files()
    chunk_cfg = write_chunk_cfg(exp, task)
    with open(chunk_cfg) as f:
        assert "compute_dtype = bfloat16" in f.read()
    info = run_chunk(chunk_cfg, "cpu")
    got = chunk_runtime.read_info(info)
    ckpts = {a: open(p, "rb").read() for a, p in task.ckpt_files.items()}
    for p in (info, *task.ckpt_files.values()):
        os.remove(p)
    rt = ChunkRuntime(exp, "cpu")
    rt.run_task(task, epoch_lr={n: a.lr[0] for n, a in exp.archs.items()},
                max_seq_length=exp.batches.msl_for_phase("train", 0),
                batch_size=exp.batches.batch_size_train[0])
    rt.checkpointer.wait()
    want = chunk_runtime.read_info(task.info_file)
    assert (got["loss"], got["err"]) == (want["loss"], want["err"])
    for arch, path in task.ckpt_files.items():
        with open(path, "rb") as f:
            assert f.read() == ckpts[arch], arch


@pytest.mark.parametrize("knob", [
    "multi_gpu", "TPUKALDI_NUM_HOSTS=2", "TPUKALDI_MATMUL_PRECISION=bfloat16",
    "TPUKALDI_MATMUL_PRECISION=tensorfloat32"])
def test_run_level_knobs_run_with_their_settings(tree, tmp_path,
                                                 monkeypatch, knob):
    """Each run-level knob of tpukaldi runs.  multi_gpu on the CPU with no
    process group trains at world size 1 and writes res.res; with
    TPUKALDI_NUM_HOSTS=2 and TPUKALDI_HOST_ID=1 the run trains and
    forwards host 1's half of the forward tasks only.
    TPUKALDI_MATMUL_PRECISION: bfloat16 runs at torch's "medium" float32
    matmul precision, tensorfloat32 at "high", both with cuDNN's TF32 on,
    and the previous setting comes back after the run."""
    out = str(tmp_path / "out")
    shrink = dict(SHRINK)
    if knob == "multi_gpu":
        shrink["multi_gpu = False"] = "multi_gpu = True"
    else:
        name, value = knob.split("=")
        monkeypatch.setenv(name, value)
        if name == "TPUKALDI_NUM_HOSTS":
            monkeypatch.setenv("TPUKALDI_HOST_ID", "1")
    cfg = write_train_cfg(tree, out, str(tmp_path / "run.cfg"), shrink)
    if not knob.startswith("TPUKALDI_MATMUL_PRECISION"):
        # the test split in 3 forward tasks
        with open(cfg) as f:
            head, sep, tail = f.read().partition("[dataset3]")
        with open(cfg, "w") as f:
            f.write(head + sep + tail.replace("n_chunks = 1", "n_chunks = 3", 1))
        run_experiment(cfg, device="cpu")
        with open(os.path.join(out, "res.res")) as f:
            assert f.read().startswith("ep=0 ")
        _, plan = train_plan(cfg)
        done = [t.done for t in plan.forward_tasks]
        assert len(done) > 1
        want = ([i % 2 == 1 for i in range(len(done))]
                if knob.startswith("TPUKALDI_NUM_HOSTS") else [True] * len(done))
        assert done == want
        return
    before = (torch.get_float32_matmul_precision(),
              torch.backends.cudnn.allow_tf32)
    seen = []
    run = run_exp_module._run

    def spy(*args):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cudnn.allow_tf32))
        return run(*args)

    monkeypatch.setattr(run_exp_module, "_run", spy)
    run_experiment(cfg, device="cpu")
    want = {"bfloat16": "medium", "tensorfloat32": "high"}[knob.split("=")[1]]
    assert seen == [(want, True)]
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32) == before
    with open(os.path.join(out, "res.res")) as f:
        assert f.read().startswith("ep=0 ")


@pytest.mark.parametrize("value", ["float16", "fastest"])
def test_unknown_matmul_precision_raises_before_any_output(
        tree, tmp_path, monkeypatch, value):
    """A TPUKALDI_MATMUL_PRECISION the port does not know raises ValueError
    naming the knob, before any output folder is written."""
    monkeypatch.setenv("TPUKALDI_MATMUL_PRECISION", value)
    out = str(tmp_path / "out")
    cfg = write_train_cfg(tree, out, str(tmp_path / "run.cfg"), SHRINK)
    with pytest.raises(ValueError, match="TPUKALDI_MATMUL_PRECISION"):
        run_experiment(cfg, device="cpu")
    assert not os.path.exists(out)


@pytest.mark.parametrize("value", ["float32", " Highest ", ""])
def test_float32_matmul_precision_runs(tree, tmp_path, monkeypatch, value):
    """float32 and highest ask for what the port computes (TF32 off), and an
    empty value is unset, as tpukaldi reads it: the run goes through."""
    monkeypatch.setenv("TPUKALDI_MATMUL_PRECISION", value)
    monkeypatch.setenv("TPUKALDI_NUM_HOSTS", "1")
    out = str(tmp_path / "out")
    cfg = write_train_cfg(tree, out, str(tmp_path / "run.cfg"), SHRINK)
    run_experiment(cfg, device="cpu")
    with open(os.path.join(out, "res.res")) as f:
        assert f.read().startswith("ep=0 ")


@pytest.mark.parametrize("ends", ["done", "raises"])
def test_profile_dir_gets_a_trace_of_the_run(tree, tmp_path, monkeypatch,
                                            ends):
    """With TPUKALDI_PROFILE_DIR set, a CPU run writes one Chrome trace of
    the whole run into that directory when it ends, by an exception too
    (tpukaldi stops its trace in a `finally`): here an amsgrad optimizer,
    which the port refuses when the first train chunk builds it."""
    prof = tmp_path / "prof"
    monkeypatch.setenv("TPUKALDI_PROFILE_DIR", str(prof))
    out = str(tmp_path / "out")
    shrink = dict(SHRINK)
    if ends == "raises":
        shrink[AMSGRAD[0]] = AMSGRAD[1]
    cfg = write_train_cfg(tree, out, str(tmp_path / "run.cfg"), shrink)
    if ends == "raises":
        with pytest.raises(NotImplementedError, match="amsgrad"):
            run_experiment(cfg, device="cpu")
    else:
        run_experiment(cfg, device="cpu")
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(prof / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert events
    if ends == "done":
        # the run's own work is in it: its chunks' steps ran on the CPU
        assert any("aten::" in e.get("name", "") for e in events)


def test_forward_batch_defaults_to_tpukaldis_off_a_tpu(tmp_path):
    """Without TPUKALDI_FORWARD_BATCH the forward stage takes 8 utterances
    a batch on every device (tpukaldi takes 32 only on a TPU): 10 test
    utterances run in 2 forward batches."""
    assert chunk_runtime.DEFAULT_FORWARD_BATCH == 8
    splits = {"train": (2, 30, 40), "dev": (2, 30, 40), "test": (10, 30, 40)}
    small = write_kaldi_tree(str(tmp_path / "timit"), 10, n_phones=3,
                             n_pdfs=9, splits=splits)
    out = str(tmp_path / "out")
    cfg = write_prod_cfg(small, out, str(tmp_path / "run.cfg"), SHRINK)
    save_seeded_finals(cfg, dim=10)
    chunk_runtime.forward_batches = 0
    run_experiment(cfg, device="cpu")
    assert chunk_runtime.forward_batches == 2
