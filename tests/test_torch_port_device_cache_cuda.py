"""The port's device-resident corpus cache on the card: batches gathered on
the device from the resident corpus (uploaded on the cache's side stream,
gathered on the current one) equal the host path's batches.  The file
imports no JAX; without a CUDA device its test skips.

    python -m pytest tests/test_torch_port_device_cache_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from tpukaldi_torch.data.chunk_loader import ChunkData
from tpukaldi_torch.data.device_cache import ChunkIndexData
from tpukaldi_torch.tools.flagship_tree import (
    train_plan,
    write_kaldi_tree,
    write_train_cfg,
)
from tpukaldi_torch.train.chunk_runtime import ChunkRuntime

# CMVN statistics accumulate in another order (tpukaldi's own bound,
# tests/test_device_cache.py); labels, names and lengths exact
HOST_TOL = 2e-6


@pytest.mark.cuda
def test_card_batches_match_host(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tree = write_kaldi_tree(str(tmp_path / "timit"), 10, n_phones=3, n_pdfs=9,
                            splits={"train": (16, 40, 90), "dev": (8, 40, 90),
                                    "test": (4, 40, 90)})
    out = str(tmp_path / "out")
    os.makedirs(out)
    exp, plan = train_plan(write_train_cfg(
        tree, out, os.path.join(out, "run.cfg"), {"n_chunks = 5": "n_chunks = 1"}))
    runtimes = {}
    for mode in ("auto", "0"):
        monkeypatch.setenv("TPUKALDI_DEVICE_CACHE", mode)
        runtimes[mode] = ChunkRuntime(exp, "cuda")
    for task in plan.epochs[0].tasks:
        monkeypatch.setenv("TPUKALDI_DEVICE_CACHE", "auto")
        cm = runtimes["auto"].load_task_chunk(task)
        monkeypatch.setenv("TPUKALDI_DEVICE_CACHE", "0")
        host = runtimes["0"].load_task_chunk(task)
        assert isinstance(cm, ChunkIndexData) and isinstance(host, ChunkData)
        train = task.phase == "train"
        rt = runtimes["auto"]
        pairs = list(zip(rt._batches(cm, 4, train, task.seed),
                         rt._batches(host, 4, train, task.seed), strict=True))
        assert pairs
        for c, h in pairs:
            feats, labs = rt.batch_tensors(cm, c)
            assert feats.is_cuda and labs.is_cuda
            np.testing.assert_allclose(feats.cpu().numpy(), h.feats,
                                       rtol=HOST_TOL, atol=HOST_TOL)
            np.testing.assert_array_equal(labs.cpu().numpy(), h.labs)
            assert c.names == h.names and c.n_valid_t == h.n_valid_t
