"""The port's msgpack checkpoint codec (tpukaldi_torch/train/checkpoint.py)
against tpukaldi's flax-serialized checkpoints, both directions, bit-exact.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from tpukaldi.train.checkpoint import load_checkpoint, save_checkpoint
from tpukaldi_torch.train.checkpoint import (
    load_all,
    packb,
    read_checkpoint,
    save_all,
    unpackb,
    write_checkpoint,
)
from tpukaldi_torch.models import MLP


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "wh0": rng.standard_normal((7, 5)).astype(np.float32),
        "uh0": rng.standard_normal((5, 5)).astype(np.float32),
        "bn_ff0": {"scale": rng.standard_normal(10).astype(np.float32),
                   "bias": rng.standard_normal(10).astype(np.float32)},
        # > 64 KiB payload: the 32-bit ext length form
        "big": rng.standard_normal((130, 130)).astype(np.float32),
    }


def _assert_bit_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert a.tobytes() == b.tobytes(), path


def test_port_reads_tpukaldi_checkpoint_bit_exact(tmp_path):
    """tpukaldi's save_checkpoint, optimizer state included, read by the port."""
    from flax import serialization

    params = _tree(0)
    opt_state = optax.rmsprop(1e-3, decay=0.95).init(params)
    stats = {"bn_ff0": {"mean": np.arange(10, dtype=np.float32),
                        "var": np.ones(10, np.float32)}}
    path = str(tmp_path / "tpk.ckpt")
    save_checkpoint(path, params, opt_state, stats)
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got_params, got_opt, got_stats = read_checkpoint(path)
    _assert_bit_equal(got_params, want["params"])
    _assert_bit_equal(got_opt, want["opt_state"])
    _assert_bit_equal(got_stats, want["batch_stats"])
    _assert_bit_equal(got_params, params)


def test_tpukaldi_reads_port_checkpoint_bit_exact(tmp_path):
    params = _tree(1)
    stats = {"bn_ff0": {"mean": np.full(10, 0.25, np.float32),
                        "var": np.linspace(0.5, 2.0, 10).astype(np.float32)}}
    path = str(tmp_path / "port.ckpt")
    write_checkpoint(path, params, None, stats)
    template_p = jax.tree_util.tree_map(np.zeros_like, params)
    template_s = jax.tree_util.tree_map(np.zeros_like, stats)
    got_p, _, got_s = load_checkpoint(path, template_p, None, template_s)
    _assert_bit_equal(jax.tree_util.tree_map(np.asarray, got_p), params)
    _assert_bit_equal(jax.tree_util.tree_map(np.asarray, got_s), stats)


@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, -1, -33, 70000, -70000, 2**40, -2**40,
    1.5, "", "x" * 40, b"\x00\x01", [1, [2, 3]], list(range(20)),
    {f"k{i}": i for i in range(20)}, np.float32(2.5), np.int32(-7),
])
def test_msgpack_scalars_round_trip(value):
    """Every wire form the codec writes reads back; flax's encoder agrees."""
    import msgpack
    from flax import serialization

    got = unpackb(packb(value))
    if isinstance(value, np.generic):
        assert got == value and got.dtype == value.dtype
    else:
        assert got == value
    assert packb(value) == msgpack.packb(
        value, default=serialization._msgpack_ext_pack, strict_types=True)


def test_save_all_load_all_round_trip_modules(tmp_path):
    opts = dict(dnn_lay="6,4", dnn_drop="0.0,0.0",
                dnn_use_batchnorm="True,False", dnn_use_laynorm="False,False",
                dnn_act="relu,softmax")
    src = MLP(opts, 5)
    src.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        src.bn[0].running_mean.uniform_(-1, 1)
    paths = {"head": str(tmp_path / "final_head.ckpt")}
    save_all(paths, {"head": src})
    dst = MLP(opts, 5)
    load_all(paths, {"head": dst})
    for k, v in src.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, dst.state_dict()[k]), k
