"""The port's own copies of tpukaldi's host modules (tpukaldi_torch/config,
io, native, plan, data, forward, decode) against the originals.

Every shipped cfg parses to the same experiment in both packages.  With the
ledger, ark and posterior parity of the other tests/test_torch_port_*.py
files, which now run the port's copies end to end, this guards the copies
against drifting from tpukaldi.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from tpukaldi.config import load_config as tpk_load_config
from tpukaldi.io import feats as tpk_feats
from tpukaldi.io import kaldi_io as tpk_kaldi_io
from tpukaldi.tools import save_raw_fea as tpk_save_raw_fea
from tpukaldi_torch.config import load_config
from tpukaldi_torch.io import feats
from tpukaldi_torch.tools import save_raw_fea

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(os.path.relpath(p, REPO)
              for p in glob.glob(os.path.join(REPO, "cfg", "**", "*.cfg"),
                                 recursive=True))


def _plain(value):
    """An experiment as plain data: dataclasses as dicts (their class names
    differ between the packages), the raw INI as {section: {key: value}}."""
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if hasattr(value, "sections") and hasattr(value, "items"):
        return {name: dict(sec) for name, sec in value.items()}
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


@pytest.mark.parametrize("cfg", CFGS)
def test_cfg_parses_as_in_tpukaldi(cfg):
    """The port's load_config and tpukaldi's give the same experiment for
    every shipped cfg (data paths are not materialised here, so neither
    side checks them nor resolves N_out from alignments)."""
    path = os.path.join(REPO, cfg)
    want = tpk_load_config(path, strict_paths=False, resolve_nout=False)
    got = load_config(path, strict_paths=False, resolve_nout=False)
    assert _plain(got) == _plain(want)


def test_cfg_list_is_complete():
    assert len(CFGS) >= 39
    assert "cfg/DIRHA/QLSTM_mfcc.cfg" in CFGS


FEATURE_OPS = ("compute_cmvn_stats", "splice", "chunk_cmvn", "apply_cmvn",
               "add_deltas")


def _native_lib(mod, monkeypatch):
    """`mod.lib()`, looked up once more if it cached a failed load: under
    xdist another worker may have been writing tpukaldi's library (built in
    its package dir, not atomically) when this worker first loaded it."""
    found = mod.lib()
    if found is None:
        monkeypatch.setattr(mod, "_tried", False)
        found = mod.lib()
    return found


@pytest.mark.parametrize("op", FEATURE_OPS)
def test_host_feature_ops_match_tpukaldi(op, monkeypatch):
    """Splice, chunk CMVN, per-speaker CMVN and deltas of the port's copy
    against tpukaldi's, exactly, like against like: numpy against numpy
    with both native libraries turned off, then native against native
    where both libraries load.  (The native ops and numpy differ in the
    last bits, e.g. chunk_cmvn by ~5e-7, so a side that fell back to numpy
    alone is not compared with the other's native op.)"""
    from tpukaldi import native as tpk_native
    from tpukaldi_torch import native

    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 6)).astype(np.float32)
    stats = tpk_feats.compute_cmvn_stats(x)
    args = {"compute_cmvn_stats": (x,), "splice": (x, 2, 3),
            "chunk_cmvn": (x,), "apply_cmvn": (x, stats, True),
            "add_deltas": (x, 2)}[op]
    libs = (_native_lib(tpk_native, monkeypatch),
            _native_lib(native, monkeypatch))
    with monkeypatch.context() as numpy_only:
        for mod in (tpk_native, native):
            numpy_only.setattr(mod, "lib", lambda: None)
        np.testing.assert_array_equal(getattr(feats, op)(*args),
                                      getattr(tpk_feats, op)(*args),
                                      err_msg=f"{op}, numpy")
    if all(lib is not None for lib in libs):
        np.testing.assert_array_equal(getattr(feats, op)(*args),
                                      getattr(tpk_feats, op)(*args),
                                      err_msg=f"{op}, native")


@pytest.mark.parametrize("n, wlen", [(399, 400), (401, 400), (1000, 400),
                                     (3333, 3200), (6000, 3200)])
def test_window_signal_matches_tpukaldi(n, wlen):
    """The port's copy of `window_signal` against tpukaldi's, exactly: 25 ms
    and 200 ms windows, edges zero-padded the same way, and no frame for a
    signal no longer than one label window.  (Both refuse a signal shorter
    than the window on both sides at once, as the reference does.)"""
    x = np.random.default_rng(n).standard_normal(n)
    want = tpk_save_raw_fea.window_signal(x, wlen, 400, 160)
    got = save_raw_fea.window_signal(x, wlen, 400, 160)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_dump_raw_features_matches_tpukaldi(tmp_path):
    """`dump_raw_features` of a two-utterance wav list: the same scp and the
    same windows (the port's Kaldi I/O copy reads and writes the arks)."""
    rng = np.random.default_rng(1)
    wav_lst = tmp_path / "wav.lst"
    with open(wav_lst, "w") as lst:
        for key, n in (("utt_a", 2400), ("utt_b", 5000)):
            path = tmp_path / f"{key}.vec"
            with open(path, "wb") as f:
                tpk_kaldi_io.write_vec_flt(
                    f, (rng.standard_normal(n) * 3000).astype(np.float32))
            lst.write(f"{key} {path}\n")
    outs = {}
    for side, mod in (("tpk", tpk_save_raw_fea), ("port", save_raw_fea)):
        scp = mod.dump_raw_features(str(wav_lst), str(tmp_path / side),
                                    sig_wlen_ms=25)
        with open(scp) as f:
            outs[side] = [line.split() for line in f]
    assert [r[0] for r in outs["port"]] == [r[0] for r in outs["tpk"]]
    for (key, a), (_, b) in zip(outs["port"], outs["tpk"]):
        assert _read(a).shape[1] == 400
        np.testing.assert_array_equal(_read(a), _read(b))


def _read(rxspec):
    path, offset = rxspec.rsplit(":", 1)
    with open(path, "rb") as f:
        f.seek(int(offset))
        return tpk_kaldi_io.read_mat(f)
