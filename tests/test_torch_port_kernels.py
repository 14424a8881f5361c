"""The port's Li-GRU recurrence (tpukaldi_torch/kernels/ligru.py) against
tpukaldi's: the Pallas kernel in interpret mode and the lax.scan version.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is compared with that plain version on a card.  Inputs come
from numpy with a seed.  Tolerance: 1e-5 absolute — all three are float32
with the same operation order per step except the h @ U sum, whose
reordering moves the last bits only.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.kernels.ligru import ligru_recurrence as jax_ligru
from tpukaldi.kernels.ligru import ligru_recurrence_scan
from tpukaldi_torch.kernels import _build
from tpukaldi_torch.kernels import ligru as port
from tpukaldi_torch.tools import (
    conv_bwd_phases,
    conv_fwd_phases,
    ligru_bwd_phases,
    ligru_fwd_phases,
)
from tpukaldi_torch.tools.lstm_fwd_phases import variants

ATOL = 1e-5


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    ff = rng.standard_normal((T, B, 2 * H)).astype(np.float32)
    u = (rng.standard_normal((H, 2 * H)) / np.sqrt(H)).astype(np.float32)
    # mask != 1: train-style Bernoulli rows scaled like the eval (1-p) factor
    mask = ((rng.random((B, H)) < 0.8) * 0.8).astype(np.float32)
    return ff, u, mask


@pytest.mark.parametrize("T,B", [(13, 2), (37, 6)])
def test_ligru_recurrence_matches_jax(T, B):
    """T not a multiple of the Pallas time block (16), mask != 1."""
    H = 16
    ff, u, mask = _inputs(T, B, H, seed=T * 10 + B)
    got = port.ligru_recurrence(
        torch.from_numpy(ff), torch.from_numpy(u), torch.from_numpy(mask)
    ).numpy()
    want_pallas = np.asarray(jax_ligru(jnp.asarray(ff), jnp.asarray(u),
                                       jnp.asarray(mask), True))
    want_scan = np.asarray(ligru_recurrence_scan(
        jnp.asarray(ff), jnp.asarray(u), jnp.asarray(mask)))
    assert got.shape == (T, B, H)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_scan, rtol=0, atol=ATOL)


def test_ligru_cpu_path_counts_no_launch():
    before = port.launches
    ff, u, mask = _inputs(5, 2, 8, seed=1)
    port.ligru_recurrence(torch.from_numpy(ff), torch.from_numpy(u),
                          torch.from_numpy(mask))
    assert port.launches == before


@pytest.mark.parametrize("H,units", [(11, 4), (12, 5), (550, 6), (36, 1)])
def test_ligru_fwd_pack_holds_whole_pairs(H, units):
    """K1f's U operand (`_pack`) in the layout `csrc/ligru_fwd.cu` states:
    CTA q's block of H rows of ld floats, ld the units' pairs two to a
    16-byte word padded to an odd number of words (the kernel's
    `row_floats`), each word two units' (uh, uz) pairs, zeros in the last
    word's second pair at odd u, past the last CTA's units and in the
    padding words; float32 and contiguous."""
    u = torch.arange(1, H * 2 * H + 1, dtype=torch.float32).reshape(H, 2 * H)
    ld = 4 * (-(-units // 2) | 1)
    upk = port._pack(u, H, units, ld)
    P = -(-H // units)
    assert upk.dtype == torch.float32 and upk.is_contiguous()
    assert upk.shape == (P, H, ld)
    words = upk.view(P, H, ld // 4, 4)
    for q in range(P):
        for w in range(ld // 4):
            for half in range(2):
                jj = 2 * w + half
                j = q * units + jj
                pair = words[q, :, w, 2 * half:2 * half + 2]
                if jj < units and j < H:
                    assert torch.equal(pair[:, 0], u[:, j])
                    assert torch.equal(pair[:, 1], u[:, H + j])
                else:
                    assert not pair.any()


@pytest.mark.parametrize("H,units", [(11, 4), (13, 6), (550, 6), (36, 1),
                                     (1, 2)])
def test_ligru_bwd_pack_holds_whole_pairs(H, units):
    """K1b's U operand (`_pack_bwd`) in the layout `csrc/ligru_bwd.cu`
    states: CTA q's block of H rows k of ld floats, each 16-byte word two
    units' (Uh[j, k], Uz[j, k]) pairs, i.e. U's row j = q units + jj, then
    zeros in the last word's second pair at odd u, past the last CTA's units
    (13 = 2 x 6 + 1 leaves a CTA of one unit) and in the padding words;
    float32, contiguous, so that each CTA's block is one contiguous run."""
    u = torch.arange(1, H * 2 * H + 1, dtype=torch.float32).reshape(H, 2 * H)
    ld = 4 * (-(-units // 2) | 1)
    upk = port._pack_bwd(u, H, units, ld)
    P = -(-H // units)
    assert upk.dtype == torch.float32 and upk.is_contiguous()
    assert upk.shape == (P, H, ld)
    words = upk.view(P, H, ld // 4, 4)
    for q in range(P):
        for w in range(ld // 4):
            for half in range(2):
                jj = 2 * w + half
                j = q * units + jj
                pair = words[q, :, w, 2 * half:2 * half + 2]
                if jj < units and j < H:
                    assert torch.equal(pair[:, 0], u[j, :H])
                    assert torch.equal(pair[:, 1], u[j, H:])
                else:
                    assert not pair.any()
    # the backward's pairs are the forward's of U's transposed halves
    ut = torch.cat([u[:, :H].t(), u[:, H:].t()], dim=1).contiguous()
    assert torch.equal(upk, port._pack(ut, H, units, ld))


def test_ligru_bwd_phase_variants_cut_what_they_name():
    """`tools/ligru_bwd_phases.py` builds K1b's variants by replacing lines
    of `csrc/ligru_bwd.cu`: each line is there once, each variant differs
    from the source, and each cut variant cuts what it names (the product,
    the stream, the grid barrier, the chain's steps, dU) and keeps the
    rest."""
    source = ligru_bwd_phases.source()
    with open(os.path.join(_build._CSRC, port.BWD_SOURCE)) as f:
        assert f.read() == source
    got = variants(source, ligru_bwd_phases.VARIANTS)
    assert got["as built"] == source
    assert all(text != source for name, text in got.items()
               if name != "as built")
    cuts = {"kk < 0": "product", "i < 0": "stream", "t >= p.T;": "steps",
            "// no dU": "du"}
    want = {"no product": {"product"}, "no stream": {"stream"},
            "neither": {"product", "stream"},
            "no barriers": {"product", "stream", "barrier"},
            "no steps": {"steps"}, "remat only": {"steps", "du"}}
    for name, (_, exact) in ligru_bwd_phases.VARIANTS.items():
        assert exact == (name not in want), name
    for name, text in got.items():
        found = {cut for mark, cut in cuts.items() if mark in text}
        if "tpk::grid_arrive" not in text:
            # both halves of the barrier go together
            assert "tpk::grid_wait" not in text, name
            found.add("barrier")
        assert found == want.get(name, set()), name
    # the variants of the same arithmetic change only what they name
    assert "kRows = 8;" in got["rows 8"]
    for width in (128, 512, 1024):
        assert f"kMaxChunk = {width};" in got[f"chunk {width}"]
    for old, _ in (ligru_bwd_phases._NO_PRODUCT, ligru_bwd_phases._NO_STREAM,
                   *ligru_bwd_phases._NO_BARRIERS, ligru_bwd_phases._NO_STEPS,
                   ligru_bwd_phases._NO_DU):
        assert source.count(old) == 1
        with pytest.raises(ValueError, match="not in the source once"):
            variants(source.replace(old, ""), ligru_bwd_phases.VARIANTS)


def test_ligru_fwd_phase_variants_cut_what_they_name():
    """`tools/ligru_fwd_phases.py` builds K1f's variants by replacing lines
    of `csrc/ligru_fwd.cu`: each line is there once, each variant differs
    from the source, and each cut variant cuts what it names (the product,
    the stream, the grid barrier, the time loop) and keeps the rest."""
    source = ligru_fwd_phases.source()
    got = variants(source, ligru_fwd_phases.VARIANTS)
    assert got["as built"] == source
    assert all(text != source for name, text in got.items()
               if name != "as built")
    cuts = {"kk < 0": "product", "i < 0": "stream", "t < 0; ++t": "steps"}
    want = {"no product": {"product"}, "no stream": {"stream"},
            "neither": {"product", "stream"},
            "no barriers": {"product", "stream", "barrier"},
            "no steps": {"steps"}}
    for name, (_, exact) in ligru_fwd_phases.VARIANTS.items():
        assert exact == (name not in want), name
    for name, text in got.items():
        found = {cut for mark, cut in cuts.items() if mark in text}
        if "tpk::grid_arrive" not in text:
            # both halves of the barrier go together
            assert "tpk::grid_wait" not in text, name
            found.add("barrier")
        assert found == want.get(name, set()), name
    # the variants of the same arithmetic change only what they name
    assert "kRows = 8;" in got["rows 8"]
    assert "kMaxChunk = 128;" in got["chunk 128"]
    assert "u += u % 2;" not in got["odd u"] and "u += u % 2;" in source
    for old, _ in (ligru_fwd_phases._NO_PRODUCT, ligru_fwd_phases._NO_STREAM,
                   *ligru_fwd_phases._NO_BARRIERS, ligru_fwd_phases._NO_STEPS):
        assert source.count(old) == 1
        with pytest.raises(ValueError, match="not in the source once"):
            variants(source.replace(old, ""), ligru_fwd_phases.VARIANTS)


def test_conv_bwd_phase_variants_cut_what_they_name():
    """`tools/conv_bwd_phases.py` builds K5b's and K6b's variants by
    replacing lines across `csrc/conv_pool_bwd.cu`, `conv_ln_bwd.cu`,
    `conv_pool_bwd.cuh` and `conv_tile.cuh`: each line is there once in
    all, each variant differs from the sources, each `<launch> only`
    variant keeps that kind of launch and cuts the three others, and the
    tilings change only the constant they name."""
    files = conv_bwd_phases.sources()
    got = conv_bwd_phases.variant_files(files)
    assert got["as built"] == files
    assert all(texts != files for name, texts in got.items()
               if name != "as built")
    marks = {"ln": "conv_ln_bwd_kernel<<<", "dx": "conv_pool_dx_tile_kernel<<<",
             "dw": "conv_pool_dw_part_kernel<<<",
             "sums": "reduce_windows_kernel<<<"}
    for name, (_, exact) in conv_bwd_phases.VARIANTS.items():
        assert exact == (not name.endswith(" only")), name
        text = "".join(got[name].values())
        cut = {part for part, mark in marks.items()
               if f"if (false) {mark}" in text}
        assert all(text.count(mark) == 1 for mark in marks.values()), name
        want = set(marks) - {name.split()[0]} if not exact else set()
        assert cut == want, name
    changed = {"R 3": "kDxRun = 3;", "R 7": "kDxRun = 7;",
               "R 9": "kDxRun = 9;", "filters 4": "kDxFilt = 4;",
               "filters 16": "kDxFilt = 16;",
               "threads 256": "kDxThreads = 256;",
               "unroll 2": "#pragma unroll 2\n      for (int k0 = 0;",
               "dw warps 4": "kDwWarps = 4;", "dw warps 16": "kDwWarps = 16;"}
    for name, mark in changed.items():
        diff = [f for f in files if got[name][f] != files[f]]
        assert len(diff) == 1 and mark in got[name][diff[0]], name
    for line in (conv_bwd_phases._LN, conv_bwd_phases._DX,
                 conv_bwd_phases._DW, conv_bwd_phases._SUM):
        assert sum(t.count(line) for t in files.values()) == 1
        broken = {f: t.replace(line, "") for f, t in files.items()}
        with pytest.raises(ValueError, match="not in the sources once"):
            conv_bwd_phases.variant_files(broken)


def test_conv_fwd_phase_variants_cut_what_they_name():
    """`tools/conv_fwd_phases.py` builds K5f's and K6f's variants by
    replacing lines across `csrc/conv_pool_fwd.cu`, `conv_ln_fwd.cu` and
    their headers: each line is there once in all, each variant differs
    from the sources, `conv only` cuts the pipeline's epilogue call and
    `epilogue only` its conv, and the tilings change only the constant
    they name."""
    m = conv_fwd_phases
    files = m.sources()
    assert set(files) == set(m.FILES)
    got = m.variant_files(files, m.VARIANTS)
    assert got["as built"] == files
    assert all(texts != files for name, texts in got.items()
               if name != "as built")
    cuts = {"epilogue": f"if (false) {m._EPI.lstrip()}",
            "conv": f"if (false) {m._CONV.lstrip()}"}
    want = {"conv only": {"epilogue"}, "epilogue only": {"conv"}}
    for name, (_, exact) in m.VARIANTS.items():
        assert exact == (name not in want), name
        text = "".join(got[name].values())
        assert {cut for cut, mark in cuts.items()
                if mark in text} == want.get(name, set()), name
    header = "conv_fwd.cuh"
    changed = {"P 24 F 2": (header, ["kFwdRun = 24;", "kTileF = 2;"]),
               "F 2": (header, ["kTileF = 2;"]),
               "filters 32": (header, ["kFwdFilt = 32;"]),
               "K5f warps 8 + 8": ("conv_pool_fwd.cu", ["FwdWarps<8, 8>;"]),
               "K6f warps 12 + 4": ("conv_ln_fwd.cu", ["FwdWarps<12, 4>;"]),
               "K6f warps 8 + 4": ("conv_ln_fwd.cu", ["FwdWarps<8, 4>;"]),
               "long block only": (header, ["inline bool fwd_short(int M, "
                                            "int pool) {\n  return false;"]),
               "short block only": (header, ["inline bool fwd_short(int M, "
                                             "int pool) {\n  return true;"]),
               "K6f short 4 + 4": ("conv_ln_fwd.cu",
                                   ["Short = tpk::FwdWarps<4, 4>;"]),
               "balanced grid": (header, ["  const int most = "]),
               "one buffer": (header, ["kMaxBufs = 1;"]),
               "not persistent": (header, ["kPersistent = false;"]),
               "plain stage": (header, ["  if (false) {\n    done = "])}
    assert set(changed) | set(want) | {"as built"} == set(m.VARIANTS)
    for name, (where, marks) in changed.items():
        diff = [f for f in files if got[name][f] != files[f]]
        assert diff == [where], name
        assert all(mark in got[name][where] for mark in marks), name
    for line in (m._EPI, m._CONV, m._STAGE, m._K5_WARPS, m._K6_WARPS,
                 m._K6_SHORT, m._SHORT, m._GRID):
        assert sum(t.count(line) for t in files.values()) == 1
        broken = {f: t.replace(line, "") for f, t in files.items()}
        with pytest.raises(ValueError, match="not in the sources once"):
            m.variant_files(broken, m.VARIANTS)


# K1f's main small shape, then the edges of its tiling, as K2f's: an odd
# batch with H not a multiple of 16, a batch of two passes (more than 128
# rows), and the widest U slice (h staged in narrower chunks)
@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(41, 6, 64), (37, 5, 36), (50, 136, 550),
                                   (50, 96, 1024)])
def test_ligru_kernel_matches_plain_on_card(T, B, H):
    """The CUDA kernel against its plain version on the same card.  1e-4:
    the kernel sums h @ U per depth slice and then across slices, cuBLAS in
    tiles, and the difference compounds over the recurrence's steps.  Two
    calls on the same inputs give the same bits (the kernel's sums run in a
    fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    ff, u, mask = _inputs(T, B, H, seed=2)
    args = [torch.from_numpy(a).cuda() for a in (ff, u, mask)]
    before = port.launches
    with torch.inference_mode():
        got = port.ligru_recurrence(*args)
        again = port.ligru_recurrence(*args)
        want = port.ligru_recurrence_ref(*args)
    torch.cuda.synchronize()
    assert port.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
