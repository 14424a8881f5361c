"""The port's whole raw conv stack (tpukaldi_torch/kernels/conv_stack.py)
against tpukaldi's `kernels/conv_stack.py::conv_stack_fused`, on the CPU at
small sizes.

1. The plain stack (`conv_stack_ref`, `conv_stack_bwd_ref`) and the
   autograd Function around it against tpukaldi's Pallas kernel pair run in
   interpret mode at "highest" precision, forward and every gradient
   through `jax.vjp`, at drop 0 and drop > 0: a short layer 0 (K0 = 9) with
   two upper layers, the tail taps (K0 = 129), an upper layer of 60 filters
   (the mask's 128-stride element id), an odd batch and a linear stack.
2. The per-layer salted masks bit for bit against tpukaldi's `_drop_mask`.
3. At drop 0 the stack equals the port's `CNN` module in eval mode with the
   same weights (its gamma and beta transposed to the stack's time-major
   layout).
4. The gate, the geometry, the shape checks, the launch counters, and the
   kernels against their plain versions on a card (skipped without one).
5. The pooled value y each upper layer keeps for the backward: the plain
   forward's equals the plain backward's recompute of it, the plain
   backward gives the same bits with y and without, `ConvStack` saves it,
   and `conv_stack_bwd` refuses a y of the wrong shape or dtype.

Inputs come from numpy with a seed.  Each tolerance is stated where it is
used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.kernels import conv1d as jax_conv
from tpukaldi.kernels import conv_stack as jax_stack
from tpukaldi_torch.kernels import conv1d, conv_stack
from tpukaldi_torch.models import CNN

# float32 on both sides, sums in other orders through a few layer norms:
# the outputs are of order 1-10
FWD_ATOL = 1e-5
# gradients: sums of hundreds of terms in other orders, relative to each
# tensor's max
GRAD_RTOL = 2e-4
EPS = 1e-6
SEED = -987654321


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close_rel(got, want, rtol, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=name)


def _stack_inputs(N, L, K0, ups, pools, seed):
    """x, w0, bias0, gt0, bt0, ups ((kernel, bias, gamma, beta) per upper
    layer, as (O, K) in `ups`) and a cotangent of the output, in numpy."""
    rng = np.random.default_rng(seed)
    geo = conv_stack.stack_geometry(L, [K0] + [k for _, k in ups], pools)
    O0, M0 = 128, geo[0][4]
    x = rng.standard_normal((N, L)).astype(np.float32)
    w0 = (rng.standard_normal((K0, O0)) / np.sqrt(K0)).astype(np.float32)
    bias0 = rng.standard_normal(O0).astype(np.float32)
    gt0 = (1 + 0.3 * rng.standard_normal((M0, O0))).astype(np.float32)
    bt0 = (0.3 * rng.standard_normal((M0, O0))).astype(np.float32)
    layers, prev = [], O0
    for (O, K), (_, _, _, _, M) in zip(ups, geo[1:]):
        layers.append((
            (rng.standard_normal((O, prev, K)) / np.sqrt(prev * K)).astype(
                np.float32),
            rng.standard_normal(O).astype(np.float32),
            (1 + 0.3 * rng.standard_normal((M, O))).astype(np.float32),
            (0.3 * rng.standard_normal((M, O))).astype(np.float32)))
        prev = O
    dz = rng.standard_normal((N, geo[-1][4], prev)).astype(np.float32)
    return x, w0, bias0, gt0, bt0, tuple(layers), dz


# ------------------------------------------------- 1. against tpukaldi
# (N, L, K0, upper layers as (O, K), pools, drops, relu)
CASES = {
    # K0 = 9, pool 2, M0 = 64, two upper layers of K 3, O 8, pool 2
    "short_k0": (8, 136, 9, [(8, 3), (8, 3)], (2, 2, 2), (0.0, 0.0, 0.0),
                 True),
    # the same at drop 0.15 with an odd batch (two of tpukaldi's 8-window
    # programs, the second padded)
    "short_k0_drop_odd_n": (11, 136, 9, [(8, 3), (8, 3)], (2, 2, 2),
                            (0.15, 0.15, 0.15), True),
    # K0 = 129: the tail taps past tpukaldi's 128-row pass
    "tail_taps": (8, 256, 129, [(16, 5)], (2, 3), (0.0, 0.0), True),
    # an upper layer of 60 filters at drop 0.15 pins the element id m*128+o;
    # linear (relu off) so the mask alone gates the gradient
    "o60_drop": (5, 136, 9, [(60, 5)], (2, 3), (0.15, 0.15), False),
}


def _tpk(x, w0, bias0, gt0, bt0, ups, pools, drops, relu):
    """tpukaldi's kernel pair in interpret mode: (out, vjp).  `ups` goes in
    as a tuple: jax.grad through the custom vjp refuses a list."""
    f = lambda *a: jax_stack.conv_stack_fused(  # noqa: E731
        *a, SEED, tuple(pools), EPS, relu, tuple(drops), True, "highest")
    args = [jnp.asarray(a) for a in (x, w0, bias0, gt0, bt0)]
    jups = tuple(tuple(jnp.asarray(t) for t in u) for u in ups)
    return jax.vjp(f, *args, jups)


@pytest.mark.parametrize("case", list(CASES))
def test_stack_matches_tpukaldi(case):
    """out of the plain stack and of `ConvStack` to FWD_ATOL of tpukaldi's
    interpret-mode kernel, with the same dropped elements; dx, dw0, dgt0,
    dbt0 and every upper layer's dW, dgamma, dbeta to GRAD_RTOL of each
    tensor's max against its `jax.vjp`, through both the plain backward and
    autograd; every conv bias's gradient an exact zero on both sides."""
    N, L, K0, ups, pools, drops, relu = CASES[case]
    n_filt = [128] + [o for o, _ in ups]
    len_filt = [K0] + [k for _, k in ups]
    assert jax_stack.stack_supported(len_filt, n_filt, L, pools)
    x, w0, bias0, gt0, bt0, layers, dz = _stack_inputs(N, L, K0, ups, pools,
                                                       seed=len(case))
    want, vjp = _tpk(x, w0, bias0, gt0, bt0, layers, pools, drops, relu)
    want = np.asarray(want)
    grads_j = vjp(jnp.asarray(dz))

    tl = [tuple(_t(a) for a in u) for u in layers]
    out, idx0, stats0, res = conv_stack.conv_stack_ref(
        _t(x), _t(w0), _t(bias0), _t(gt0), _t(bt0), tl, SEED, pools, EPS,
        relu, drops)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=FWD_ATOL)
    np.testing.assert_array_equal(out.numpy() == 0, want == 0)
    assert len(res) == len(ups)
    got_ref = conv_stack.conv_stack_bwd_ref(
        _t(x), _t(w0), _t(bias0), _t(gt0), _t(bt0), tl, SEED, idx0, stats0,
        res, _t(dz), pools, EPS, relu, drops)

    leaves = [_t(a).requires_grad_() for a in (x, w0, bias0, gt0, bt0)]
    up_leaves = [[_t(a).requires_grad_() for a in u] for u in layers]
    got = conv_stack.conv_stack_fused(*leaves, up_leaves, SEED, pools, EPS,
                                      relu, drops)
    np.testing.assert_array_equal(got.detach().numpy(), out.numpy())
    (got * _t(dz)).sum().backward()
    got_fn = (*[a.grad for a in leaves], [[a.grad for a in u] for u in up_leaves])

    for grads in (got_ref, got_fn):
        assert torch.equal(grads[2], torch.zeros(128))
        assert np.array_equal(np.asarray(grads_j[2]), np.zeros(128))
        for name, i in (("dx", 0), ("dw0", 1), ("dgt0", 3), ("dbt0", 4)):
            _close_rel(grads[i], grads_j[i], GRAD_RTOL, name)
        for k, (g_up, j_up) in enumerate(zip(grads[5], grads_j[5]), 1):
            assert torch.equal(g_up[1], torch.zeros_like(g_up[1]))
            assert np.array_equal(np.asarray(j_up[1]), np.zeros_like(j_up[1]))
            for name, i in (("dW", 0), ("dgamma", 2), ("dbeta", 3)):
                _close_rel(g_up[i], j_up[i], GRAD_RTOL, f"layer {k} {name}")


# ------------------------------------------------- 2. the masks
@pytest.mark.parametrize("seed", [-1, 2 ** 31 - 1, 123456789])
def test_stack_masks_are_tpukaldis_bit_for_bit(seed):
    """Layer i's mask of window n is tpukaldi's `_drop_mask` at window id
    n + i * 2^20 over (M, 128) lanes, the first O of them, element for
    element, for 60 filters as for 128 (layer 0, K6's own mask)."""
    N, M, drop = 11, 9, 0.15
    for layer, O in ((0, 128), (1, 60), (2, 60), (3, 8)):
        got = conv_stack.stack_mask(seed, N, layer, M, O, drop)
        assert got.shape == (N, M, O) and got.dtype == torch.bool
        for n in range(N):
            want = np.asarray(jax_conv._drop_mask(
                jnp.full((1, 1), seed, jnp.int32),
                jnp.int32(n + layer * 2 ** 20), (M, 128), drop))[:, :O]
            np.testing.assert_array_equal(got[n].numpy(), want)
        if layer == 0:
            np.testing.assert_array_equal(
                got.numpy(), conv1d.drop_mask(seed, torch.arange(N), M, O,
                                              drop).numpy())
    # the salt moves the stream: layer 1's mask is not layer 0's
    assert not torch.equal(conv_stack.stack_mask(seed, N, 0, M, 60, drop),
                           conv_stack.stack_mask(seed, N, 1, M, 60, drop))


# ------------------------------------------------- 3. the port's module
CNN_OPTS = dict(
    cnn_n_filt="128,12,8", cnn_len_filt="9,3,3", cnn_max_pool_len="2,2,2",
    cnn_use_laynorm_inp="False", cnn_use_batchnorm_inp="False",
    cnn_use_laynorm="True,True,True", cnn_use_batchnorm="False,False,False",
    cnn_act="relu,relu,relu", cnn_drop="0.0,0.0,0.0")


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_stack_equals_cnn_module_at_drop0(impl, monkeypatch):
    """At drop 0 the stack computes what the port's `CNN` computes in eval
    mode (auto: the composed path on CPU; pallas: K6's plain version for
    layer 0) from the same weights, the module's (filt, time) gamma and
    beta transposed to time-major: its flattened (N, filt * time) output
    within FWD_ATOL."""
    monkeypatch.setenv("TPUKALDI_CONV_IMPL", impl)
    L = 136
    module = CNN(CNN_OPTS, L).eval()
    module.reset_parameters(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(6)
    with torch.no_grad():
        for ln in module.ln:
            ln.gamma.copy_(_t(1 + 0.3 * rng.standard_normal(ln.gamma.shape)))
            ln.beta.copy_(_t(0.3 * rng.standard_normal(ln.beta.shape)))
    x = _t(rng.standard_normal((7, L)).astype(np.float32))
    with torch.no_grad():
        want = module(x)
        ups = [(module.conv[i].weight, module.conv[i].bias,
                module.ln[i].gamma.t(), module.ln[i].beta.t())
               for i in (1, 2)]
        got = conv_stack.conv_stack_fused(
            x, module.conv[0].weight[:, 0, :].t(), module.conv[0].bias,
            module.ln[0].gamma.t(), module.ln[0].beta.t(), ups, 0,
            module.pool, EPS, True, (0.0, 0.0, 0.0))
    assert got.shape == (7, 14, 8) and want.shape == (7, 8 * 14)
    np.testing.assert_allclose(got.transpose(1, 2).reshape(7, -1).numpy(),
                               want.numpy(), rtol=0, atol=FWD_ATOL)


# ------------------------------------------------- 4. gate, shapes, card
def test_stack_geometry_is_tpukaldis():
    """(lin, K, pool, ct, M) per layer as tpukaldi's `stack_geometry`, at
    CNN_raw's stack: M = 1024, 340, 112, 55 over 3200 samples."""
    args = (3200, (129, 5, 5, 3), (3, 3, 3, 2))
    geo = conv_stack.stack_geometry(*args)
    assert geo == jax_stack.stack_geometry(*args)
    assert [g[4] for g in geo] == [1024, 340, 112, 55]
    assert geo[3][3] == 110  # layer 3's conv covers 110 rows of 110


@pytest.mark.parametrize("len_filt, n_filt, inp_dim, pools", [
    ((129, 5, 5, 3), (128, 60, 60, 60), 3200, (3, 3, 3, 2)),  # CNN_raw
    ((9, 3, 3), (128, 8, 8), 136, (2, 2, 2)),
    ((129, 5), (128, 16), 256, (2, 3)),
    ((9, 5), (128, 60), 136, (2, 3)),
    ((25, 8), (128, 128), 536, (2, 1)),
])
def test_gate_admits_what_tpukaldis_admits(len_filt, n_filt, inp_dim, pools):
    """CNN_raw's stack and the tiny stacks tpukaldi's gate admits pass the
    port's."""
    assert jax_stack.stack_supported(len_filt, n_filt, inp_dim, pools)
    assert conv_stack.stack_supported(len_filt, n_filt, inp_dim, pools)


@pytest.mark.parametrize("len_filt, n_filt, inp_dim, pools, reason", [
    ((129,), (128,), 3200, (3,), "at least one upper layer"),
    ((129, 5), (80, 60), 3200, (3, 3), "128 filters"),
    ((130, 5), (128, 60), 3200, (3, 3), "K <= 129"),
    ((129, 9), (128, 60), 3200, (3, 3), "K <= 8"),
    ((129, 5), (128, 129), 3200, (3, 3), "1 to 128 filters"),
    ((129, 5), (128, 60), 3200, (13, 3), "pool <= 12"),
    ((129, 5), (128, 60), 3200, (3, 13), "pool <= 12"),
    ((129, 5, 5), (128, 60, 60), 150, (3, 3, 3), "no pooled row"),
    ((129, 5), (128, 60), 3200, (3,), "filters and a pool"),
])
def test_gate_refuses_with_the_reason(len_filt, n_filt, inp_dim, pools,
                                      reason):
    """Outside the kernels' limits the gate raises ValueError naming the
    limit; it does not fall back."""
    with pytest.raises(ValueError, match=reason):
        conv_stack.stack_supported(len_filt, n_filt, inp_dim, pools)


def test_shapes_are_checked():
    """A gamma of the wrong length, a kernel whose input channels are not
    the previous layer's filters, or a drop rate missing raise ValueError
    before anything runs."""
    x, w0, bias0, gt0, bt0, layers, _ = _stack_inputs(
        2, 136, 9, [(8, 3)], (2, 2), seed=0)
    args = [_t(a) for a in (x, w0, bias0, gt0, bt0)]
    kernel, b, g, be = (_t(a) for a in layers[0])
    for ups, drops, match in (
            ([(kernel, b, g[:-1], be)], (0.0, 0.0), "gamma1"),
            ([(kernel[:, :5], b, g, be)], (0.0, 0.0), "kernel1"),
            ([(kernel, b, g, be)], (0.0,), "one drop rate per layer")):
        with pytest.raises(ValueError, match=match):
            conv_stack.conv_stack_fused(*args, ups, 0, (2, 2), EPS, True,
                                        drops)


def test_cpu_stack_counts_no_launch():
    """The stack's forward and backward on CPU tensors run the plain
    versions, reach every input and count no launch of any kernel."""
    counters = [(conv_stack, "launches"), (conv_stack, "bwd_launches"),
                (conv1d, "ln_launches"), (conv1d, "ln_bwd_launches")]
    before = [getattr(m, c) for m, c in counters]
    x, w0, bias0, gt0, bt0, layers, dz = _stack_inputs(
        3, 136, 9, [(8, 3)], (2, 2), seed=1)
    leaves = [_t(a).requires_grad_() for a in (x, w0, bias0, gt0, bt0)]
    ups = [[_t(a).requires_grad_() for a in u] for u in layers]
    out = conv_stack.conv_stack_fused(*leaves, ups, torch.tensor(5, dtype=torch.int32),
                                      (2, 2), EPS, True, (0.15, 0.15))
    (out * _t(dz)).sum().backward()
    assert all(t.grad is not None for t in (*leaves, *ups[0]))
    assert [getattr(m, c) for m, c in counters] == before


def test_stack_gives_a_waveform_no_gradient():
    """Through `ConvStack`, a waveform that needs no gradient gets none,
    and every other gradient is bitwise that of the call that computes dx;
    the CPU forward keeps no layer-0 pooled value (ypool0 None)."""
    x, w0, bias0, gt0, bt0, layers, dz = _stack_inputs(
        3, 136, 9, [(8, 3)], (2, 2), seed=4)
    grads = {}
    for need in (True, False):
        xx = _t(x).requires_grad_(need)
        leaves = [_t(a).requires_grad_() for a in (w0, bias0, gt0, bt0)]
        ups = [[_t(a).requires_grad_() for a in u] for u in layers]
        out = conv_stack.conv_stack_fused(xx, *leaves, ups, 5, (2, 2), EPS,
                                          True, (0.15, 0.15))
        (out * _t(dz)).sum().backward()
        grads[need] = (xx.grad, [t.grad for t in (*leaves, *ups[0])])
    assert grads[True][0] is not None and grads[False][0] is None
    for a, b in zip(grads[True][1], grads[False][1]):
        assert torch.equal(a, b)
    ups = [tuple(_t(a) for a in u) for u in layers]
    fwd = conv_stack.conv_stack_fwd(*(_t(a) for a in (x, w0, bias0, gt0, bt0)),
                                    ups, 5, (2, 2), EPS, True, (0.15, 0.15))
    assert len(fwd) == 5 and fwd[3] is None


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [0.0, 0.15])
def test_stack_kernels_match_plain_on_card(drop):
    """K7f and K7b (with K6 for layer 0) against the plain stack on the
    same card, at a small odd shape with 60-filter upper layers.  K7f:
    every layer's output, its (mean, std) and the pooled value it keeps
    within 5e-5 (four chained float32 layer norms), the same dropped
    elements, the argmax the same but at near-ties (at most 2 elements a
    layer).  K7b: two calls bitwise equal (no atomics); the gradients
    within 1e-4 of each tensor's max given the kernel's own residuals (a
    sum in another order can flip a near-tie argmax), and within 1e-2
    normwise of the plain backward run on the plain forward's residuals (a
    flip moves one pooled gradient to its neighbouring row); every dbias
    exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    from tpukaldi_torch.train.chunk_runtime import pin_float32

    pin_float32()
    pools, drops = (3, 3, 2), (drop,) * 3
    x, w0, bias0, gt0, bt0, layers, dz = _stack_inputs(
        13, 1100, 129, [(60, 5), (60, 3)], pools, seed=2)
    cu = lambda a: _t(a).cuda()  # noqa: E731
    args = [cu(a) for a in (x, w0, bias0, gt0, bt0)]
    ups = [tuple(cu(a) for a in u) for u in layers]
    out, idx0, stats0, ypool0, res = conv_stack.conv_stack_fwd(
        *args, ups, -5, pools, EPS, True, drops)
    ref = conv_stack.conv_stack_ref(*args, ups, -5, pools, EPS, True, drops)
    maps = [(r[0], rr[0]) for r, rr in zip(res, ref[3])] + [(out, ref[0])]
    for h, hr in maps:
        torch.testing.assert_close(h, hr, rtol=0, atol=5e-5)
        assert torch.equal(h == 0, hr == 0)
    kept = [(idx0, stats0), *((r[1], r[2]) for r in res)]
    plain = [(ref[1], ref[2]), *((r[1], r[2]) for r in ref[3])]
    for (idx, stats), (idx_r, stats_r) in zip(kept, plain):
        torch.testing.assert_close(stats, stats_r, rtol=0, atol=5e-5)
        assert (idx != idx_r).sum().item() <= 2
    for r, rr in zip(res, ref[3]):
        torch.testing.assert_close(r[3], rr[3], rtol=0, atol=5e-5)
    got = conv_stack.conv_stack_bwd(*args, ups, -5, idx0, stats0, ypool0, res,
                                    cu(dz), pools, EPS, True, drops)
    again = conv_stack.conv_stack_bwd(*args, ups, -5, idx0, stats0, ypool0,
                                      res, cu(dz), pools, EPS, True, drops)
    want = conv_stack.conv_stack_bwd_ref(*args, ups, -5, idx0, stats0, res,
                                         cu(dz), pools, EPS, True, drops)
    want_plain = conv_stack.conv_stack_bwd_ref(*args, ups, -5, *ref[1:],
                                               cu(dz), pools, EPS, True, drops)
    flat = lambda g: [*g[:5], *(t for u in g[5] for t in u)]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
    for a, b, p in zip(flat(got), flat(want), flat(want_plain)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * max(b.abs().max().item(), 1e-30))
        assert (a - p).norm().item() <= 1e-2 * max(p.norm().item(), 1e-30)
    assert all(torch.equal(u[1], torch.zeros_like(u[1])) for u in got[5])


# ------------------------------------------------- 5. the kept pooled value
# (N, L, K0, upper layers as (O, K), pools)
Y_CASES = {
    9: (5, 136, 9, [(8, 3), (8, 3)], (2, 2, 2)),
    129: (3, 256, 129, [(16, 5)], (2, 3)),
}


def _y_stack(K0, drop, seed):
    """The plain forward of a Y_CASES stack on the CPU: (inputs as torch
    tensors, the upper layers, dz, pools, drops, the forward's result)."""
    N, L, K0, ups, pools = Y_CASES[K0]
    x, w0, bias0, gt0, bt0, layers, dz = _stack_inputs(N, L, K0, ups, pools,
                                                       seed=seed)
    first = [_t(a) for a in (x, w0, bias0, gt0, bt0)]
    tl = [tuple(_t(a) for a in u) for u in layers]
    drops = (drop,) * len(pools)
    fwd = conv_stack.conv_stack_ref(*first, tl, SEED, pools, EPS, True, drops)
    return first, tl, _t(dz), pools, drops, fwd


@pytest.mark.parametrize("drop", [0.0, 0.15])
@pytest.mark.parametrize("K0", sorted(Y_CASES))
def test_plain_y_is_the_backward_recompute(K0, drop):
    """Each upper layer's y from the plain forward (max-pool of the conv
    plus bias) is bit for bit what the plain backward recomputes from the
    layer's input and argmax when no y is given."""
    first, tl, _, pools, _, fwd = _y_stack(K0, drop, seed=K0)
    for i, ((h, idx, _, y), (w, b, _, _)) in enumerate(zip(fwd[3], tl), 1):
        assert y.shape == idx.shape and y.dtype == torch.float32
        assert torch.equal(conv_stack.recompute_y(h, w, b, idx, pools[i]), y)


@pytest.mark.parametrize("drop", [0.0, 0.15])
@pytest.mark.parametrize("K0", sorted(Y_CASES))
def test_plain_bwd_given_y_equals_itself_without(K0, drop):
    """`conv_stack_bwd_ref` on the forward's y gives every gradient bit
    for bit as it does with each y None (recomputed)."""
    first, tl, dz, pools, drops, fwd = _y_stack(K0, drop, seed=K0 + 1)
    _, idx0, stats0, res = fwd
    bare = tuple((h, idx, stats, None) for h, idx, stats, _ in res)
    got = conv_stack.conv_stack_bwd_ref(*first, tl, SEED, idx0, stats0, res,
                                        dz, pools, EPS, True, drops)
    want = conv_stack.conv_stack_bwd_ref(*first, tl, SEED, idx0, stats0, bare,
                                         dz, pools, EPS, True, drops)
    flat = lambda g: [*g[:5], *(t for u in g[5] for t in u)]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))


def test_function_saves_four_residuals_per_upper_layer():
    """`ConvStack` saves the 9 tensors of its inputs and layer 0, the four
    tensors of each upper layer, and four residuals of each upper layer
    (input h, idx, stats, y), y equal to the plain forward's."""
    first, tl, dz, pools, drops, fwd = _y_stack(9, 0.15, seed=3)
    leaves = [t.clone().requires_grad_() for t in first]
    ups = [[t.clone().requires_grad_() for t in u] for u in tl]
    out = conv_stack.conv_stack_fused(*leaves, ups, SEED, pools, EPS, True,
                                      drops)
    saved = out.grad_fn.saved_tensors
    n_up = len(tl)
    assert len(saved) == 9 + 4 * n_up + 4 * n_up
    kept = saved[9 + 4 * n_up:]
    for i, (h, idx, stats, y) in enumerate(fwd[3]):
        got = kept[4 * i:4 * i + 4]
        assert torch.equal(got[0], h) and torch.equal(got[1], idx)
        assert torch.equal(got[2], stats) and torch.equal(got[3], y)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_bwd_refuses_a_wrong_y(bad):
    """A kept pooled value of the wrong shape or dtype raises ValueError
    before anything runs."""
    first, tl, dz, pools, drops, fwd = _y_stack(9, 0.0, seed=4)
    _, idx0, stats0, res = fwd
    h, idx, stats, y = res[0]
    y = y[:, :-1] if bad == "shape" else y.double()
    res = ((h, idx, stats, y), *res[1:])
    with pytest.raises(ValueError, match="pooled value y"):
        conv_stack.conv_stack_bwd(*first, tl, SEED, idx0, stats0, None, res,
                                  dz, pools, EPS, True, drops)
