"""The port's Li-GRU recurrence (tpukaldi_torch/kernels/ligru.py) against
tpukaldi's: the Pallas kernel in interpret mode and the lax.scan version.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is compared with that plain version on a card.  Inputs come
from numpy with a seed.  Tolerance: 1e-5 absolute — all three are float32
with the same operation order per step except the h @ U sum, whose
reordering moves the last bits only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukaldi.kernels.ligru import ligru_recurrence as jax_ligru
from tpukaldi.kernels.ligru import ligru_recurrence_scan
from tpukaldi_torch.kernels import ligru as port

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


@pytest.mark.cuda
def test_ligru_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the same card.  1e-4:
    the kernel sums h @ U serially, cuBLAS in tiles, and the difference
    compounds over the recurrence's steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    ff, u, mask = _inputs(41, 6, 64, seed=2)
    args = [torch.from_numpy(a).cuda() for a in (ff, u, mask)]
    before = port.launches
    with torch.inference_mode():
        got = port.ligru_recurrence(*args)
        want = port.ligru_recurrence_ref(*args)
    torch.cuda.synchronize()
    assert port.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
