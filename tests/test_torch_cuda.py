"""The port's CUDA kernel on the card (marker `cuda`).

These tests need an NVIDIA GPU and the CUDA toolkit; without a card each
skips with the reason.  This file imports neither jax nor the JAX package,
so it runs on a machine that has PyTorch for CUDA and no jax:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax.)  It holds the
fused-GEMM kernel against its plain version, checks the row-independence
that bucketed serving relies on, and runs a small network on the `cuda`
engine against `eager` on the same card.
"""
import pytest
import torch

from repro_torch.configs.darknet_ref import DARKNET_SMALL_CFG, SEGNET_SMALL_CFG
from repro_torch.core import make_engine
from repro_torch.core.darknet.network import Network
from repro_torch.kernels import gemm, ops
from repro_torch.kernels.common import ACTIVATIONS

pytestmark = pytest.mark.cuda

MATMUL_CASES = [(2, 64, 10), (32, 128, 256), (32, 256, 128), (33, 177, 99),
                (1, 27, 1000), (300, 1, 7)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode; "
                    "the CPU path is tested in test_torch_kernels_gemm.py")
    return torch.device("cuda", 0)


def _relmax(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
def test_kernel_matches_plain_version(card, m, k, n, dtype, tol):
    g = torch.Generator(device=card).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=card).to(dtype)
    w = (torch.randn(k, n, generator=g, device=card) / k ** 0.5).to(dtype)
    scale = torch.rand(n, generator=g, device=card) + 0.5
    shift = torch.randn(n, generator=g, device=card) * 0.1
    for act in ACTIVATIONS:
        for sc, sh in ((None, None), (scale, shift)):
            want = gemm.gemm_fused_plain(x, w, sc, sh, act=act)
            for tile in gemm.TILES:
                before = gemm.launches
                got = gemm.gemm_fused_fwd(x, w, sc, sh, act=act, tile=tile)
                assert gemm.launches == before + 1
                assert got.dtype == dtype and tuple(got.shape) == (m, n)
                assert _relmax(got, want) <= tol, (act, tile)


def test_rows_do_not_depend_on_m_or_tile(card):
    """A row's result is bitwise the same alone, inside a larger M, and
    under either tile: no split-K, one fixed summation order."""
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(70, 300, generator=g, device=card)
    w = torch.randn(300, 90, generator=g, device=card)
    shift = torch.randn(90, generator=g, device=card)
    full = {t: gemm.gemm_fused_fwd(x, w, None, shift, act="leaky", tile=t)
            for t in gemm.TILES}
    assert torch.equal(full[64], full[32])
    for rows in (slice(0, 1), slice(5, 8), slice(64, 70)):
        part = gemm.gemm_fused_fwd(x[rows].contiguous(), w, None, shift,
                                   act="leaky")
        assert torch.equal(part, full[64][rows])


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = torch.zeros(4, 8, device=card)
    w = torch.zeros(8, 3, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        gemm.gemm_fused_fwd(torch.zeros(8, 4, device=card).t(), w)
    with pytest.raises(ValueError, match="tile"):
        gemm.gemm_fused_fwd(x, w, tile=16)
    with pytest.raises(ValueError, match="on cpu"):
        gemm.gemm_fused_fwd(x, w.cpu())
    assert tuple(ops.matmul(x, w).shape) == (4, 3)


@pytest.mark.parametrize("cfg", [DARKNET_SMALL_CFG, SEGNET_SMALL_CFG])
def test_network_on_cuda_engine_matches_eager(card, cfg):
    net = Network(cfg, make_engine("cuda"),
                  generator=torch.Generator().manual_seed(0))
    ref = Network(cfg, make_engine("eager", device=card))
    ref.load_state_dict(net.state_dict())
    x = torch.randn((3, *net.in_shape), generator=torch.Generator()
                    .manual_seed(1)).to(card)
    with torch.inference_mode():
        got, want = net(x), ref(x)
    assert _relmax(got, want) <= 1e-4
