"""makani_tpu_torch's Hopper kernels against their plain twins, on the card.

Every test here needs an NVIDIA GPU and nvcc: it is marked `cuda` and skips
without a card. The file imports neither JAX nor makani_tpu, so it runs on a
machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Shapes are small and ragged in every dimension (no multiple of a tile), so the
kernels' zero-filled loads and masked stores are exercised at every edge.
Tolerance: kernel and twin split the same operands into the same bf16 parts,
and every bf16 product is exact in float32; they differ only in the order of
the float32 sums, so the gap is a few ulps of the largest partial sum —
bounded here at 1e-5 relative to the output's largest magnitude.
"""

import pytest
import torch

from makani_tpu_torch.ops import spectral_mm

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("contract", ["k", "l"])
@pytest.mark.parametrize("C,K,L", [(70, 25, 19), (130, 97, 33)])
def test_legmm_kernel_matches_plain(cuda, passes, contract, C, K, L):
    g = torch.Generator(device=cuda).manual_seed(0)
    mmax = 5
    z = torch.randn((2 * mmax, C, K if contract == "k" else L), device=cuda, generator=g)
    p = torch.randn((mmax, L, K), device=cuda, generator=g)
    before = spectral_mm.launches["legmm"]
    got = spectral_mm.legmm(z, p, passes=passes, contract=contract)
    torch.cuda.synchronize()
    assert spectral_mm.launches["legmm"] == before + 1
    want = spectral_mm.legmm_plain(z, p, passes=passes, contract=contract)
    assert _rel(got, want) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("m3", [True, False])
@pytest.mark.parametrize("wdim,conj_w", [(0, False), (1, True), (1, False)])
def test_dhconv_mm_kernel_matches_plain(cuda, passes, m3, wdim, conj_w):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, L, C, O, M = 2, 3, 70, 45, 130
    x = torch.randn((2, B, L, C if wdim == 0 else O, M), device=cuda, generator=g)
    w = torch.randn((2, L, C, O), device=cuda, generator=g)
    before = spectral_mm.launches["dhconv_mm"]
    got = spectral_mm.dhconv_mm(x, w, passes=passes, m3=m3, wdim=wdim, conj_w=conj_w)
    torch.cuda.synchronize()
    assert spectral_mm.launches["dhconv_mm"] == before + 1
    want = spectral_mm.dhconv_mm_plain(x, w, passes=passes, m3=m3, wdim=wdim, conj_w=conj_w)
    assert _rel(got, want) < TOL


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    z = torch.randn((4, 8, 6), device=cuda)
    p = torch.randn((2, 5, 6), device=cuda)
    with pytest.raises(ValueError):
        spectral_mm.legmm(z.transpose(1, 2).contiguous().transpose(1, 2), p)
    with pytest.raises(TypeError):
        spectral_mm.legmm(z.double(), p.double())
