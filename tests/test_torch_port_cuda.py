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
bounded here at 1e-5 relative to the output's largest magnitude. The same
bound holds the differentiable wrappers' gradients on the card against the
twins on the CPU. The fused Adam kernel and its twin perform the same
correctly rounded operations in the same order: bit-identical.
"""

import numpy as np
import pytest
import torch

from makani_tpu_torch.ops import complex_kernels, fused_adam, kernels, spectral_mm
from makani_tpu_torch.utils.optimizers import AdamState

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
    before = kernels.launches["legmm"]
    got = spectral_mm.legmm(z, p, passes=passes, contract=contract)
    torch.cuda.synchronize()
    assert kernels.launches["legmm"] == before + 1
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
    before = kernels.launches["dhconv_mm"]
    got = spectral_mm.dhconv_mm(x, w, passes=passes, m3=m3, wdim=wdim, conj_w=conj_w)
    torch.cuda.synchronize()
    assert kernels.launches["dhconv_mm"] == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("m3", [True, False])
@pytest.mark.parametrize("B,L,C,O,M", [(2, 3, 70, 45, 130), (1, 2, 33, 64, 241)])
def test_dhconv_dw_kernel_matches_plain(cuda, passes, m3, B, L, C, O, M):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((2, B, L, C, M), device=cuda, generator=g)
    cot = torch.randn((2, B, L, O, M), device=cuda, generator=g)
    before = kernels.launches["dhconv_dw"]
    got = spectral_mm.dhconv_dw(x, cot, passes=passes, m3=m3)
    torch.cuda.synchronize()
    assert kernels.launches["dhconv_dw"] == before + 1
    want = spectral_mm.dhconv_dw_plain(x, cot, passes=passes, m3=m3)
    assert _rel(got, want) < TOL


def _adam_leaves(gen, device):
    """Odd leaf sizes, a scalar-like leaf and a dhconv weight in the port's
    (2, L, C, O) layout, whose dither index follows makani_tpu's layout."""
    shapes = {"a": (7,), "b.w": (3, 65), "b.v": (2, 3, 129), "c": (1,),
              "model.blocks.0.filter_layer.filter.weight": (2, 5, 6, 7)}
    return {k: torch.randn(s, device=device, generator=gen) for k, s in shapes.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("moments,stochastic,wd", [
    (torch.bfloat16, True, 0.0), (torch.bfloat16, False, 0.01), (torch.float32, False, 0.0)])
def test_fused_adam_kernel_bitwise_against_plain(cuda, moments, stochastic, wd):
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = _adam_leaves(gen, cuda)
    twin = {k: v.clone() for k, v in params.items()}

    def state():
        return AdamState(0, {k: torch.zeros_like(v, dtype=moments) for k, v in params.items()},
                         {k: torch.zeros_like(v, dtype=moments) for k, v in params.items()})

    s_kernel, s_twin = state(), state()
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd, stochastic_rounding=stochastic,
              seed=340)
    for step in range(2):
        grads = {k: 0.1 * torch.randn(v.shape, device=cuda, generator=gen)
                 for k, v in params.items()}
        before = kernels.launches["fused_adam"]
        fused_adam.fused_adam_apply(params, grads, s_kernel, 1e-3, **kw)
        torch.cuda.synchronize()
        assert kernels.launches["fused_adam"] == before + len(params)
        fused_adam.fused_adam_apply_plain(twin, grads, s_twin, 1e-3, **kw)
    for k in params:
        assert torch.equal(params[k], twin[k]), k
        assert torch.equal(s_kernel.mu[k], s_twin.mu[k]), k
        assert torch.equal(s_kernel.nu[k], s_twin.nu[k]), k
    assert s_kernel.count == s_twin.count == 2


@pytest.mark.cuda
@pytest.mark.parametrize("contract", ["k", "l"])
def test_legdot_backward_on_card_matches_cpu(cuda, contract):
    rng = np.random.RandomState(4)
    mmax, C, K, L = 5, 70, 97, 33
    z = rng.randn(2 * mmax, C, K if contract == "k" else L).astype(np.float32)
    p = torch.from_numpy(rng.randn(mmax, L, K).astype(np.float32))
    cot = torch.from_numpy(rng.randn(2 * mmax, C, L if contract == "k" else K).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        zt = torch.from_numpy(z).to(dev).requires_grad_()
        spectral_mm.legdot(zt, p.to(dev), contract, 3).backward(cot.to(dev))
        grads.append(zt.grad.cpu())
    assert _rel(grads[1], grads[0]) < TOL


@pytest.mark.cuda
def test_dhconv_backward_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(5)
    B, L, C, O, M = 2, 3, 70, 45, 130
    x = rng.randn(2, B, L, C, M).astype(np.float32)
    w = rng.randn(2, L, C, O).astype(np.float32)
    cot = torch.from_numpy(rng.randn(2, B, L, O, M).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        wt = torch.from_numpy(w).to(dev).requires_grad_()
        spectral_mm.dhconv(xt, wt, 3).backward(cot.to(dev))
        grads.append((xt.grad.cpu(), wt.grad.cpu()))
    assert _rel(grads[1][0], grads[0][0]) < TOL
    assert _rel(grads[1][1], grads[0][1]) < TOL


@pytest.mark.cuda
def test_raw_wrappers_refuse_gradients_on_card(cuda):
    z = torch.randn((4, 8, 6), device=cuda, requires_grad=True)
    p = torch.randn((2, 5, 6), device=cuda)
    x = torch.randn((2, 1, 5, 4, 9), device=cuda, requires_grad=True)
    w = torch.randn((2, 5, 4, 3), device=cuda)
    with pytest.raises(RuntimeError, match="legdot"):
        spectral_mm.legmm(z, p)
    with pytest.raises(RuntimeError, match="dhconv"):
        spectral_mm.dhconv_mm(x, w)


def _cplx(gen, shape, device):
    return torch.complex(torch.randn(shape, device=device, generator=gen),
                         torch.randn(shape, device=device, generator=gen))


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("B,C,O,L,M", [(2, 70, 45, 3, 130), (3, 33, 64, 2, 241)])
def test_dhconv_complex_kernel_matches_plain(cuda, passes, B, C, O, L, M):
    g = torch.Generator(device=cuda).manual_seed(6)
    x = _cplx(g, (B, C, L, M), cuda)
    w = _cplx(g, (C, O, L), cuda)
    before = kernels.launches["dhconv_complex"]
    got = complex_kernels.contract_dhconv_raw(x, w, passes)
    torch.cuda.synchronize()
    assert kernels.launches["dhconv_complex"] == before + 1
    assert got.dtype == torch.complex64 and got.shape == (B, O, L, M)
    want = complex_kernels.contract_dhconv_plain(x, w, passes)
    assert _rel(got, want) < TOL


@pytest.mark.cuda
def test_dhconv_complex_reads_conj_bit_and_strided_inputs(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    x = _cplx(g, (2, 70, 3, 130), cuda)
    w = _cplx(g, (45, 70, 3), cuda)
    wt = w.conj().transpose(0, 1)               # lazily conjugated, strided (70, 45, 3)
    xs = x.transpose(2, 3).contiguous().transpose(2, 3)   # strided view of x's values
    assert wt.is_conj() and not wt.is_contiguous() and not xs.is_contiguous()
    got = complex_kernels.contract_dhconv_raw(xs, wt, 3)
    want = complex_kernels.contract_dhconv_plain(
        x, w.conj().resolve_conj().transpose(0, 1).contiguous(), 3)
    assert _rel(got, want) < TOL


@pytest.mark.cuda
def test_dhconv_complex_backward_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(8)
    B, C, O, L, M = 2, 70, 45, 3, 130

    def cplx(*shape):
        return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)

    x, w, cot = cplx(B, C, L, M), cplx(C, O, L), torch.from_numpy(cplx(B, O, L, M))
    grads = []
    for dev in ("cpu", cuda):
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        wt = torch.from_numpy(w).to(dev).requires_grad_()
        before = kernels.launches["dhconv_complex"]
        complex_kernels.contract_dhconv_kernel(xt, wt, 3).backward(cot.to(dev))
        # on the card the forward and dx launch the kernel; dw is an einsum
        assert kernels.launches["dhconv_complex"] == before + (2 if dev == cuda else 0)
        grads.append((xt.grad.cpu(), wt.grad.cpu()))
    assert _rel(grads[1][0], grads[0][0]) < TOL
    assert _rel(grads[1][1], grads[0][1]) < TOL


@pytest.mark.cuda
def test_dhconv_complex_raw_wrapper_refuses_gradients_on_card(cuda):
    x = torch.randn((1, 4, 3, 9), device=cuda, dtype=torch.complex64, requires_grad=True)
    w = torch.randn((4, 5, 3), device=cuda, dtype=torch.complex64)
    with pytest.raises(RuntimeError, match="contract_dhconv_kernel"):
        complex_kernels.contract_dhconv_raw(x, w)
    with torch.no_grad():
        complex_kernels.contract_dhconv_raw(x, w)
