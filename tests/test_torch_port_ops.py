"""makani_tpu_torch ops against makani_tpu on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function and
its counterpart in the port. The port's kernels are CUDA-only; on CPU tensors
their wrappers run the plain twins, which these tests pin (the kernels are
held against the twins on the card by tests/test_torch_port_cuda.py and
chip_smoke.py).

Tolerances, relative to the largest magnitude of the reference:
  - twin vs Pallas kernel (interpret mode): 1e-5. Both split the same float32
    operands into the same bf16 parts and every bf16 product is exact in
    float32; only the order of the float32 sums differs.
  - port (3 passes) vs JAX on the CPU: 5e-5, the 3-pass bound of
    tests/test_pallas_mm.py. JAX's CPU dots are exact float32 whatever the
    precision enum (makani_tpu/ops/sht.py:156-160), while the port keeps the
    bf16 splits, ~2^-16 relative per operand.
  - SpectralConv: 1e-4, two Legendre contractions and the channel mixing in
    series, each within the 3-pass bound.
  - gradients of legdot / dhconv against jax.vjp of pallas_mm's custom VJPs
    (interpret mode): 1e-5, the twin bound. Both run the multi-pass products
    on the cotangent; autograd through the twins' bf16 splits would round
    every gradient to bf16 (~1e-3).
  - dhconv_dw against the complex einsum in float64: 5e-5 (3 passes) and
    5e-2 (1 pass), the bounds of tests/test_pallas_mm.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from makani_tpu.ops import pallas_mm
from makani_tpu.ops import sht as jsht
from makani_tpu.ops import complex_ops as jcomplex
from makani_tpu.ops import dft as jdft, legendre as jlegendre, quadrature as jquadrature

from makani_tpu_torch.ops import kernels, spectral_mm, sht as tsht
from makani_tpu_torch.ops import dft as tdft, legendre as tlegendre, quadrature as tquadrature
from makani_tpu_torch.ops.complex_ops import contract_dhconv_stacked

TWIN_TOL = 1e-5
P3_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _engines():
    yield
    jsht.set_coeff_engine("xla")
    tsht.set_coeff_engine("kernel")
    tsht.set_transform_precision("high")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# --------------------------------------------------------------------------
# plain twins vs the Pallas kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("contract", ["k", "l"])
def test_legmm_plain_matches_pallas(passes, contract):
    rng = np.random.RandomState(3)
    mmax, C, K, L = 5, 12, 25, 9
    z = rng.randn(2 * mmax, C, K if contract == "k" else L).astype(np.float32)
    p = rng.randn(mmax, L, K).astype(np.float32)
    want = pallas_mm.legmm(jnp.asarray(z), jnp.asarray(p), passes=passes, contract=contract,
                           interpret=True)
    got = spectral_mm.legmm_plain(torch.from_numpy(z), torch.from_numpy(p), passes, contract)
    assert got.shape == want.shape
    assert _rel(got, want) < TWIN_TOL


@pytest.mark.parametrize("passes,m3,wdim,conj_w", [
    (1, True, 0, False), (2, True, 0, False), (3, True, 0, False),
    (1, False, 0, False), (3, False, 0, False),
    (1, True, 1, True), (3, True, 1, True), (3, False, 1, True),
])
def test_dhconv_mm_plain_matches_pallas(passes, m3, wdim, conj_w):
    rng = np.random.RandomState(4)
    B, L, C, O, M = 2, 3, 6, 5, 130
    x = rng.randn(2, B, L, C if wdim == 0 else O, M).astype(np.float32)
    w = rng.randn(2, L, C, O).astype(np.float32)
    want = pallas_mm.dhconv_mm(jnp.asarray(x), jnp.asarray(w), passes=passes, m3=m3,
                               wdim=wdim, conj_w=conj_w, interpret=True)
    got = spectral_mm.dhconv_mm_plain(torch.from_numpy(x), torch.from_numpy(w), passes, m3,
                                      wdim, conj_w)
    assert got.shape == want.shape
    assert _rel(got, want) < TWIN_TOL


def test_wrappers_take_the_twin_on_cpu_without_counting():
    rng = np.random.RandomState(5)
    z = torch.from_numpy(rng.randn(6, 4, 7).astype(np.float32))
    p = torch.from_numpy(rng.randn(3, 5, 7).astype(np.float32))
    x = torch.from_numpy(rng.randn(2, 1, 5, 4, 9).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 5, 4, 3).astype(np.float32))
    before = dict(kernels.launches)
    assert torch.equal(spectral_mm.legmm(z, p), spectral_mm.legmm_plain(z, p))
    assert torch.equal(spectral_mm.dhconv_mm(x, w), spectral_mm.dhconv_mm_plain(x, w))
    assert kernels.launches == before
    with pytest.raises(ValueError):
        spectral_mm.legmm(z[:4], p)  # 2*mmax rows required
    with pytest.raises(ValueError):
        spectral_mm.dhconv_mm(x, w, wdim=1)  # Ci must equal O for wdim=1


# --------------------------------------------------------------------------
# gradients: legdot / dhconv against pallas_mm's custom VJPs, dhconv_dw
# --------------------------------------------------------------------------

@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("contract", ["k", "l"])
def test_legdot_vjp_matches_pallas(contract, passes, plain):
    rng = np.random.RandomState(11)
    mmax, C, K, L = 5, 7, 23, 9
    z = rng.randn(2 * mmax, C, K if contract == "k" else L).astype(np.float32)
    p = rng.randn(mmax, L, K).astype(np.float32)
    g = rng.randn(2 * mmax, C, L if contract == "k" else K).astype(np.float32)
    want, vjp = jax.vjp(lambda a: pallas_mm.legdot(a, jnp.asarray(p), contract, passes, True),
                        jnp.asarray(z))
    (want_dz,) = vjp(jnp.asarray(g))

    zt = torch.from_numpy(z).requires_grad_()
    pt = torch.from_numpy(p)
    got = spectral_mm.legdot(zt, pt, contract, passes, plain=plain)
    got.backward(torch.from_numpy(g))
    assert _rel(got.detach(), want) < TWIN_TOL
    assert _rel(zt.grad, want_dz) < TWIN_TOL
    assert pt.grad is None


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("passes", [1, 3])
def test_dhconv_vjp_matches_pallas(passes, plain):
    rng = np.random.RandomState(12)
    B, L, C, O, M = 2, 3, 6, 5, 11
    x = rng.randn(2, B, L, C, M).astype(np.float32)
    w = rng.randn(2, L, C, O).astype(np.float32)
    g = rng.randn(2, B, L, O, M).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: pallas_mm.dhconv(a, b, passes, True),
                        jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = spectral_mm.dhconv(xt, wt, passes, plain=plain)
    # a permuted, non-contiguous cotangent, as SpectralConv's views give it
    gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 1, 2, 4, 3))).transpose(-1, -2)
    got.backward(gt)
    assert _rel(got.detach(), want) < TWIN_TOL
    assert _rel(xt.grad, want_dx) < TWIN_TOL
    assert _rel(wt.grad, want_dw) < TWIN_TOL


def test_dhconv_skips_gradients_nobody_asks_for():
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(2, 1, 3, 4, 5).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 3, 4, 2).astype(np.float32)).requires_grad_()
    spectral_mm.dhconv(x, w).sum().backward()
    assert x.grad is None and w.grad is not None


@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("m3", [True, False])
@pytest.mark.parametrize("B", [1, 3])
def test_dhconv_dw_plain_matches_pallas(passes, m3, B):
    rng = np.random.RandomState(14)
    L, C, O, M = 3, 6, 5, 130
    x = rng.randn(2, B, L, C, M).astype(np.float32)
    g = rng.randn(2, B, L, O, M).astype(np.float32)
    want = pallas_mm.dhconv_dw(jnp.asarray(x), jnp.asarray(g), passes=passes, m3=m3,
                               interpret=True)
    got = spectral_mm.dhconv_dw(torch.from_numpy(x), torch.from_numpy(g), passes, m3)
    assert got.shape == want.shape == (2, L, C, O)
    assert _rel(got, want) < TWIN_TOL
    # against the complex product in float64
    xc, gc = x[0] + 1j * x[1], g[0] + 1j * g[1]
    ref = np.einsum("blcm,blom->lco", np.conj(xc).astype(np.complex128), gc)
    err = max(_rel(got[0], ref.real), _rel(got[1], ref.imag))
    assert err < {1: 5e-2, 2: 5e-2, 3: 5e-5}[passes]


def test_dhconv_dw_accumulates_over_batch():
    """B=3 equals the sum of three B=1 calls (tests/test_pallas_mm.py:81-93)."""
    rng = np.random.RandomState(15)
    x = torch.from_numpy(rng.randn(2, 3, 4, 6, 33).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 3, 4, 5, 33).astype(np.float32))
    full = spectral_mm.dhconv_dw(x, g)
    parts = sum(spectral_mm.dhconv_dw(x[:, b:b + 1], g[:, b:b + 1]) for b in range(3))
    assert _rel(full, parts) < TWIN_TOL


def test_raw_wrappers_refuse_gradients():
    rng = np.random.RandomState(16)
    z = torch.from_numpy(rng.randn(6, 4, 7).astype(np.float32)).requires_grad_()
    p = torch.from_numpy(rng.randn(3, 5, 7).astype(np.float32))
    x = torch.from_numpy(rng.randn(2, 1, 5, 4, 9).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.randn(2, 5, 4, 3).astype(np.float32))
    for fn, args, name in [(spectral_mm.legmm, (z, p), "legdot"),
                           (spectral_mm.legmm_plain, (z, p), "legdot"),
                           (spectral_mm.dhconv_mm, (x, w), "dhconv"),
                           (spectral_mm.dhconv_mm_plain, (x, w), "dhconv"),
                           (spectral_mm.dhconv_dw, (x, x), "dhconv")]:
        with pytest.raises(RuntimeError, match=name):
            fn(*args)
    with torch.no_grad():
        spectral_mm.legmm(z, p)
        spectral_mm.dhconv_mm(x, w)


# --------------------------------------------------------------------------
# host tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grid", ["legendre-gauss", "equiangular", "lobatto"])
def test_tables_equal_jax(grid):
    for a, b in zip(tquadrature.quadrature_nodes_weights(grid, 17),
                    jquadrature.quadrature_nodes_weights(grid, 17)):
        np.testing.assert_array_equal(a, b)
    t = np.linspace(0.1, 3.0, 11)
    np.testing.assert_array_equal(tlegendre.precompute_legpoly(6, 8, t),
                                  jlegendre.precompute_legpoly(6, 8, t))
    for a, b in zip(tdft.rdft_matrices(20, 7) + tdft.irdft_matrices(20, 11),
                    jdft.rdft_matrices(20, 7) + jdft.irdft_matrices(20, 11)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsht._get_pct(grid, 17, 8, 9),
                                  np.asarray(jsht._get_pct(grid, 17, 8, 9, True)))


# --------------------------------------------------------------------------
# stacked SHT (test_stacked_engine.py:35-66 pattern)
# --------------------------------------------------------------------------

SHT_CASES = [("legendre-gauss", 24, 48), ("equiangular", 25, 48)]


def _stacked_to_complex(z):
    mmax = z.shape[0] // 2
    return np.moveaxis(z[:mmax] + 1j * z[mmax:], 0, -1)


@pytest.mark.parametrize("engine", ["kernel", "stacked"])
@pytest.mark.parametrize("grid,nlat,nlon", SHT_CASES)
def test_analysis_matches_jax(grid, nlat, nlon, engine):
    lmax, mmax = nlat // 2, nlon // 4 + 1
    x = np.random.RandomState(0).randn(2, 3, nlat, nlon).astype(np.float32)
    want = np.asarray(jsht.RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)(jnp.asarray(x)))

    tsht.set_coeff_engine(engine)
    sht = tsht.RealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    stacked = sht.analysis_stacked(torch.from_numpy(x)).numpy()
    assert stacked.shape == (2 * mmax, 2, 3, lmax)
    got = _stacked_to_complex(stacked)
    assert _rel(got.real, want.real) < P3_TOL and _rel(got.imag, want.imag) < P3_TOL
    np.testing.assert_array_equal(sht(torch.from_numpy(x)).numpy(), got.astype(np.complex64))


@pytest.mark.parametrize("grid,nlat,nlon", SHT_CASES)
def test_synthesis_matches_jax(grid, nlat, nlon):
    lmax, mmax = nlat // 2, nlon // 4 + 1
    rng = np.random.RandomState(1)
    c = (rng.randn(2, 3, lmax, mmax) + 1j * rng.randn(2, 3, lmax, mmax)).astype(np.complex64)
    want = np.asarray(jsht.InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)(
        jnp.asarray(c)))

    isht = tsht.InverseRealSHT(nlat, nlon, lmax=lmax, mmax=mmax, grid=grid)
    zs = np.concatenate([np.moveaxis(c.real, -1, 0), np.moveaxis(c.imag, -1, 0)], axis=0)
    got = isht.synthesis_stacked(torch.from_numpy(np.ascontiguousarray(zs))).numpy()
    assert got.shape == (2, 3, nlat, nlon)
    assert _rel(got, want) < P3_TOL
    np.testing.assert_array_equal(isht(torch.from_numpy(c)).numpy(), got)


def test_transform_precision_sets_passes():
    assert tsht._coeff_passes() == 3 and tsht._stacked_engine_active()
    tsht.set_transform_precision("default")
    assert tsht._coeff_passes() == 1
    # "highest" has no kernel pass count: the complex path runs on any engine
    tsht.set_transform_precision("highest")
    assert tsht._coeff_passes() is None and not tsht._stacked_engine_active()
    with pytest.raises(ValueError):
        tsht.set_transform_precision("bf16")
    tsht.set_transform_precision("high")
    tsht.set_coeff_engine("xla")
    assert tsht.get_coeff_engine() == "xla" and not tsht._stacked_engine_active()
    with pytest.raises(ValueError):
        tsht.set_coeff_engine("pallas")


# --------------------------------------------------------------------------
# dhconv contraction and SpectralConv
# --------------------------------------------------------------------------

def test_contract_dhconv_stacked_matches_jax():
    rng = np.random.RandomState(6)
    B, L, C, O, M = 2, 7, 6, 5, 9
    x = rng.randn(2, B, L, C, M).astype(np.float32)
    w = rng.randn(2, L, C, O).astype(np.float32)
    jsht.set_coeff_engine("stacked")
    want = np.asarray(jcomplex.contract_dhconv_stacked(jnp.asarray(x), jnp.asarray(w)))
    got = contract_dhconv_stacked(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert _rel(got, want) < P3_TOL


@pytest.mark.parametrize("scale_residual,bias", [
    (False, "constant"), (True, "constant"), (True, "position"),
])
def test_spectral_conv_matches_jax(scale_residual, bias):
    """Every dimension differs (B=2, C=6, O=5, L=10, mmax=13), so a wrong
    permute at the (2*mmax,B,C,L) <-> (2,B,L,C,mmax) seams cannot hide."""
    from makani_tpu.models.common.spectral_convolution import SpectralConv as JConv
    from makani_tpu_torch.models.common.spectral_convolution import SpectralConv as TConv

    nlat, nlon, lmax, mmax = 20, 48, 10, 13
    onlat, onlon = (12, 26) if scale_residual else (nlat, nlon)
    B, C, O = 2, 6, 5
    rng = np.random.RandomState(7)
    x = rng.randn(B, C, nlat, nlon).astype(np.float32)
    w = rng.randn(C, O, lmax, 2).astype(np.float32)
    name = "bias_const" if bias == "constant" else "bias_pos"
    b = rng.randn(1, O, *((1, 1) if bias == "constant" else (onlat, onlon))).astype(np.float32)

    jconv = JConv(jsht.RealSHT(nlat, nlon, lmax, mmax, grid="legendre-gauss"),
                  jsht.InverseRealSHT(onlat, onlon, lmax, mmax, grid="legendre-gauss"),
                  in_channels=C, out_channels=O, operator_type="dhconv", bias=bias)
    jout, jres = jconv.apply({"params": {"weight": jnp.asarray(w), name: jnp.asarray(b)}},
                             jnp.asarray(x))

    tconv = TConv(tsht.RealSHT(nlat, nlon, lmax, mmax, grid="legendre-gauss"),
                  tsht.InverseRealSHT(onlat, onlon, lmax, mmax, grid="legendre-gauss"),
                  C, O, operator_type="dhconv", bias=bias)
    assert tconv.scale_residual == scale_residual
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        getattr(tconv, name).copy_(torch.from_numpy(b))
        tout, tres = tconv(torch.from_numpy(x))
    assert tout.shape == (B, O, onlat, onlon) and tres.shape == (B, C, onlat, onlon)
    assert _rel(tout.numpy(), jout) < 1e-4
    assert _rel(tres.numpy(), jres) < 1e-4
