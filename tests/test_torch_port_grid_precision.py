"""The SHT's grid stage (the longitude DFT and its inverse) at makani_tpu's
precision modes, against makani_tpu on the CPU.

makani_tpu runs the grid stage at the mode's bf16 passes on an accelerator
and as a float32 einsum on the CPU (makani_tpu/ops/sht.py:137-182,
transform_einsum(..., stage="grid")). The port does the same: on a CUDA
tensor its "kernel" and "xla" engines run the gridmm kernel through
spectral_mm.griddot, its "stacked" engine runs the kernel's plain twin on
every device, and on a CPU tensor the "kernel" and "xla" engines keep the
float32 matmul. The kernel itself is held against its twin on the card
(tests/test_torch_port_cuda.py, chip_smoke.py phase 20).

The same inputs, made with numpy from a seed, go through:
  - (a) the port's grid stage on the "stacked" engine, for each of the seven
    mode names, in both orientations (analysis: rows (R, nlon) against the
    (nlon, 2*mmax) table; synthesis: m-leading (2*mmax, R) against the
    (2*mmax, nlon) table), against makani_tpu's pallas_mm.gridmm in interpret
    mode at the x cast and pass count transform_einsum takes for the mode;
    "highest" against float64;
  - (b) its backward, against pallas_mm.gridmm at the transposed table (the
    same passes and the bf16 rounding of the cotangent), against jax.vjp of
    transform_einsum's accelerator expressions (copied below from
    makani_tpu/ops/sht.py:161-182), and against float64;
  - (c) the "kernel" and "xla" engines' SHT pair on the CPU, every mode: the
    float32 matmul's bits, as before the grid stage took the modes, and no
    launch;
  - (d) the "stacked" engine's SHT pair at each mode against float64.
The spatial-rank case is in tests/test_torch_port_parallel.py (one spawn
with its other SHT cases).

Tolerances, relative to the reference's largest magnitude:
  - twin against the interpret-mode Pallas kernel: 1e-6 (TWIN_TOL): the same
    bf16 parts, exact bf16 products, only the order of the float32 sums
    differs; a bf16 output one bf16 ulp of each element more;
  - against jax.vjp's expressions: where they dot at DEFAULT the cotangent
    is rounded to bf16 first, as an accelerator's DEFAULT dot rounds its
    operands (the CPU's dot does not). makani_tpu's "split2" rounds each of
    its two passes' cotangents to bf16 and adds them in bf16 (add_any), the
    port rounds their float32 sum once: two bf16 ulps of each element
    (VJP_ULPS). Where they dot at HIGH the CPU computes exactly: the 3-pass
    bound (5e-5) and one bf16 ulp for a bf16 cotangent;
  - against float64: 5e-5 at 3 passes on a float32 operand, 5e-2 where an
    operand is rounded to bf16 (1 pass, or a bf16 x) (tests/test_pallas_mm.py),
    plus half a bf16 ulp of each element (2**-8 of its magnitude) where the
    result is rounded to bf16; "highest" 1e-6. The rounding modes must also
    land above 1e-4, so a mode that is not applied cannot pass.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from makani_tpu.ops import pallas_mm

from makani_tpu_torch.ops import kernels, sht, spectral_mm

MODES = ("default", "split2", "tf32", "mixed", "mixed2", "high", "highest")
# makani_tpu's grid stage on an accelerator (transform_einsum, stage="grid"):
# the x cast and the pallas_mm.gridmm passes of its forward, and the passes
# of its backward and whether the cotangent comes back rounded to bf16
JAX_GRID = {"default": ("bf16", 1, 1, True), "tf32": ("bf16", 1, 1, True),
            "mixed": ("bf16", 1, 1, True), "split2": ("bf16", 2, 2, True),
            "mixed2": ("bf16", 3, 3, True), "high": ("f32", 3, 3, False)}
TWIN_TOL = 1e-6
P3_TOL = 5e-5
P1_TOL = 5e-2
HIGHEST_TOL = 1e-6
VJP_ULPS = 2
ROUNDS = 1e-4
NLAT, NLON, LMAX, MMAX = 12, 40, 10, 13   # K 40, N 26
R = 37


@pytest.fixture(autouse=True)
def _restore():
    prev = (sht.get_coeff_engine(), sht.get_transform_precision())
    yield
    sht.set_coeff_engine(prev[0])
    sht.set_transform_precision(prev[1])


def _bf16_ulp(v):
    return np.ldexp(1.0, np.frexp(np.asarray(v, np.float64))[1] - 8)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _assert_close(got, want, tol, ulps=0):
    """|got - want| within tol of want's largest magnitude plus `ulps` bf16
    ulps of each element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    slack = tol * np.abs(want).max() + ulps * _bf16_ulp(want)
    assert np.all(np.abs(got - want) <= slack), (np.abs(got - want) - slack).max()


def _f64_bound(mode, rounded):
    """The pass bound of a mode's forward against float64 (module docstring)."""
    if mode == "highest":
        return HIGHEST_TOL
    return P3_TOL if mode == "high" and not rounded else P1_TOL


def _tables(orientation):
    """(forward table t (K, N), its transpose t_t, the sht tables (dft, dft_t))."""
    cpu = torch.device("cpu")
    if orientation == "analysis":
        dft = sht._rdft_tensor(NLON, MMAX, cpu)
        dft_t = sht._transposed(sht._rdft_tensor, NLON, MMAX, cpu)
        return dft_t, dft, dft, dft_t
    dft = sht._irdft_tensor(NLON, MMAX, cpu)
    dft_t = sht._transposed(sht._irdft_tensor, NLON, MMAX, cpu)
    return dft, dft_t, dft, dft_t


def _inputs(seed, orientation):
    """x as the grid stage takes it (analysis rows (R, nlon); synthesis
    (2*mmax, R), m leading), the same as (R, K) rows, and a cotangent of the
    output as (R, N) rows."""
    rng = np.random.RandomState(seed)
    K, N = (NLON, 2 * MMAX) if orientation == "analysis" else (2 * MMAX, NLON)
    rows = rng.randn(R, K).astype(np.float32)
    g = rng.randn(R, N).astype(np.float32)
    z = rows if orientation == "analysis" else np.ascontiguousarray(rows.T)
    return z, rows, g


def _stage(z, orientation, requires_grad=False):
    t, t_t, dft, dft_t = _tables(orientation)
    zt = torch.from_numpy(z).requires_grad_(requires_grad)
    out = sht._grid_stage(zt, dft, dft_t, orientation == "analysis")
    # as (R, N) rows: the analysis comes out m-leading
    return zt, out, (out.T if orientation == "analysis" else out)


def _pallas(x, t, passes, out_dtype=jnp.float32):
    return np.asarray(pallas_mm.gridmm(x, jnp.asarray(t), passes=passes, out_dtype=out_dtype,
                                       tr=8, interpret=True).astype(jnp.float32))


# --------------------------------------------------------------------------
# (a) the forward at each mode against pallas_mm.gridmm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("orientation", ["analysis", "synthesis"])
@pytest.mark.parametrize("mode", MODES)
def test_grid_stage_matches_pallas_gridmm(mode, orientation):
    z, rows, _ = _inputs(1, orientation)
    t = _tables(orientation)[0].numpy()
    sht.set_coeff_engine("stacked")
    sht.set_transform_precision(mode)
    before = dict(kernels.launches)
    _, out, got = _stage(z, orientation)
    assert kernels.launches == before
    assert out.dtype == torch.float32 and out.is_contiguous()
    got = got.numpy()
    if mode == "highest":
        assert _rel(got, rows.astype(np.float64) @ t.astype(np.float64)) < HIGHEST_TOL
        return
    cast, passes, _, _ = JAX_GRID[mode]
    x = jnp.asarray(rows).astype(jnp.bfloat16 if cast == "bf16" else jnp.float32)
    want = _pallas(x, t, passes)
    assert _rel(got, want) < TWIN_TOL


def test_grid_stage_keeps_a_bf16_x_at_three_passes():
    """Under AMP "high" takes the bf16 x as it is (makani_tpu upcasts it,
    the same values): the 3-pass value of the bf16 rows."""
    z, rows, _ = _inputs(2, "analysis")
    t = _tables("analysis")[0].numpy()
    sht.set_coeff_engine("stacked")
    sht.set_transform_precision("high")
    xb = torch.from_numpy(z).to(torch.bfloat16)
    got = sht._grid_stage(xb, *_tables("analysis")[2:], True).T.numpy()
    want = _pallas(jnp.asarray(rows).astype(jnp.bfloat16).astype(jnp.float32), t, 3)
    assert _rel(got, want) < TWIN_TOL


# --------------------------------------------------------------------------
# (b) the backward
# --------------------------------------------------------------------------

def _accelerator_einsum(x, table, precision):
    """transform_einsum's accelerator branch for stage="grid"
    (makani_tpu/ops/sht.py:161-182) on (R, K) x (K, N)."""
    eq = "rk,kn->rn"
    if precision == "mixed2":
        return jnp.einsum(eq, x.astype(jnp.bfloat16), table, precision=jax.lax.Precision.HIGH)
    if precision in ("default", "tf32", "mixed"):
        return jnp.einsum(eq, x.astype(jnp.bfloat16), table.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    if precision == "split2":
        xb = x.astype(jnp.bfloat16)
        th = table.astype(jnp.bfloat16)
        tl = (table - th.astype(jnp.float32)).astype(jnp.bfloat16)
        return (jnp.einsum(eq, xb, th, preferred_element_type=jnp.float32)
                + jnp.einsum(eq, xb, tl, preferred_element_type=jnp.float32))
    prec = jax.lax.Precision.HIGH if precision == "high" else jax.lax.Precision.HIGHEST
    return jnp.einsum(eq, x, table, precision=prec)


@pytest.mark.parametrize("orientation", ["analysis", "synthesis"])
@pytest.mark.parametrize("mode", MODES)
def test_grid_stage_backward(mode, orientation):
    z, rows, g = _inputs(3, orientation)
    t, t_t = (a.numpy() for a in _tables(orientation)[:2])
    sht.set_coeff_engine("stacked")
    sht.set_transform_precision(mode)
    zt, out, _ = _stage(z, orientation, requires_grad=True)
    out.backward(torch.from_numpy(g.T.copy() if orientation == "analysis" else g))
    dx = zt.grad.numpy()
    assert zt.grad.dtype == torch.float32
    dx = dx if orientation == "analysis" else dx.T              # as (R, K) rows
    exact = g.astype(np.float64) @ t_t.astype(np.float64)
    if mode == "highest":
        assert _rel(dx, exact) < HIGHEST_TOL
        return
    _, _, passes, rounded = JAX_GRID[mode]
    if rounded:
        assert np.array_equal(dx, dx.astype(jnp.bfloat16).astype(np.float32))
    # the interpret-mode kernel at the transposed table
    want = _pallas(jnp.asarray(g), t_t, passes, jnp.bfloat16 if rounded else jnp.float32)
    _assert_close(dx, want, TWIN_TOL, 1 if rounded else 0)
    # jax.vjp of makani_tpu's own expressions, the cotangent rounded where
    # they dot at DEFAULT (module docstring)
    default_dots = mode in ("default", "tf32", "mixed", "split2")
    gj = jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32) if default_dots else jnp.asarray(g)
    _, vjp = jax.vjp(lambda v: _accelerator_einsum(v, jnp.asarray(t), mode), jnp.asarray(rows))
    want = np.asarray(vjp(gj)[0])
    if default_dots:
        _assert_close(dx, want, TWIN_TOL, VJP_ULPS)
    else:
        _assert_close(dx, want, P3_TOL, 1 if rounded else 0)
    # float64: the pass bound, half a bf16 ulp of each element where rounded
    err = np.abs(dx - exact)
    slack = (P3_TOL if passes == 3 else P1_TOL) * np.abs(exact).max()
    assert np.all(err <= slack + (2.0 ** -8 * np.abs(exact) if rounded else 0))
    if rounded:
        assert err.max() / np.abs(exact).max() > ROUNDS


def test_grid_stage_backward_of_a_bf16_x_is_bf16():
    """Under AMP the cotangent of a bf16 x is bf16, at "high" too (the VJP
    of makani_tpu's upcast)."""
    z, _, g = _inputs(4, "analysis")
    t_t = _tables("analysis")[1].numpy()
    sht.set_coeff_engine("stacked")
    sht.set_transform_precision("high")
    xb = torch.from_numpy(z).to(torch.bfloat16).requires_grad_(True)
    sht._grid_stage(xb, *_tables("analysis")[2:], True).backward(torch.from_numpy(g.T.copy()))
    assert xb.grad.dtype == torch.bfloat16
    want = _pallas(jnp.asarray(g), t_t, 3, jnp.bfloat16)
    _assert_close(xb.grad.float().numpy(), want, TWIN_TOL, 1)


# --------------------------------------------------------------------------
# (c) the CPU rule of the "kernel" and "xla" engines
# --------------------------------------------------------------------------

def _float32_stage(z, dft, dft_t, analysis):
    """The grid stage before it took the modes: one float32 matmul."""
    return torch.matmul(dft, z.float().T) if analysis else torch.matmul(z.float().T, dft)


def _sht_pair(x, c):
    fwd = sht.RealSHT(NLAT, NLON, LMAX, MMAX, grid="legendre-gauss")
    inv = sht.InverseRealSHT(NLAT, NLON, LMAX, MMAX, grid="legendre-gauss")
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(c).requires_grad_(True)
    coeffs, back = fwd(xt), inv(ct)
    (coeffs.abs().square().sum() + back.square().sum()).backward()
    return [a.detach().numpy() for a in (coeffs, back, xt.grad, ct.grad)]


@pytest.mark.parametrize("engine", ["kernel", "xla"])
@pytest.mark.parametrize("mode", MODES)
def test_cpu_engines_keep_the_float32_dft(monkeypatch, engine, mode):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, NLAT, NLON).astype(np.float32)
    c = (rng.randn(2, 3, LMAX, MMAX) + 1j * rng.randn(2, 3, LMAX, MMAX)).astype(np.complex64)
    sht.set_coeff_engine(engine)
    sht.set_transform_precision(mode)
    before = dict(kernels.launches)
    got = _sht_pair(x, c)
    assert kernels.launches == before
    monkeypatch.setattr(sht, "_grid_stage", _float32_stage)
    want = _sht_pair(x, c)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# (d) the "stacked" engine's SHT pair at each mode against float64
# --------------------------------------------------------------------------

def _f64_pair(x, c):
    """The analysis of x and the synthesis of c in float64, from the port's
    float32 tables."""
    cpu = torch.device("cpu")
    T = sht._rdft_tensor(NLON, MMAX, cpu).double().numpy()         # (2*mmax, nlon)
    Ts = sht._irdft_tensor(NLON, MMAX, cpu).double().numpy()
    pct = sht._get_pct("legendre-gauss", NLAT, LMAX, MMAX).astype(np.float64)  # (mmax, l, k)
    wq = sht._theta_weights("legendre-gauss", NLAT)[1].astype(np.float32).astype(np.float64)
    z = np.einsum("bckj,mj->mbck", x.astype(np.float64), T) * wq
    zc = z[:MMAX] + 1j * z[MMAX:]
    coeffs = np.einsum("mbck,mlk->bclm", zc, pct)
    o = np.einsum("bclm,mlk->mbck", c.astype(np.complex128), pct)
    back = (np.einsum("mbck,mj->bckj", o.real, Ts[:MMAX])
            + np.einsum("mbck,mj->bckj", o.imag, Ts[MMAX:]))
    return coeffs, back


def _f64_pair_torch(x, c):
    """_f64_pair in torch float64, differentiable: the exact adjoints."""
    cpu = torch.device("cpu")
    T = sht._rdft_tensor(NLON, MMAX, cpu).double()
    Ts = sht._irdft_tensor(NLON, MMAX, cpu).double()
    pct = torch.from_numpy(sht._get_pct("legendre-gauss", NLAT, LMAX, MMAX)).double()
    wq = torch.from_numpy(sht._theta_weights("legendre-gauss", NLAT)[1].astype(np.float32)).double()
    z = (torch.einsum("bckj,mj->mbck", x, T) * wq).view(2, MMAX, *x.shape[:-1])
    coeffs = torch.einsum("smbck,mlk->sbclm", z, pct)       # (re, im)
    o = torch.einsum("sbclm,mlk->smbck", c, pct)
    back = (torch.einsum("mbck,mj->bckj", o[0], Ts[:MMAX])
            + torch.einsum("mbck,mj->bckj", o[1], Ts[MMAX:]))
    return coeffs, back


@pytest.mark.parametrize("mode", MODES)
def test_stacked_sht_pair_gradients_within_the_mode_bound(mode):
    """The pair's gradients on the "stacked" engine (the grid stage's
    backward through the in-place quadrature weights of the analysis)
    against the float64 adjoints."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 3, NLAT, NLON).astype(np.float32)
    c = rng.randn(2, 2, 3, LMAX, MMAX).astype(np.float32)   # (re, im)
    gc = rng.randn(2, 3, LMAX, 2 * MMAX).astype(np.float32)
    gx = rng.randn(2, 3, NLAT, NLON).astype(np.float32)
    sht.set_coeff_engine("stacked")
    sht.set_transform_precision(mode)
    fwd = sht.RealSHT(NLAT, NLON, LMAX, MMAX, grid="legendre-gauss")
    inv = sht.InverseRealSHT(NLAT, NLON, LMAX, MMAX, grid="legendre-gauss")
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(c).requires_grad_(True)
    coeffs = torch.view_as_real(fwd(xt))                     # (..., l, m, 2)
    coeffs = torch.cat([coeffs[..., 0], coeffs[..., 1]], dim=-1)
    back = inv(torch.complex(ct[0], ct[1]))
    ((coeffs * torch.from_numpy(gc)).sum() + (back * torch.from_numpy(gx)).sum()).backward()
    x64 = torch.from_numpy(x).double().requires_grad_(True)
    c64 = torch.from_numpy(c).double().requires_grad_(True)
    want_c, want_x = _f64_pair_torch(x64, c64)
    want_c = torch.cat([want_c[0], want_c[1]], dim=-1)
    ((want_c * torch.from_numpy(gc).double()).sum()
     + (want_x * torch.from_numpy(gx).double()).sum()).backward()
    bound = _f64_bound(mode, JAX_GRID.get(mode, (None,) * 4)[3])
    errs = [_rel(xt.grad.numpy(), x64.grad.numpy()), _rel(ct.grad.numpy(), c64.grad.numpy())]
    assert max(errs) < bound, errs
    if mode not in ("high", "highest"):
        assert max(errs) > ROUNDS


@pytest.mark.parametrize("mode", MODES)
def test_stacked_sht_pair_within_the_mode_bound(mode):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, NLAT, NLON).astype(np.float32)
    c = (rng.randn(2, 3, LMAX, MMAX) + 1j * rng.randn(2, 3, LMAX, MMAX)).astype(np.complex64)
    sht.set_coeff_engine("stacked")
    sht.set_transform_precision(mode)
    fwd = sht.RealSHT(NLAT, NLON, LMAX, MMAX, grid="legendre-gauss")
    inv = sht.InverseRealSHT(NLAT, NLON, LMAX, MMAX, grid="legendre-gauss")
    coeffs = fwd(torch.from_numpy(x)).numpy()
    back = inv(torch.from_numpy(c)).numpy()
    want_c, want_x = _f64_pair(x, c)
    bound = _f64_bound(mode, JAX_GRID.get(mode, (None,) * 4)[3])
    errs = [_rel(coeffs.real, want_c.real), _rel(coeffs.imag, want_c.imag), _rel(back, want_x)]
    assert max(errs) < bound, errs
    if mode not in ("high", "highest"):
        assert _rel(coeffs.real, want_c.real) > ROUNDS


# --------------------------------------------------------------------------
# gridmm's layouts (the twin; the kernel's in tests/test_torch_port_cuda.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("x_kmajor,out_t,rounded", [(False, False, True), (True, False, False),
                                                    (False, True, False), (True, True, True)])
def test_gridmm_layouts_of_the_twin(x_kmajor, out_t, rounded):
    """A K-major x (the transpose of a contiguous (K, R) tensor) gives the
    row-major x's values; out_t the same values transposed, (N, R); round_bf16
    the float32 sum rounded to bf16 values, as pallas_mm.gridmm's bf16
    output holds them. No launch on the CPU."""
    rng = np.random.RandomState(7)
    rows = rng.randn(R, NLON).astype(np.float32)
    t = rng.randn(NLON, 2 * MMAX).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(rows.T)).T if x_kmajor else torch.from_numpy(rows)
    assert x.is_contiguous() != x_kmajor
    before = dict(kernels.launches)
    got = spectral_mm.gridmm(x, torch.from_numpy(t), 2, out_t=out_t, round_bf16=rounded)
    assert kernels.launches == before
    assert got.shape == ((2 * MMAX, R) if out_t else (R, 2 * MMAX)) and got.is_contiguous()
    assert got.dtype == torch.float32
    want = _pallas(jnp.asarray(rows), t, 2, jnp.bfloat16 if rounded else jnp.float32)
    _assert_close((got.T if out_t else got).numpy(), want, TWIN_TOL, 1 if rounded else 0)
    with pytest.raises(ValueError, match="round_bf16"):
        spectral_mm.gridmm(x, torch.from_numpy(t), 2, torch.bfloat16, round_bf16=True)
