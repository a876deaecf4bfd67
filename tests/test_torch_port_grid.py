"""makani_tpu_torch's kernel-benchmark and probe path against makani_tpu on the
CPU: `spectral_mm.gridmm`, the grid dot of tools/bench_gridmm.py, the probe
battery of tools/kernel_isolate.py, the three tools end to end, and legmm's
paired layout (M2 = mmax).

The same inputs, made with numpy from a seed, go through the JAX function and
the port's plain twin: pallas_mm.gridmm and pallas_mm.legmm in interpret mode,
and the TPU kernels of scripts/bench_gridmm.py and scripts/pallas_isolate.py,
which call pl.pallas_call without `interpret` and run here with
pallas_call patched to interpret=True. pallas_isolate's cases build constant
inputs (ones, fixed fills); the tests hand them seeded normal values instead,
so a transposed operand cannot hide. Its two dhconv cases pass
interpret=False themselves and are built here from contract_dhconv_pallas in
interpret mode and jax.grad. The kernels are held against the twins on the
card (tests/test_torch_port_cuda.py, chip_smoke.py phase 8).

Tolerances, relative to the reference's largest magnitude:
  - a twin against the interpret-mode Pallas kernel: 1e-5 (TWIN_TOL). Both
    split the same float32 operands into the same bf16 parts, every bf16
    product is exact in float32, and only the order of the float32 sums
    differs. A bf16 output is held to one bf16 ulp of each element on top of
    that: the float32 sums may sit on either side of a rounding boundary.
  - against float64: 5e-5 at 3 passes and at 2 passes on a bf16 x (the
    activation is exact in bf16), 5e-2 at 1 pass (tests/test_pallas_mm.py).
  - the dhconv probe cases: 1e-5 for the forward (both sides run the 3-pass
    splits); 5e-5, the 3-pass bound, for the gradients, whose 3M sums round
    differently in the two frameworks (tests/test_torch_port_complex.py).
"""

import functools
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from makani_tpu.ops import pallas_mm
from makani_tpu.ops.pallas_kernels import contract_dhconv_pallas

from makani_tpu_torch.ops import kernels, spectral_mm
from makani_tpu_torch.tools import bench_gridmm, bench_spectral_mm, kernel_isolate

TWIN_TOL = 1e-5
P3_TOL = 5e-5
P1_TOL = 5e-2
SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
BF16 = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def scripts(monkeypatch):
    """scripts/ importable, and pl.pallas_call in interpret mode."""
    monkeypatch.syspath_prepend(str(SCRIPTS))
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    return importlib.import_module


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits): 2**(e - 8)
    for |v| in [2**(e-1), 2**e), e from frexp (exact at powers of two)."""
    return np.ldexp(1.0, np.frexp(np.asarray(v, np.float64))[1] - 8)


def _assert_twin_bf16(got, want):
    """TWIN_TOL of the largest magnitude plus one bf16 ulp of each element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    slack = TWIN_TOL * np.abs(want).max() + _bf16_ulp(want)
    assert np.all(np.abs(got - want) <= slack), np.abs(got - want).max()


def _to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_to_np(a):
    return np.asarray(a.astype(jnp.float32))


def _grid_inputs(seed, R=300, K=96, N=200, xdtype="f32"):
    rng = np.random.RandomState(seed)
    x = rng.randn(R, K).astype(np.float32)
    t = rng.randn(K, N).astype(np.float32)
    tx = torch.from_numpy(x).to(BF16[xdtype])
    jx = jnp.asarray(x).astype(jnp.bfloat16 if xdtype == "bf16" else jnp.float32)
    return tx, torch.from_numpy(t), jx, jnp.asarray(t)


# --------------------------------------------------------------------------
# gridmm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
@pytest.mark.parametrize("passes", [1, 2, 3])
def test_gridmm_plain_matches_pallas(passes, xdtype, out):
    tx, tt, jx, jt = _grid_inputs(30 + passes, xdtype=xdtype)
    jout = jnp.bfloat16 if out == "bf16" else jnp.float32
    want = _jax_to_np(pallas_mm.gridmm(jx, jt, passes=passes, out_dtype=jout, tr=128,
                                       interpret=True))
    got = spectral_mm.gridmm_plain(tx, tt, passes, BF16[out])
    assert got.dtype == BF16[out] and tuple(got.shape) == want.shape == (300, 200)
    if out == "bf16":
        _assert_twin_bf16(_to_np(got), want)
    else:
        assert _rel(got.numpy(), want) < TWIN_TOL


@pytest.mark.parametrize("passes,xdtype,tol", [(3, "f32", P3_TOL), (2, "bf16", P3_TOL),
                                               (3, "bf16", P3_TOL), (1, "f32", P1_TOL)])
def test_gridmm_plain_matches_f64(passes, xdtype, tol):
    tx, tt, _, _ = _grid_inputs(40, R=257, K=131, N=66, xdtype=xdtype)
    ref = tx.double().numpy() @ tt.double().numpy()
    err = _rel(spectral_mm.gridmm_plain(tx, tt, passes).numpy(), ref)
    assert err < tol
    if passes == 1:
        assert err > 1e-4  # one pass rounds both operands to bf16


def test_gridmm_bf16_x_three_passes_is_two():
    """A bf16 x splits with lo = 0: 3 passes give exactly the 2-pass value
    (the kernel runs its 2-pass build)."""
    tx, tt, _, _ = _grid_inputs(41, xdtype="bf16")
    assert torch.equal(spectral_mm.gridmm_plain(tx, tt, 3), spectral_mm.gridmm_plain(tx, tt, 2))


def test_gridmm_takes_the_twin_on_cpu_without_counting():
    tx, tt, _, _ = _grid_inputs(42, R=37, K=24, N=10)
    before = dict(kernels.launches)
    for out in (torch.float32, torch.bfloat16):
        assert torch.equal(spectral_mm.gridmm(tx, tt, 3, out), spectral_mm.gridmm_plain(tx, tt, 3,
                                                                                        out))
    assert kernels.launches == before


@pytest.mark.parametrize("fn", [spectral_mm.gridmm, spectral_mm.gridmm_plain])
def test_gridmm_refuses_gradients_dtypes_and_shapes(fn):
    x, t = torch.randn(5, 4), torch.randn(4, 3)
    with pytest.raises(RuntimeError, match="no VJP"):
        fn(x.requires_grad_(), t)
    with torch.no_grad():
        fn(x, t)
    x = x.detach()
    with pytest.raises(TypeError):
        fn(x.double(), t)
    with pytest.raises(TypeError):
        fn(x, t.bfloat16())
    with pytest.raises(TypeError):
        fn(x, t, 3, torch.float16)
    with pytest.raises(ValueError):
        fn(x, t[:3])
    with pytest.raises(ValueError):
        fn(x[None], t)
    with pytest.raises(ValueError):
        fn(x, t, 4)


# --------------------------------------------------------------------------
# legmm's paired layout: any M2, row g against table g % mmax
# --------------------------------------------------------------------------

@pytest.mark.parametrize("passes", [2, 3])
@pytest.mark.parametrize("contract", ["k", "l"])
@pytest.mark.parametrize("pairs", [1, 2])
def test_legmm_plain_any_m2_matches_pallas(pairs, contract, passes):
    """M2 = mmax (the paired layout of scripts/bench_pallas_mm.py's legendre2)
    and M2 = 2*mmax (the stacked layout), every dimension distinct."""
    rng = np.random.RandomState(50 + pairs)
    mmax, C, K, L = 5, 12, 23, 9
    z = rng.randn(pairs * mmax, C, K if contract == "k" else L).astype(np.float32)
    p = rng.randn(mmax, L, K).astype(np.float32)
    want = pallas_mm.legmm(jnp.asarray(z), jnp.asarray(p), passes=passes, contract=contract,
                           interpret=True)
    got = spectral_mm.legmm(torch.from_numpy(z), torch.from_numpy(p), passes, contract)
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) < TWIN_TOL


@pytest.mark.parametrize("contract", ["k", "l"])
def test_legdot_vjp_paired_matches_pallas(contract):
    rng = np.random.RandomState(52)
    mmax, C, K, L = 5, 7, 23, 9
    z = rng.randn(mmax, C, K if contract == "k" else L).astype(np.float32)
    p = rng.randn(mmax, L, K).astype(np.float32)
    g = rng.randn(mmax, C, L if contract == "k" else K).astype(np.float32)
    _, vjp = jax.vjp(lambda a: pallas_mm.legdot(a, jnp.asarray(p), contract, 3, True),
                     jnp.asarray(z))
    (want,) = vjp(jnp.asarray(g))
    zt = torch.from_numpy(z).requires_grad_()
    spectral_mm.legdot(zt, torch.from_numpy(p), contract, 3).backward(torch.from_numpy(g))
    assert _rel(zt.grad.numpy(), want) < TWIN_TOL


# --------------------------------------------------------------------------
# the grid dot of scripts/bench_gridmm.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
def test_grid_dot_plain_matches_script(scripts, xdtype, out):
    script = scripts("bench_gridmm")
    tx, tt, jx, jt = _grid_inputs(60, R=300, K=96, N=130, xdtype=xdtype)
    jout = jnp.bfloat16 if out == "bf16" else jnp.float32
    want = _jax_to_np(script.grid_dot_pallas(jx, jt, out_dtype=jout, tr=128))
    got = bench_gridmm.grid_dot_plain(tx, *bench_gridmm.split_table(tt), BF16[out])
    assert got.dtype == BF16[out]
    if out == "bf16":
        _assert_twin_bf16(_to_np(got), want)
    else:
        assert _rel(got.numpy(), want) < TWIN_TOL
    ref = tx.double().numpy() @ tt.double().numpy()
    assert _rel(_to_np(got), ref) < (P3_TOL if out == "f32" else 2.0 ** -8)


def test_grid_dot_order_differs_from_gridmm():
    """float32 x: grid_dot sums (hh + hl) + lh, gridmm hh + (hl + lh); the
    twins follow their own kernel's order."""
    tx, tt, _, _ = _grid_inputs(61, R=64, K=40, N=30)
    th, tl = bench_gridmm.split_table(tt)
    xh, xl = spectral_mm.split_bf16(tx)
    hh, hl, lh = xh @ th.float(), xh @ tl.float(), xl @ th.float()
    assert torch.equal(bench_gridmm.grid_dot_plain(tx, th, tl), (hh + hl) + lh)
    assert torch.equal(spectral_mm.gridmm_plain(tx, tt, 3), hh + (hl + lh))


def test_grid_dot_refuses_gradients_dtypes_and_shapes():
    x, t = torch.randn(5, 4), torch.randn(4, 6)
    th, tl = bench_gridmm.split_table(t)
    with pytest.raises(RuntimeError, match="no VJP"):
        bench_gridmm.grid_dot(x.requires_grad_(), th, tl)
    x = x.detach()
    with pytest.raises(TypeError):
        bench_gridmm.grid_dot(x, t, tl)
    with pytest.raises(ValueError):
        bench_gridmm.grid_dot(x, th, tl[:, :3])
    before = dict(kernels.launches)
    assert torch.equal(bench_gridmm.grid_dot(x, th, tl), bench_gridmm.grid_dot_plain(x, th, tl))
    assert kernels.launches == before


# --------------------------------------------------------------------------
# the probe battery of scripts/pallas_isolate.py
# --------------------------------------------------------------------------

class _SeededInputs:
    """jax.numpy with `ones` and `full` drawing seeded normal values instead,
    each kept in `made` for the twin."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.made = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def _draw(self, shape, dtype):
        a = self.rng.randn(*shape).astype(np.float32)
        self.made.append(a)
        return jnp.asarray(a, dtype)

    def ones(self, shape, dtype=None):
        return self._draw(shape, dtype)

    def full(self, shape, fill_value, dtype=None):
        return self._draw(shape, dtype)


PROBES = {"copy": ("case_copy", kernel_isolate.copy_plain),
          "dot_plain": ("case_dot_plain", kernel_isolate.dot_plain_plain),
          "dot_transposed": ("case_dot_transposed", kernel_isolate.dot_transposed_plain),
          "grid_blocks": ("case_grid_blocks", kernel_isolate.grid_blocks_plain),
          "stacked_output_5d": ("case_stacked_output", kernel_isolate.stacked_output_plain),
          "multi_output": ("case_multi_output", kernel_isolate.multi_output_plain),
          "bf16_split": ("case_bf16_split", kernel_isolate.bf16_split_plain)}


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_twin_matches_script(scripts, monkeypatch, name):
    script = scripts("pallas_isolate")
    inputs = _SeededInputs(70 + list(PROBES).index(name))
    monkeypatch.setattr(script, "jnp", inputs)
    case, twin = PROBES[name]
    want = getattr(script, case)()
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = twin(*(torch.from_numpy(a) for a in inputs.made))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _rel(g.numpy(), w) < TWIN_TOL


def test_probe_cases_are_the_scripts(scripts):
    script = scripts("pallas_isolate")
    assert [c[0] for c in kernel_isolate.CASES] == [c[0] for c in script.CASES]
    assert (kernel_isolate.C, kernel_isolate.O, kernel_isolate.M) == (script.C, script.O, script.M)


def _dhconv_planes(seed):
    rng = np.random.RandomState(seed)
    B, C, O, L, M = 2, 6, 5, 3, 13
    return (rng.randn(2, B, C, L, M).astype(np.float32),
            rng.randn(2, C, O, L).astype(np.float32))


def test_probe_dhconv_tiny_matches_pallas():
    xp, wp = _dhconv_planes(80)
    o = contract_dhconv_pallas(jax.lax.complex(xp[0], xp[1]), jax.lax.complex(wp[0], wp[1]), True)
    got = kernel_isolate.dhconv_tiny(torch.from_numpy(xp), torch.from_numpy(wp))
    assert _rel(got[0].numpy(), np.real(o)) < TWIN_TOL
    assert _rel(got[1].numpy(), np.imag(o)) < TWIN_TOL
    plain = kernel_isolate.dhconv_tiny_plain(torch.from_numpy(xp), torch.from_numpy(wp))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_probe_dhconv_grad_matches_pallas():
    """Real planes in and a real loss out: both frameworks give these
    gradients alike (no conjugate convention enters)."""
    xp, wp = _dhconv_planes(81)

    def loss(a, b):
        o = contract_dhconv_pallas(jax.lax.complex(a[0], a[1]), jax.lax.complex(b[0], b[1]), True)
        return jnp.sum(jnp.abs(o) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(xp), jnp.asarray(wp))
    for fn in (kernel_isolate.dhconv_grad, kernel_isolate.dhconv_grad_plain):
        got = fn(torch.from_numpy(xp), torch.from_numpy(wp))
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            assert _rel(g.numpy(), w) < P3_TOL


# --------------------------------------------------------------------------
# the tools end to end on the CPU, at tiny shapes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dhconv", "legendre", "legendre2", "grid", "all"])
def test_bench_spectral_mm_runs(family, capsys):
    shapes = dict(dhconv=dict(B=2, L=3, C=6, O=5, M=7), legendre=dict(mmax=5, C=6, K=7, L=4),
                  legendre2=dict(mmax=5, C=6, K=7, L=4),
                  grid=dict(shapes=((37, 24, 10, "a"), (20, 8, 12, "b")), rows=16))
    assert bench_spectral_mm.run(family, "cpu", 2, **shapes) == 0
    out = capsys.readouterr().out
    assert "OVER BOUND" not in out and "maxrel" in out
    assert " ms" not in out.replace("not measured", "")  # nothing timed on the CPU


def test_bench_gridmm_runs(capsys):
    assert bench_gridmm.run("cpu", 2, R=37, K=24, N=10, rows=16, legendre=(6, 5, 7)) == 0
    out = capsys.readouterr().out
    assert "maxrel grid_dot 2p" in out and "maxrel grid_dot 3p" in out
    with pytest.raises(ValueError):
        bench_gridmm.run("cpu", 2, R=8, K=4, N=5)


def test_kernel_isolate_runs_nine_cases(capsys):
    assert kernel_isolate.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS") == 9 and "FAIL" not in out
    assert kernel_isolate.main(["--device", "cpu", "copy", "bf16_split"]) == 0
    assert capsys.readouterr().out.count("PASS") == 2


def test_kernel_isolate_returns_1_on_a_failing_case(monkeypatch, capsys):
    cases = [c if c[0] != "dot_plain" else (c[0], c[1], c[2], kernel_isolate.dot_transposed_plain)
             for c in kernel_isolate.CASES]
    monkeypatch.setattr(kernel_isolate, "CASES", cases)
    assert kernel_isolate.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.count("PASS") == 8 and "FAIL dot_plain" in out
