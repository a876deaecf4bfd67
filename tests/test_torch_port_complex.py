"""makani_tpu_torch's complex coefficient engine ("xla") against makani_tpu on
the CPU.

The same inputs, made with numpy from a seed, go through the JAX function and
its counterpart in the port: the complex contraction family of complex_ops,
the complex dhconv kernel's plain twin (ops/complex_kernels.py) against
`contract_dhconv_pallas` in interpret mode, the SHT's complex path, the complex
branch of SpectralConv, and a 3-block SFNO's forward, rollout, gradients and
Trainer steps. The kernel itself is held against the twin on the card
(tests/test_torch_port_cuda.py, chip_smoke.py phase 7). makani_tpu's model
cannot run its Pallas kernel on the CPU (complex_ops.contract_dhconv passes
interpret=False), so the whole-model tests hold the port with the kernel
toggle on (its twin here) against makani_tpu with the toggle off.

Tolerances, relative to the largest magnitude of the reference:
  - the contraction family and _cplx_einsum, 3M and 4M: 1e-5. Both sides are
    float32 on the CPU; only the order of the sums differs.
  - the kernel's twin against the interpret-mode Pallas kernel, 3 passes and
    1: 1e-5. Both split the same float32 operands into the same bf16 parts,
    every bf16 product is exact in float32, and only the order of the float32
    sums differs. Interpret mode's 1-pass dot does not round its float32
    operands (Mosaic's does, on the TPU), so 1 pass is held at 1e-5 on
    bf16-exact operands and at the 1-pass bound 5e-2 on random ones.
  - the kernel wrapper's gradients against jax.grad of the interpret-mode
    kernel: 5e-5, the 3-pass bound of tests/test_pallas_mm.py (5e-2 for 1
    pass). PyTorch's dx contracts g with conj(w), JAX's contracts its
    conjugate cotangent with w: the same value, but the 3M sums (wr +- wi)
    and (gr +- gi) differ in sign and round differently.
  - the SHT's complex path: 1e-5 under "high" and "highest" (float32 on both
    sides), and the 1-pass bound 5e-2 under "default": the port rounds the
    Legendre operands to bf16 on every device, JAX's CPU dots never round
    (makani_tpu/ops/sht.py:156-160).
  - SpectralConv: 1e-5 on the float32 complex path; 5e-5, the 3-pass bound
    of tests/test_pallas_mm.py, where the kernel's twin or the kernel engine's
    Legendre twin runs.
  - the 3-block SFNO (forward, 3-step rollout, gradients per leaf): 2e-4, the
    bound of tests/test_torch_port_model.py and test_torch_port_train.py; the
    kernel's 3-pass splits run in every block, forward and backward. The
    MLP's output bias, whose exact gradient is zero, is measured against the
    largest gradient (test_torch_port_train.py's ZERO_GRAD). Measured: up to
    3.0e-5 per leaf under "high" and 2.7e-5 under "highest", where the port
    is float32 throughout: the float32 sums of the 1x1 convs and the norms
    over the grid, in another order than XLA's, dominate either way.
  - Trainer steps: test_torch_port_train.py's bounds (STEP_LOSS_TOL on the
    losses, UPDATE_TOL norm-wise on the updates over the elements whose
    first gradient is at least SIGN_FLOOR of their leaf's largest).

Gradients are held on real quantities or conjugated: JAX's cotangent of a
complex input is the conjugate of PyTorch's gradient.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from makani_tpu.ops import complex_ops as jcomplex
from makani_tpu.ops import sht as jsht
from makani_tpu.ops.pallas_kernels import contract_dhconv_pallas
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.models import model_registry as tregistry
from makani_tpu_torch.ops import complex_ops as tcomplex
from makani_tpu_torch.ops import kernels
from makani_tpu_torch.ops import sht as tsht
from makani_tpu_torch.ops.complex_kernels import (
    contract_dhconv_kernel,
    contract_dhconv_plain,
    contract_dhconv_raw,
)
from makani_tpu_torch.tools.convert_jax_params import load_jax_opt_state, load_jax_params
from makani_tpu_torch.utils.param_layout import jax_key_to_torch, to_port_layout
from makani_tpu_torch.utils.yparams import YParams as TYParams

F32_TOL = 1e-5
P3_TOL = 5e-5
P1_TOL = 5e-2
MODEL_TOL = 2e-4
STEP_LOSS_TOL = 1e-4
UPDATE_TOL = 2e-2
SIGN_FLOOR = 1e-3
NLAT, NLON, CHANS = 36, 72, 5
ZERO_GRAD = "mlp.fc2.bias"


def _defaults():
    for mod in (tsht, jsht):
        mod.set_transform_precision("high")
    for mod in (tcomplex, jcomplex):
        mod.set_contraction_precision("high")
        mod.enable_pallas_kernels(False)
        mod.set_3m_contraction(True)
    tsht.set_coeff_engine("kernel")
    jsht.set_coeff_engine("xla")


@pytest.fixture(autouse=True)
def _globals():
    """Both packages' engine, precisions, kernel toggle and 3M flag are module
    globals, shared with every test file of the worker: start from the
    defaults and leave them so."""
    _defaults()
    yield
    _defaults()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got.astype(np.complex128) - want).max() / np.abs(want).max()


def _cplx(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _set_precision(name):
    for mod in (tsht, jsht):
        mod.set_transform_precision(name)
    for mod in (tcomplex, jcomplex):
        mod.set_contraction_precision(name)


# --------------------------------------------------------------------------
# the contraction family
# --------------------------------------------------------------------------

B, C, O, L, M, R = 2, 6, 5, 4, 7, 3


def _family_args(name, rng):
    x2 = _cplx(rng, B, C, L, M)
    bias = _cplx(rng, O, 1, 1)
    return {
        "compl_mul1d": (_cplx(rng, B, C, L), _cplx(rng, C, O)),
        "compl_mul2d": (x2, _cplx(rng, C, O)),
        "compl_muladd2d": (x2, _cplx(rng, C, O), bias),
        "compl_exp_mul2d": (x2, _cplx(rng, L, C, O)),
        "compl_exp_muladd2d": (x2, _cplx(rng, L, C, O), bias),
        "contract_diagonal": (x2, _cplx(rng, C, O, L, M)),
        "contract_dhconv": (x2, _cplx(rng, C, O, L)),
        "contract_sep_diagonal": (x2, _cplx(rng, C, L, M)),
        "contract_sep_dhconv": (x2, _cplx(rng, C, L)),
        "contract_rank": (x2, _cplx(rng, C, O, R), rng.randn(L, R).astype(np.float32),
                          rng.randn(M, R).astype(np.float32)),
    }[name]


FAMILY = ["compl_mul1d", "compl_mul2d", "compl_muladd2d", "compl_exp_mul2d",
          "compl_exp_muladd2d", "contract_diagonal", "contract_dhconv",
          "contract_sep_diagonal", "contract_sep_dhconv", "contract_rank"]


@pytest.mark.parametrize("m3", [True, False])
@pytest.mark.parametrize("name", FAMILY)
def test_contraction_family_matches_jax(name, m3):
    jargs, targs = _both(*_family_args(name, np.random.RandomState(FAMILY.index(name))))
    jcomplex.set_3m_contraction(m3)
    tcomplex.set_3m_contraction(m3)
    want = np.asarray(getattr(jcomplex, name)(*jargs))
    got = getattr(tcomplex, name)(*targs)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) < F32_TOL


@pytest.mark.parametrize("m3", [True, False])
def test_cplx_einsum_matches_jax(m3):
    rng = np.random.RandomState(20)
    (jx, jw), (tx, tw) = _both(_cplx(rng, B, C, L, M), _cplx(rng, L, C, O))
    jcomplex.set_3m_contraction(m3)
    tcomplex.set_3m_contraction(m3)
    want = np.asarray(jcomplex._cplx_einsum("bixy,xio->boxy", jx, jw))
    assert _rel(tcomplex._cplx_einsum("bixy,xio->boxy", tx, tw).numpy(), want) < F32_TOL


def test_default_precision_rounds_operands_to_bf16():
    """"default" rounds the operands on every device: against JAX's exact
    CPU einsum the port stays inside the 1-pass bound and is visibly not
    float32."""
    rng = np.random.RandomState(22)
    (jx, jw), (tx, tw) = _both(_cplx(rng, B, C, L, M), _cplx(rng, C, O, L))
    want = np.asarray(jcomplex.contract_dhconv(jx, jw))
    tcomplex.set_contraction_precision("default")
    assert tcomplex.contraction_passes() == 1
    err = _rel(tcomplex.contract_dhconv(tx, tw).numpy(), want)
    assert 1e-4 < err < P1_TOL
    for name in ("split2", "tf32", "mixed", "mixed2", "high", "highest"):
        tcomplex.set_contraction_precision(name)
        assert tcomplex.contraction_passes() == 3
        assert _rel(tcomplex.contract_dhconv(tx, tw).numpy(), want) < F32_TOL
    with pytest.raises(ValueError):
        tcomplex.set_contraction_precision("bf16")


def test_contract_dispatch_and_views_match_jax():
    for key, fn in jcomplex.CONTRACT_HANDLES.items():
        assert tcomplex.get_contract_fun(*key).__name__ == fn.__name__
    assert set(tcomplex.CONTRACT_HANDLES) == set(jcomplex.CONTRACT_HANDLES)
    with pytest.raises(ValueError):
        tcomplex.get_contract_fun("l-dependant", False)
    z = _cplx(np.random.RandomState(23), 3, 4)
    pair = tcomplex.view_as_real(torch.from_numpy(z))
    np.testing.assert_array_equal(pair.numpy(), np.asarray(jcomplex.view_as_real(jnp.asarray(z))))
    np.testing.assert_array_equal(tcomplex.view_as_complex(pair).numpy(), z)


# --------------------------------------------------------------------------
# the complex dhconv kernel's twin against contract_dhconv_pallas
# --------------------------------------------------------------------------

def _bf16_exact(rng, *shape):
    """Complex values k/8 with |k| <= 64 in both planes: every plane and the
    3M sums re + im are exact in bf16, so the 1-pass split rounds nothing."""
    re, im = (rng.randint(-64, 65, size=shape) / 8.0 for _ in range(2))
    return (re + 1j * im).astype(np.complex64)


@pytest.mark.parametrize("precision,passes", [("high", 3), ("default", 1)])
@pytest.mark.parametrize("b,c,o,l,m", [(2, 6, 5, 3, 130), (1, 9, 4, 2, 17)])
def test_contract_dhconv_plain_matches_pallas(precision, passes, b, c, o, l, m):
    """Under "default" the interpret-mode kernel's float32 dot does not round
    (Mosaic's 1-pass dot rounds its operands to bf16 on the TPU only): the
    twin is held against it on bf16-exact operands at 1e-5, and on random
    operands at the 1-pass bound."""
    rng = np.random.RandomState(24)
    jcomplex.set_contraction_precision(precision)
    tcomplex.set_contraction_precision(precision)
    assert tcomplex.contraction_passes() == passes
    make = _cplx if passes == 3 else _bf16_exact
    (jx, jw), (tx, tw) = _both(make(rng, b, c, l, m), make(rng, c, o, l))
    want = np.asarray(contract_dhconv_pallas(jx, jw, True))
    got = contract_dhconv_plain(tx, tw, passes)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape == (b, o, l, m)
    assert _rel(got.numpy(), want) < F32_TOL
    if passes == 1:
        (jx, jw), (tx, tw) = _both(_cplx(rng, b, c, l, m), _cplx(rng, c, o, l))
        err = _rel(contract_dhconv_plain(tx, tw, 1).numpy(),
                   np.asarray(contract_dhconv_pallas(jx, jw, True)))
        assert 1e-4 < err < P1_TOL


@pytest.mark.parametrize("precision", ["high", "default"])
def test_contract_dhconv_kernel_grads_match_pallas(precision):
    """Real planes in, a real loss out: both frameworks agree on these
    gradients. Complex leaves agree up to JAX's conjugate convention."""
    rng = np.random.RandomState(25)
    x, w, cot = _cplx(rng, 2, 6, 3, 13), _cplx(rng, 6, 5, 3), _cplx(rng, 2, 5, 3, 13)
    jcomplex.set_contraction_precision(precision)
    tcomplex.set_contraction_precision(precision)

    def jloss(xr, xi, wr, wi):
        y = contract_dhconv_pallas(jax.lax.complex(xr, xi), jax.lax.complex(wr, wi), True)
        return jnp.sum(jnp.real(y) * cot.real + jnp.imag(y) * cot.imag)

    planes = [a.astype(np.float32) for a in (x.real, x.imag, w.real, w.imag)]
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, planes))

    leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in planes]
    passes = tcomplex.contraction_passes()
    y = contract_dhconv_kernel(torch.complex(leaves[0], leaves[1]),
                               torch.complex(leaves[2], leaves[3]), passes)
    (y.real * torch.from_numpy(cot.real) + y.imag * torch.from_numpy(cot.imag)).sum().backward()
    tol = P3_TOL if precision == "high" else P1_TOL
    for leaf, g in zip(leaves, want):
        assert _rel(leaf.grad.numpy(), g) < tol

    jx, jw = jnp.asarray(x), jnp.asarray(w)
    want_x, want_w = jax.grad(
        lambda a, b: jnp.sum(jnp.real(contract_dhconv_pallas(a, b, True) * jnp.conj(cot))),
        argnums=(0, 1))(jx, jw)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    (contract_dhconv_kernel(tx, tw, passes) * torch.from_numpy(cot).conj()).real.sum().backward()
    assert _rel(tx.grad.numpy(), np.conj(want_x)) < tol
    assert _rel(tw.grad.numpy(), np.conj(want_w)) < tol


def test_wrappers_take_the_twin_on_cpu_without_counting():
    rng = np.random.RandomState(26)
    x, w = torch.from_numpy(_cplx(rng, 2, 4, 3, 9)), torch.from_numpy(_cplx(rng, 4, 5, 3))
    before = dict(kernels.launches)
    assert torch.equal(contract_dhconv_raw(x, w), contract_dhconv_plain(x, w))
    assert torch.equal(contract_dhconv_kernel(x, w, 3), contract_dhconv_plain(x, w))
    tcomplex.enable_pallas_kernels(True)
    assert torch.equal(tcomplex.contract_dhconv(x, w), contract_dhconv_plain(x, w))
    assert kernels.launches == before
    # a lazily conjugated weight is read as its values
    assert torch.equal(contract_dhconv_raw(x, w.conj()),
                       contract_dhconv_plain(x, w.conj().resolve_conj()))
    for fn in (contract_dhconv_raw, contract_dhconv_plain):
        with pytest.raises(RuntimeError, match="contract_dhconv_kernel"):
            fn(x.clone().requires_grad_(), w)
    with pytest.raises(ValueError):
        contract_dhconv_raw(x, w[:, :, :2])
    with pytest.raises(ValueError):
        contract_dhconv_raw(x, w, passes=2)
    with pytest.raises(TypeError):
        contract_dhconv_raw(x.real.contiguous(), w)


# --------------------------------------------------------------------------
# the SHT's complex path
# --------------------------------------------------------------------------

# the model's full grid (modes truncated to the inner grid's) and its inner grid
SHT_GRIDS = [("equiangular", 25, 48, 12, 13), ("legendre-gauss", 12, 24, 12, 13)]


@pytest.mark.parametrize("precision", ["high", "highest", "default"])
@pytest.mark.parametrize("grid,nlat,nlon,lmax,mmax", SHT_GRIDS)
def test_sht_complex_path_matches_jax(grid, nlat, nlon, lmax, mmax, precision):
    rng = np.random.RandomState(27)
    x = rng.randn(2, 3, nlat, nlon).astype(np.float32)
    c = _cplx(rng, 2, 3, lmax, mmax)
    _set_precision(precision)
    tsht.set_coeff_engine("xla")
    want_a = np.asarray(jsht.RealSHT(nlat, nlon, lmax, mmax, grid=grid)(jnp.asarray(x)))
    want_s = np.asarray(jsht.InverseRealSHT(nlat, nlon, lmax, mmax, grid=grid)(jnp.asarray(c)))
    fwd = tsht.RealSHT(nlat, nlon, lmax, mmax, grid=grid)
    inv = tsht.InverseRealSHT(nlat, nlon, lmax, mmax, grid=grid)
    got_a, got_s = fwd(torch.from_numpy(x)), inv(torch.from_numpy(c))
    assert got_a.dtype == torch.complex64 and got_a.shape == want_a.shape == (2, 3, lmax, mmax)
    assert got_s.shape == want_s.shape == (2, 3, nlat, nlon)
    tol = P1_TOL if precision == "default" else F32_TOL
    assert _rel(got_a.numpy(), want_a) < tol
    assert _rel(got_s.numpy(), want_s) < tol
    if precision == "highest":
        # no kernel pass count: every engine takes the complex path
        tsht.set_coeff_engine("kernel")
        assert torch.equal(fwd(torch.from_numpy(x)), got_a)
        assert torch.equal(inv(torch.from_numpy(c)), got_s)


# --------------------------------------------------------------------------
# SpectralConv's complex branch
# --------------------------------------------------------------------------

CONV_CASES = [
    # operator, separable, kernel toggle, engine, precision
    ("dhconv", False, True, "xla", "high"),
    ("dhconv", False, False, "xla", "high"),
    ("dhconv", False, False, "kernel", "highest"),
    ("diagonal", False, False, "xla", "high"),
    ("diagonal", False, False, "kernel", "high"),
    ("dhconv", True, False, "xla", "high"),
    ("diagonal", True, False, "xla", "high"),
]


@pytest.mark.parametrize("scale_residual", [False, True])
@pytest.mark.parametrize("op,separable,toggle,engine,precision", CONV_CASES)
def test_spectral_conv_complex_branch_matches_jax(op, separable, toggle, engine, precision,
                                                  scale_residual):
    """Weights carried by load_jax_params into a module holding the filter
    under its SFNO name, so every variant goes through the layout map."""
    from makani_tpu.models.common.spectral_convolution import SpectralConv as JConv
    from makani_tpu_torch.models.common.spectral_convolution import SpectralConv as TConv

    nlat, nlon, lmax, mmax = 20, 48, 10, 13
    onlat, onlon = (12, 26) if scale_residual else (nlat, nlon)
    c, o = 6, 6 if separable else 5
    rng = np.random.RandomState(28)
    x = rng.randn(2, c, nlat, nlon).astype(np.float32)
    _set_precision(precision)
    tsht.set_coeff_engine(engine)
    tcomplex.enable_pallas_kernels(toggle)

    def pair(mod):
        return (mod.RealSHT(nlat, nlon, lmax, mmax, grid="legendre-gauss"),
                mod.InverseRealSHT(onlat, onlon, lmax, mmax, grid="legendre-gauss"))

    jconv = JConv(*pair(jsht), in_channels=c, out_channels=o, operator_type=op,
                  separable=separable, bias="constant")
    shapes = jax.eval_shape(jconv.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    w = rng.randn(*shapes["weight"].shape).astype(np.float32)
    b = rng.randn(1, o, 1, 1).astype(np.float32)
    jout, jres = jconv.apply({"params": {"weight": jnp.asarray(w), "bias_const": jnp.asarray(b)}},
                             jnp.asarray(x))

    tconv = TConv(*pair(tsht), c, o, operator_type=op, separable=separable, bias="constant")
    key = "filter_layer.filter.weight"
    assert tuple(tconv.weight.shape) == to_port_layout(key, w, tconv.weight.shape).shape
    holder = nn.Module()
    holder.filter_layer = nn.Module()
    holder.filter_layer.filter = tconv
    load_jax_params(holder, {"SpectralFilterLayer_0/filter/weight": w,
                             "SpectralFilterLayer_0/filter/bias_const": b})
    np.testing.assert_array_equal(tconv.complex_weight().detach().numpy(),
                                  w[..., 0] + 1j * w[..., 1])
    with torch.no_grad():
        tout, tres = tconv(torch.from_numpy(x))
    assert tout.shape == (2, o, onlat, onlon) and tres.shape == (2, c, onlat, onlon)
    tol = P3_TOL if toggle or (engine == "kernel" and precision != "highest") else F32_TOL
    assert _rel(tout.numpy(), jout) < tol
    assert _rel(tres.numpy(), jres) < tol


@pytest.mark.parametrize("shape", [(5, 4, 2), (5, 3, 4, 6, 2), (5, 4, 6, 2)],
                         ids=["dhconv-separable", "diagonal", "diagonal-separable"])
def test_fused_adam_bitwise_on_new_filter_leaves(shape):
    """The port keeps makani_tpu's layout for these filter weights, so the
    stochastic-rounding dither indexes them as makani_tpu does: the fused
    Adam twin stays bit-identical over 3 steps (bf16 moments)."""
    from makani_tpu.ops.pallas_adam import fused_adam_apply as jfused_adam_apply
    from makani_tpu.utils import optimizers as jopt
    from makani_tpu_torch.ops.fused_adam import fused_adam_apply_plain
    from makani_tpu_torch.utils import optimizers as topt

    key = "model/blocks_0/SpectralFilterLayer_0/filter/weight"
    tkey = jax_key_to_torch(key)

    def tree(seed, scale=1.0):
        rng = np.random.RandomState(seed)
        return {"a": (rng.randn(7) * scale).astype(np.float32),
                "model": {"blocks_0": {"SpectralFilterLayer_0": {"filter": {
                    "weight": (rng.randn(*shape) * scale).astype(np.float32)}}}}}

    def port(t):
        flat = flatten_dict(t, sep="/")
        out = {jax_key_to_torch(k): torch.from_numpy(np.array(v)) for k, v in flat.items()}
        assert to_port_layout(tkey, flat[key], shape).shape == shape
        return out

    kw = dict(b1=0.9, b2=0.95, eps=1e-8)
    jp = jax.tree.map(jnp.asarray, tree(0))
    js = jax.jit(jopt.scale_by_adam_lowmem(moment_dtype=jnp.bfloat16, seed=340, **kw).init)(jp)
    jstep = jax.jit(lambda p, st, g: jfused_adam_apply(p, g, st, 1e-3, seed=340, **kw))
    tp = port(tree(0))
    ts = topt.scale_by_adam_lowmem(moment_dtype=torch.bfloat16, seed=340, **kw).init(tp)
    for it in range(3):
        grads = tree(100 + it, scale=0.1)
        jp, js = jstep(jp, js, jax.tree.map(jnp.asarray, grads))
        fused_adam_apply_plain(tp, port(grads), ts, 1e-3, seed=340, **kw)
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        want = {jax_key_to_torch(k): np.asarray(v, np.float32)
                for k, v in flatten_dict(want, sep="/").items()}
        for k, v in got.items():
            np.testing.assert_array_equal(v.float().numpy(), want[k], err_msg=k)


def test_spectral_conv_refuses_ambiguous_layout():
    from makani_tpu_torch.models.common.spectral_convolution import SpectralConv as TConv
    pair = (tsht.RealSHT(8, 16, 4, 5), tsht.InverseRealSHT(8, 16, 4, 5))
    with pytest.raises(ValueError, match="in_channels"):
        TConv(*pair, 2, 2, operator_type="diagonal", separable=True)
    with pytest.raises(ValueError):
        TConv(*pair, 3, 3, operator_type="l-dependant")


# --------------------------------------------------------------------------
# a 3-block SFNO on the complex engine, the kernel toggle on
# --------------------------------------------------------------------------

def _configs(**overrides):
    """Matching (JAX, port) params of a small flagship-shaped SFNO training on
    the synthetic data with coefficient_engine "xla"."""
    common = dict(img_shape_x=NLAT, img_shape_y=NLON, embed_dim=16, num_layers=3,
                  scale_factor=2, enable_synthetic_data=True, n_train_samples_per_epoch=3,
                  n_eval_samples=1, skip_validation=True, save_checkpoint="none",
                  optimizer_fused=True, max_epochs=1, num_data_workers=1, log_to_screen=False,
                  in_channels=list(range(CHANS)), out_channels=list(range(CHANS)),
                  channel_names=[f"c{i}" for i in range(CHANS)], batch_size=1, dhours=6,
                  coefficient_engine="xla")
    common.update(overrides)
    tp = TYParams("config/sfnonet.yaml", "flagship_synth_drive_bare")
    jp = JYParams("config/sfnonet.yaml", "flagship_synth_drive_bare")
    for p in (tp, jp):
        p.update_params(common)
    tregistry.update_channel_params(tp)
    jp.update_params({k: v for k, v in tp.to_dict().items() if k not in jp.to_dict()})
    return jp, tp


@pytest.fixture(scope="module")
def jax_trainer():
    from makani_tpu.parallel import comm
    from makani_tpu.utils.trainer import Trainer as JTrainer
    comm.reset()
    comm.init(devices=jax.devices()[:1])
    jp, tp = _configs()
    trainer = JTrainer(jp, world_rank=0)
    _defaults()
    flat = {k: np.asarray(v) for k, v in flatten_dict(trainer.model_params, sep="/").items()}
    yield trainer, tp, flat
    comm.reset()


def _port_trainer(tp, flat, **kw):
    from makani_tpu_torch.utils.trainer import Trainer
    trainer = Trainer(tp, device="cpu", **kw)
    load_jax_params(trainer.model, flat)
    tcomplex.enable_pallas_kernels(True)
    return trainer


def _as_port(tree):
    return {jax_key_to_torch(k): to_port_layout(jax_key_to_torch(k), np.asarray(v, np.float32))
            for k, v in flatten_dict(tree, sep="/").items()}


def _xla_engine_with_kernel():
    tsht.set_coeff_engine("xla")
    tcomplex.enable_pallas_kernels(True)


def test_sfno_forward_matches_jax(jax_trainer):
    jtrainer, tp, flat = jax_trainer
    _xla_engine_with_kernel()
    model = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    x = np.random.RandomState(30).randn(2, CHANS, NLAT, NLON).astype(np.float32)
    jmodel = jtrainer.model
    want = np.asarray(jax.jit(lambda p, a: jmodel.apply({"params": p}, a, deterministic=True))(
        jtrainer.model_params, jnp.asarray(x)))
    before = dict(kernels.launches)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert kernels.launches == before  # the CPU runs the twin
    assert got.shape == want.shape == (2, CHANS, NLAT, NLON)
    assert _rel(got, want) < MODEL_TOL


def test_lite_rollout_matches_jax(jax_trainer):
    from makani_tpu.utils.inferencer import Inferencer as JInferencer
    from makani_tpu_torch.utils.inferencer import Inferencer
    jtrainer, tp, flat = jax_trainer
    tp = TYParams.from_dict(dict(tp.to_dict(), valid_autoreg_steps=2))
    x = np.random.RandomState(31).randn(1, 1, CHANS, NLAT, NLON).astype(np.float32)

    jp = jtrainer.params
    steps = jp["valid_autoreg_steps"]
    jp["valid_autoreg_steps"] = 2
    try:
        jinf = JInferencer.__new__(JInferencer)
        jinf.params, jinf.model = jp, jtrainer.model
        jinf.preprocessor = jtrainer.model.preprocessor
        jinf.loss_obj = jinf.metrics = jinf.amp_dtype = None
        jinf.data_parallel_size = 1
        jinf.sst_persistence_channels = ()
        jinf._build_inference_steps()
        want = jinf._rollout_lite(jtrainer.model_params, jnp.asarray(x), None, None)
    finally:
        jp["valid_autoreg_steps"] = steps

    _xla_engine_with_kernel()
    inf = Inferencer(tp, device="cpu")
    load_jax_params(inf.model, flat)
    # the Inferencer leaves the engine, the precisions and the toggle as set
    assert tsht.get_coeff_engine() == "xla" and tcomplex._USE_PALLAS_DHCONV
    got = inf._rollout_lite(x)
    assert got.shape == want.shape == (3, 1, CHANS, NLAT, NLON)
    for step in range(3):
        assert _rel(got[step], want[step]) < MODEL_TOL, step


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_sfno_gradients_match_jax(jax_trainer, precision):
    """makani_tpu's value_and_grad step (its CPU dots exact whatever the
    precision) against the port's backward: through the kernel's twin under
    "high", in float32 throughout under "highest"."""
    jtrainer, tp, flat = jax_trainer
    inp, tar = (x[None] for x in jtrainer.train_dataset[0])
    jloss, jgrads = jtrainer._grad_step(jtrainer.model_params, jnp.asarray(inp),
                                        jnp.asarray(tar), None, None)
    trainer = _port_trainer(TYParams.from_dict(dict(tp.to_dict(), transform_precision=precision)),
                            flat)
    assert tsht.get_coeff_engine() == "xla"
    assert tsht.get_transform_precision() == precision
    assert tcomplex.get_contraction_precision() == precision
    loss, grads = trainer.loss_and_grads(torch.from_numpy(inp), torch.from_numpy(tar))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_TOL)
    want = _as_port(jgrads)
    assert set(grads) == set(want)
    largest = max(np.abs(w).max() for w in want.values())
    for k, g in grads.items():
        scale = largest if k.endswith(ZERO_GRAD) else np.abs(want[k]).max()
        err = np.abs(g.numpy().astype(np.float64) - want[k]).max() / scale
        assert err < MODEL_TOL, (k, err)


def test_trainer_steps_match_jax(jax_trainer):
    """Three steps of the port's Trainer (complex engine, kernel twin, fused
    Adam twin) against makani_tpu's Trainer with coefficient_engine "xla", on
    the same synthetic batches, from the same weights and optimizer state."""
    jtrainer, tp, flat = jax_trainer
    trainer = _port_trainer(tp, flat)
    flat_state = {"count": int(jtrainer.opt_state[0].count),
                  **{n: {k: np.asarray(v, np.float32) for k, v in
                         flatten_dict(getattr(jtrainer.opt_state[0], n), sep="/").items()}
                     for n in ("mu", "nu")}}
    load_jax_opt_state(trainer.opt_state[0], trainer.model, flat_state)
    start = {k: p.detach().clone() for k, p in trainer.model_params.items()}
    jstart = _as_port(jtrainer.model_params)

    jparams, jstate = jax.tree.map(jnp.copy, (jtrainer.model_params, jtrainer.opt_state))
    for step, (tbatch, jbatch) in enumerate(zip(trainer.train_dataloader,
                                                jtrainer.train_dataloader), start=1):
        lr = trainer.scheduler(step)
        if step == 1:
            _, g1 = trainer.loss_and_grads(*trainer._device_batch(tbatch))
            determined = {k: np.abs(g.numpy()) >= SIGN_FLOOR * np.abs(g.numpy()).max()
                          for k, g in g1.items()}
        loss = trainer.train_step(*trainer._device_batch(tbatch), lr)
        jinp, jtar, jzi, jzt = jtrainer._device_batch(jbatch)
        jparams, jstate, jloss = jtrainer.train_step(
            jparams, jstate, jinp, jtar, jzi, jzt, jnp.float32(lr),
            jax.random.fold_in(jtrainer.dropout_key, step))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_TOL)
    want = _as_port(jparams)
    for k, p in trainer.model_params.items():
        du = p.detach().numpy() - start[k].numpy()
        assert np.isfinite(du).all(), k
        if k.endswith(ZERO_GRAD):
            continue  # Adam scales its rounding-noise gradient to full steps
        keep = determined[k]
        jdu = want[k] - jstart[k]
        assert (np.linalg.norm((du - jdu)[keep]) <= UPDATE_TOL * np.linalg.norm(jdu[keep])), k
    assert step == 3 and trainer.opt_state[0].count == int(jstate[0].count) == 3
