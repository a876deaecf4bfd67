"""makani_tpu_torch's non-linear spectral filter against makani_tpu on the CPU.

The complex activations (ComplexReLU in its four modes, ComplexActivation)
and a 3-block SFNO with the non-linear filter (SpectralAttention, operator
"diagonal" or "l-dependant", 3 spectral layers, as config/icml_models.yaml's
sfno_nonlinear_* set it) are initialized in JAX, carried into the port by
tools/convert_jax_params.load_jax_params, and fed the same numpy inputs:
the forward, the gradients of every parameter, and the 2-step training
unroll of MultiStepWrapper. Every dimension is distinct (16 channels on a
30x64 grid, 5 in and out, batch 2, hidden width 32, 15x17 modes). The
l-dependant variant also carries the layers' complex biases; the
activations' biases (modulus, halfplane) are held to the forward.

Tolerances:
  - the activations: bit for bit where the arithmetic is the same
    (cartesian, real, halfplane); the modulus forms round |z| and the complex
    product or exp(i*angle) in another order: ACT_TOL relative;
  - the SFNO: TOL (2e-4, tests/test_torch_port_model.py's) of the
    reference's largest magnitude for the forward and the unroll, and
    GRAD_TOL (test_sfno_gradients_match_jax's) of each leaf's largest
    gradient. JAX's CPU dots are exact float32 while the port's SHT keeps
    the 3-pass bf16 splits of its kernels' twins (~1e-5 a contraction).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from makani_tpu.models import model_registry as jregistry
from makani_tpu.models.common import activations as jact
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.models import model_registry as tregistry
from makani_tpu_torch.models.common import activations as tact
from makani_tpu_torch.tools.convert_jax_params import load_jax_params
from makani_tpu_torch.utils.yparams import YParams as TYParams

from test_torch_port_train import GRAD_TOL, ZERO_GRAD

TOL = 2e-4
ACT_TOL = 1e-6
NLAT, NLON, CHANS, EMBED = 30, 64, 5, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    dtype = np.complex128 if np.iscomplexobj(want) else np.float64
    got, want = np.asarray(got, dtype), np.asarray(want, dtype)
    return np.abs(got - want).max() / np.abs(want).max()


def _complex(seed, shape):
    rng = np.random.RandomState(seed)
    z = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    z.flat[:3] = [0.0, 1.0, -1.0j]  # the zero and the axes
    return z


# --------------------------------------------------------------------------
# the complex activations
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["cartesian", "modulus", "halfplane", "real"])
def test_complex_relu_matches_jax(mode):
    z = _complex(0, (2, 6, 5, 7))
    jmod = jact.ComplexReLU(negative_slope=0.1, mode=mode, bias_shape=(6, 1, 1), scale=0.3)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(z))
    if mode in ("modulus", "halfplane"):
        # a bias of both signs: modulus zeroes |z| < -bias, halfplane turns the sector
        bias = np.linspace(-0.8, 0.8, 6).astype(np.float32).reshape(6, 1, 1)
        variables = {"params": {"bias": jnp.asarray(bias)}}
    want = np.asarray(jmod.apply(variables, jnp.asarray(z)))
    tmod = tact.ComplexReLU(negative_slope=0.1, mode=mode, bias_shape=(6, 1, 1), scale=0.3)
    assert [n for n, _ in tmod.named_parameters()] == list(variables.get("params", {}))
    if mode in ("modulus", "halfplane"):
        with torch.no_grad():
            tmod.bias.copy_(torch.from_numpy(np.array(variables["params"]["bias"])))
    zt = torch.from_numpy(z).requires_grad_()
    got = tmod(zt)
    assert got.dtype == torch.complex64 and got.shape == zt.shape
    if mode == "modulus":
        assert _rel(got.detach().numpy(), want) < ACT_TOL
        assert (got.detach().numpy() == 0).sum() == (want == 0).sum() > 0
    else:
        np.testing.assert_array_equal(got.detach().numpy(), want)
    torch.view_as_real(got).sum().backward()
    # |z| has no derivative at the zero, in JAX as here
    assert torch.isfinite(torch.view_as_real(zt.grad).flatten()[2:]).all()


@pytest.mark.parametrize("mode", ["cartesian", "modulus", "identity"])
def test_complex_activation_matches_jax(mode):
    z = _complex(1, (2, 4, 3, 5))
    # relu: the same real arithmetic on both sides (jax.nn.gelu and PyTorch's
    # tanh form differ by ulps, tests/test_torch_port_amp.py)
    jmod = jact.ComplexActivation(activation=jax.nn.relu, mode=mode, bias_shape=(4, 1, 1))
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(z))
    want = np.asarray(jmod.apply(variables, jnp.asarray(z)))
    tmod = tact.ComplexActivation(tact.get_activation("relu"), mode=mode, bias_shape=(4, 1, 1))
    assert [n for n, _ in tmod.named_parameters()] == list(variables.get("params", {}))
    with torch.no_grad():
        got = tmod(torch.from_numpy(z)).numpy()
    if mode == "modulus":
        assert _rel(got, want) < ACT_TOL
    else:
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the non-linear SFNO
# --------------------------------------------------------------------------

def _configs(operator, **overrides):
    """Matching (JAX, port) params of a 3-block non-linear SFNO."""
    out = []
    for cls in (TYParams, JYParams):
        p = cls("config/sfnonet.yaml", "flagship_synth_drive_bare")
        p.update_params(dict(img_shape_x=NLAT, img_shape_y=NLON, embed_dim=EMBED, num_layers=3,
                             scale_factor=2, hard_thresholding_fraction=1.0,
                             filter_type="non-linear", operator_type=operator,
                             spectral_layers=3, enable_synthetic_data=True, **overrides))
        out.append(p)
    tp, jp = out
    tregistry.update_channel_params(tp, n_channels=CHANS)
    jp.update_params({k: v for k, v in tp.to_dict().items() if k not in jp.to_dict()})
    return jp, tp


def _matched(operator, **overrides):
    jp, tp = _configs(operator, **overrides)
    jmodel = jregistry.get_model(jp)
    v = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, CHANS, NLAT, NLON)),
                                      deterministic=True))(jax.random.PRNGKey(3))
    flat = {k: np.asarray(a) for k, a in flatten_dict(v["params"], sep="/").items()}
    tmodel = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    return jmodel, v["params"], tmodel, flat


# the ICML models' filter (diagonal, "real" activation, no bias), and the
# l-dependant one with the layers' complex biases
VARIANTS = {"diagonal": {}, "l-dependant": dict(bias=True)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def matched(request):
    return (request.param, *_matched(request.param, **VARIANTS[request.param]))


def _inputs(seed, chans=CHANS, batch=2):
    return np.random.RandomState(seed).randn(batch, chans, NLAT, NLON).astype(np.float32)


def test_nonlinear_parameters_carry_over(matched):
    operator, _, _, tmodel, flat = matched
    filt = "model/blocks_1/SpectralFilterLayer_0/filter/"
    lead = (15,) if operator == "l-dependant" else ()
    assert flat[filt + "w_0"].shape == (*lead, EMBED, 2 * EMBED, 2)
    assert flat[filt + "w_2"].shape == (*lead, 2 * EMBED, 2 * EMBED, 2)
    assert flat[filt + "wout"].shape == (*lead, 2 * EMBED, EMBED, 2)
    if operator == "l-dependant":
        assert flat[filt + "b_1"].shape == (2 * EMBED, 1, 1, 2)
    else:
        assert not any("/b_" in k for k in flat)
    assert not any("act_" in k for k in flat)  # the "real" activation has no bias
    named = dict(tmodel.named_parameters())
    np.testing.assert_array_equal(named["model.blocks.1.filter_layer.filter.w_1"].detach(),
                                  flat[filt + "w_1"])
    assert not any(k.endswith("filter.weight") for k in named)


def test_nonlinear_sfno_forward_matches_jax(matched):
    _, jmodel, jparams, tmodel, _ = matched
    x = _inputs(5)
    want = np.asarray(jax.jit(lambda p, v: jmodel.apply({"params": p}, v, deterministic=True))(
        jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, CHANS, NLAT, NLON)
    assert _rel(got, want) < TOL


def test_nonlinear_sfno_activation_biases_forward():
    """An activation that holds a bias (act_<l>/bias, (hidden, 1, 1)) carries
    over and gives makani_tpu's forward. The modulus form's gradient is not
    compared: its derivative holds bias / |z|, which turns the rounding of
    coefficients near zero into large differences (and NaN at an exact zero,
    in JAX as here). halfplane is left to test_complex_relu_matches_jax: it
    cuts at angle 0, where the m = 0 coefficients lie (real in JAX, within a
    rounding of the axis here)."""
    jmodel, jparams, tmodel, flat = _matched("diagonal", complex_activation="modulus")
    assert flat["model/blocks_2/SpectralFilterLayer_0/filter/act_1/bias"].shape == (2 * EMBED, 1, 1)
    x = _inputs(11)
    want = np.asarray(jax.jit(lambda p, v: jmodel.apply({"params": p}, v, deterministic=True))(
        jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < TOL


def _jax_grads(jmodel, jparams, x, r, **kw):
    def loss(p):
        y = jmodel.apply({"params": p}, jnp.asarray(x), **kw)
        return jnp.sum(y * jnp.asarray(r))
    value, grads = jax.jit(jax.value_and_grad(loss))(jparams)
    return float(value), {k: np.asarray(g) for k, g in flatten_dict(grads, sep="/").items()}


def _assert_grads_close(tmodel, want):
    """Each leaf within GRAD_TOL of its largest gradient; the MLP's output
    bias, which the instance norm after it removes (its exact gradient is
    zero, both sides hold rounding noise), against the largest of all."""
    from makani_tpu_torch.utils.param_layout import jax_key_to_torch
    got = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    assert set(got) == {jax_key_to_torch(k) for k in want}
    largest = max(np.abs(g).max() for g in want.values())
    for k, g in want.items():
        tk = jax_key_to_torch(k)
        scale = largest if tk.endswith(ZERO_GRAD) else np.abs(g).max()
        assert np.abs(got[tk].astype(np.float64) - g).max() / scale < GRAD_TOL, k


def test_nonlinear_sfno_gradients_match_jax(matched):
    _, jmodel, jparams, tmodel, _ = matched
    x, r = _inputs(6), _inputs(7)
    jloss, want = _jax_grads(jmodel, jparams, x, r, deterministic=True)
    tmodel.zero_grad(set_to_none=True)
    loss = (tmodel(torch.from_numpy(x)) * torch.from_numpy(r)).sum()
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= TOL * abs(jloss)
    _assert_grads_close(tmodel, want)


def test_nonlinear_two_step_unroll_matches_jax(matched):
    """MultiStepWrapper at n_future 1 in training: two steps, the second on
    the first's prediction, concatenated along channels."""
    operator, _, _, _, flat = matched
    jp, tp = _configs(operator, n_future=1, **VARIANTS[operator])
    jmodel = jregistry.get_model(jp)
    jparams = jax.tree.map(jnp.asarray, _unflatten(flat))
    tmodel = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    assert type(tmodel).__name__ == "MultiStepWrapper"
    x, r = _inputs(8), np.concatenate([_inputs(9), _inputs(10)], axis=1)
    want = np.asarray(jax.jit(lambda p, v: jmodel.apply({"params": p}, v, deterministic=False))(
        jparams, jnp.asarray(x)))
    jloss, jgrads = _jax_grads(jmodel, jparams, x, r, deterministic=False)
    tmodel.zero_grad(set_to_none=True)
    y = tmodel(torch.from_numpy(x), deterministic=False)
    assert y.shape == want.shape == (2, 2 * CHANS, NLAT, NLON)
    assert _rel(y.detach().numpy(), want) < TOL
    loss = (y * torch.from_numpy(r)).sum()
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= TOL * abs(jloss)
    _assert_grads_close(tmodel, jgrads)


def _unflatten(flat):
    from flax.traverse_util import unflatten_dict
    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
