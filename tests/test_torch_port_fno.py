"""makani_tpu_torch's planar FNO against makani_tpu on the CPU.

The truncated FFT pair (ops/fft.py) against makani_tpu/ops/fft.py on odd
and even latitude counts, truncated and not; and config/icml_models.yaml's
fno_linear_73ch (the diagonal linear filter on FFT coefficients) and
fno_nonlinear_73ch (SpectralAttention on them), cut small: a 17x32 grid at
scale factor 2 to 8x16, hard thresholding 0.5, so that the two-sided
latitude truncation keeps 2 + 2 of 17 rows at the input and 2 + 2 of 8
inside, embed 12, 3 blocks, 5 channels, batch 2. Weights are made in JAX
and carried by load_jax_params; inputs come from numpy seeds. The forward,
the gradients of every parameter and the 2-step training unroll are
compared, and a model package of an FNO is rebuilt by load_model_package.

Tolerances:
  - the FFT pair: FFT_TOL (1e-5) of the largest magnitude. Both sides are
    float32 FFTs (ducc in XLA, pocketfft in PyTorch) that sum in other
    orders: a few ulps of the largest coefficient;
  - the FNO: test_sfno_gradients_match_jax's (TOL 2e-4 of the largest
    output, GRAD_TOL 2e-4 of each leaf's largest gradient, the MLP's output
    bias against the largest of all); the loss sum(y * r), whose terms
    cancel, TOL of the sum of their magnitudes. Nothing here rounds to
    bf16: the FFTs and the complex contractions are float32 on both sides,
    and the deviations found are ~1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from makani_tpu.models import model_registry as jregistry
from makani_tpu.ops import fft as jfft
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.models import model_registry as tregistry
from makani_tpu_torch.ops import fft as tfft
from makani_tpu_torch.tools.convert_jax_params import load_jax_params
from makani_tpu_torch.utils.param_layout import jax_key_to_torch
from makani_tpu_torch.utils.yparams import YParams as TYParams

from test_torch_port_train import GRAD_TOL, ZERO_GRAD

TOL = 2e-4
FFT_TOL = 1e-5
NLAT, NLON, CHANS, EMBED, LAYERS = 17, 32, 5, 12, 3


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


# --------------------------------------------------------------------------
# the truncated FFT pair
# --------------------------------------------------------------------------

# (nlat, nlon, lmax, mmax): odd and even nlat, untruncated, truncated in
# both axes (odd and even lmax), in the latitude alone
FFT_CASES = [(17, 32, None, None), (17, 32, 5, 4), (16, 30, 6, 7), (16, 30, 9, None)]


@pytest.mark.parametrize("nlat,nlon,lmax,mmax", FFT_CASES)
def test_fft_pair_matches_jax(nlat, nlon, lmax, mmax):
    rng = np.random.RandomState(nlat + nlon)
    x = rng.randn(2, 3, nlat, nlon).astype(np.float32)
    fwd, inv = tfft.RealFFT2(nlat, nlon, lmax, mmax), tfft.InverseRealFFT2(nlat, nlon, lmax, mmax)
    jfwd, jinv = jfft.RealFFT2(nlat, nlon, lmax, mmax), jfft.InverseRealFFT2(nlat, nlon, lmax, mmax)
    assert (fwd.lmax, fwd.mmax, fwd.lmax_high, fwd.lmax_low, fwd.truncate) == (
        jfwd.lmax, jfwd.mmax, jfwd.lmax_high, jfwd.lmax_low, jfwd.truncate)
    want = np.asarray(jax.jit(jfwd.__call__)(jnp.asarray(x)))
    got = fwd(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == want.shape == (2, 3, fwd.lmax, fwd.mmax)
    assert _rel(got.numpy(), want) < FFT_TOL
    # the inverse of the same coefficients, and of the bf16 AMP input's cast
    c = (rng.randn(*want.shape) + 1j * rng.randn(*want.shape)).astype(np.complex64)
    want_x = np.asarray(jax.jit(jinv.__call__)(jnp.asarray(c)))
    got_x = inv(torch.from_numpy(c))
    assert got_x.dtype == torch.float32 and got_x.shape == want_x.shape == (2, 3, nlat, nlon)
    assert _rel(got_x.numpy(), want_x) < FFT_TOL
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(fwd(xb), fwd(xb.float()))


# --------------------------------------------------------------------------
# the ICML FNO recipes, cut small
# --------------------------------------------------------------------------

def _configs(name, **overrides):
    """Matching (JAX, port) params of config/icml_models.yaml's `name`, cut
    small."""
    out = []
    for cls in (TYParams, JYParams):
        p = cls("config/icml_models.yaml", name)
        p.update_params(dict(dict(img_shape_x=NLAT, img_shape_y=NLON, embed_dim=EMBED,
                                  num_layers=LAYERS, enable_synthetic_data=True), **overrides))
        out.append(p)
    tp, jp = out
    tregistry.update_channel_params(tp, n_channels=CHANS)
    jp.update_params({k: v for k, v in tp.to_dict().items() if k not in jp.to_dict()})
    return jp, tp


def matched_models(yaml_name, seed=3, **overrides):
    """(JAX model, its params, the port's model with the same weights, the
    flattened weights)."""
    jp, tp = _configs(yaml_name, **overrides)
    jmodel = jregistry.get_model(jp)
    v = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, CHANS, NLAT, NLON)),
                                      deterministic=True))(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(a) for k, a in flatten_dict(v["params"], sep="/").items()}
    tmodel = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    return jmodel, v["params"], tmodel, flat


def inputs(seed, chans=CHANS, batch=2):
    return np.random.RandomState(seed).randn(batch, chans, NLAT, NLON).astype(np.float32)


def jax_output_and_grads(jmodel, jparams, x, r, **kw):
    """makani_tpu's output, and the loss sum(y * r) with its gradients, in
    one compiled program."""
    def fwd(p):
        return jmodel.apply({"params": p}, jnp.asarray(x), **kw)

    @jax.jit
    def run(p):
        y, vjp = jax.vjp(fwd, p)
        return y, jnp.sum(y * jnp.asarray(r)), vjp(jnp.asarray(r))[0]
    y, loss, grads = run(jparams)
    return (np.asarray(y), float(loss),
            {k: np.asarray(g) for k, g in flatten_dict(grads, sep="/").items()})


def port_output_and_grads(tmodel, x, r, **kw):
    tmodel.zero_grad(set_to_none=True)
    y = tmodel(torch.from_numpy(x), **kw)
    loss = (y * torch.from_numpy(r)).sum()
    loss.backward()
    return y.detach().numpy(), float(loss.detach())


def assert_loss_close(loss, jloss, y, r):
    """The loss sum(y * r) within TOL of the sum of its terms' magnitudes
    (the bound the outputs' TOL gives a sum that cancels)."""
    assert abs(loss - jloss) <= TOL * float(np.abs(np.asarray(y, np.float64) * r).sum())


def assert_grads_close(tmodel, want):
    """Each leaf within GRAD_TOL of its largest gradient; the MLP's output
    bias, which the norm after it removes (its exact gradient is zero, both
    sides hold rounding noise), against the largest of all."""
    from makani_tpu_torch.utils.param_layout import to_port_layout
    got = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    assert set(got) == {jax_key_to_torch(k) for k in want}
    largest = max(np.abs(g).max() for g in want.values())
    for k, g in want.items():
        tk = jax_key_to_torch(k)
        gt = to_port_layout(tk, g, got[tk].shape)
        scale = largest if tk.endswith(ZERO_GRAD) else np.abs(g).max()
        assert np.abs(got[tk].astype(np.float64) - gt).max() / scale < GRAD_TOL, k


RECIPES = ["fno_linear_73ch", "fno_nonlinear_73ch"]


@pytest.fixture(scope="module", params=RECIPES)
def matched(request):
    return (request.param, *matched_models(request.param))


def test_fno_builds_on_the_fft_pair(matched):
    name, _, _, tmodel, flat = matched
    net = tmodel.model
    assert type(net).__name__ == "FourierNeuralOperatorNet"
    assert type(net.trans_down).__name__ == "RealFFT2"
    assert type(net.blocks[1].filter_layer.filter.forward_transform).__name__ == "RealFFT2"
    # 17x32 input, 8x16 inside: 4 latitude modes (2 + 2 rows) and 4 of 9 longitudes
    assert (net.trans_down.lmax, net.trans_down.mmax, net.trans_down.truncate) == (4, 4, True)
    filt = "model/blocks_1/SpectralFilterLayer_0/filter/"
    if name == "fno_linear_73ch":
        # the diagonal weight keeps makani_tpu's (C, O, L, M, 2)
        assert flat[filt + "weight"].shape == (EMBED, EMBED, 4, 4, 2)
        np.testing.assert_array_equal(
            dict(tmodel.named_parameters())["model.blocks.1.filter_layer.filter.weight"].detach(),
            flat[filt + "weight"])
    else:
        assert flat[filt + "w_0"].shape == (EMBED, 2 * EMBED, 2)


def test_fno_forward_and_gradients_match_jax(matched):
    _, jmodel, jparams, tmodel, _ = matched
    x, r = inputs(5), inputs(6)
    want, jloss, jgrads = jax_output_and_grads(jmodel, jparams, x, r, deterministic=True)
    got, loss = port_output_and_grads(tmodel, x, r)
    assert got.shape == want.shape == (2, CHANS, NLAT, NLON)
    assert _rel(got, want) < TOL
    assert_loss_close(loss, jloss, want, r)
    assert_grads_close(tmodel, jgrads)


def test_fno_two_step_unroll_matches_jax(matched):
    """MultiStepWrapper at n_future 1 in training: two steps, the second on
    the first's prediction, concatenated along channels."""
    name, _, _, _, flat = matched
    jp, tp = _configs(name, n_future=1)
    jmodel = jregistry.get_model(jp)
    jparams = jax.tree.map(jnp.asarray, unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()}))
    tmodel = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    assert type(tmodel).__name__ == "MultiStepWrapper"
    x, r = inputs(8), np.concatenate([inputs(9), inputs(10)], axis=1)
    want, jloss, jgrads = jax_output_and_grads(jmodel, jparams, x, r, deterministic=False)
    got, loss = port_output_and_grads(tmodel, x, r, deterministic=False)
    assert got.shape == want.shape == (2, 2 * CHANS, NLAT, NLON)
    assert _rel(got, want) < TOL
    assert_loss_close(loss, jloss, want, r)
    assert_grads_close(tmodel, jgrads)


def test_fno_model_package_round_trip(matched, tmp_path):
    """A package of the FNO (config.json, best_ckpt in the port's format)
    rebuilds the FNO through load_model_package, with the same output bit
    for bit."""
    from makani_tpu_torch.models.model_package import (
        MODEL_PACKAGE_CHECKPOINT_PATH,
        load_model_package,
        save_model_package,
    )
    from makani_tpu_torch.utils.checkpoint import save_checkpoint
    name, _, _, tmodel, _ = matched
    _, tp = _configs(name, experiment_dir=str(tmp_path))
    save_model_package(tp)
    save_checkpoint(str(tmp_path / MODEL_PACKAGE_CHECKPOINT_PATH), tmodel.state_dict())
    wrapper = load_model_package(str(tmp_path), device="cpu")
    assert type(wrapper.model.model).__name__ == "FourierNeuralOperatorNet"
    x = inputs(11)
    with torch.inference_mode():
        want = tmodel(torch.from_numpy(x))
    assert torch.equal(wrapper(x, None), want)
