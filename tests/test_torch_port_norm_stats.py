"""InstanceNorm2d's "bf16" statistics mode of makani_tpu_torch against
makani_tpu's on the CPU.

makani_tpu's `set_norm_stats_mode("bf16")` (makani_tpu/models/common/
layers.py:160-210) gives a non-float32 input one-pass statistics accumulated
in float32, max(E[x^2] - E[x]^2, 0) with x * x rounded in bf16, and runs the
normalization and the affine in bf16; "f32" is the default. makani_tpu's
programs are compiled without excess precision (ROUND_EVERY_OP), so XLA
rounds where the dtypes say, as the port does.

Tolerances:
  - the forward, bit for bit (the same roundings in the same order);
  - the input's gradient within 2 bf16 ulps of its largest magnitude
    (2**-6 of it): the backward's sums over (H, W) run in bf16 in XLA and in
    float32 in PyTorch's autograd, so a few elements round the other way;
  - the affine's gradients: XLA sums the (B, H, W) products in bf16 steps,
    PyTorch in float32 with one rounding, so both are held to the exact
    float64 sum of the same bf16 products: the port's within a bf16 ulp of
    its largest (2**-8 relative, one rounding), and no farther from it than
    makani_tpu's;
  - makani_tpu's own gate (tests/test_pallas_adam.py:128), mirrored: "bf16"
    within 0.05 of "f32", mean and standard deviation of the output near 0
    and 1.
The spatially split "bf16" path is a case of tests/
test_torch_port_spatial_families.py's ranks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from makani_tpu.models.common import layers as jlayers
from makani_tpu_torch.models.common import layers as tlayers

ROUND_EVERY_OP = {"xla_allow_excess_precision": False}
SHAPE = (2, 5, 12, 20)


@pytest.fixture(autouse=True)
def _f32_after():
    """Both packages back at "f32" after every test."""
    yield
    jlayers.set_norm_stats_mode("f32")
    tlayers.set_norm_stats_mode("f32")


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*SHAPE) * 1.7 + 0.6).astype(np.float32)
    w = (1.0 + 0.3 * rng.randn(SHAPE[1])).astype(np.float32)
    b = (0.2 * rng.randn(SHAPE[1])).astype(np.float32)
    r = rng.randn(*SHAPE).astype(np.float32)
    return x, w, b, r


def _jax(x, w, b, r):
    """makani_tpu's bf16 output and the gradients of sum(y * r) (x, weight,
    bias) on bf16 x and r."""
    m = jlayers.InstanceNorm2d(num_features=SHAPE[1])
    v = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}}
    xb, rb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, r))

    def loss(v, a):
        return jnp.sum((m.apply(v, a) * rb).astype(jnp.float32))

    y = jax.jit(m.apply, compiler_options=ROUND_EVERY_OP)(v, xb)
    gv, gx = jax.jit(jax.grad(loss, argnums=(0, 1)), compiler_options=ROUND_EVERY_OP)(v, xb)
    return (y, np.asarray(gx.astype(jnp.float32)),
            np.asarray(gv["params"]["weight"]), np.asarray(gv["params"]["bias"]))


def _port(x, w, b, r):
    m = tlayers.InstanceNorm2d(SHAPE[1])
    m.weight.data, m.bias.data = torch.from_numpy(w), torch.from_numpy(b)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y = m(xt)
    (y * torch.from_numpy(r).to(torch.bfloat16)).float().sum().backward()
    return y.detach(), xt.grad.float().numpy(), m.weight.grad.numpy(), m.bias.grad.numpy()


def test_norm_stats_mode_defaults_to_f32_and_checks_its_argument():
    assert tlayers.get_norm_stats_mode() == "f32"
    with pytest.raises(ValueError, match="norm statistics"):
        tlayers.set_norm_stats_mode("fp8")
    assert tlayers.get_norm_stats_mode() == "f32"


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_stats_match_jax(seed):
    x, w, b, r = _inputs(seed)
    jlayers.set_norm_stats_mode("bf16")
    tlayers.set_norm_stats_mode("bf16")
    jy, jgx, jgw, jgb = _jax(x, w, b, r)
    y, gx, gw, gb = _port(x, w, b, r)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    np.testing.assert_array_equal(y.float().numpy(), np.asarray(jy.astype(jnp.float32)))
    assert np.abs(gx - jgx).max() <= 2.0 ** -6 * np.abs(jgx).max()
    # the exact sums of the same bf16 products
    with torch.no_grad():
        plain = tlayers.InstanceNorm2d(SHAPE[1], affine=False)
        yn = plain(torch.from_numpy(x).to(torch.bfloat16)).double()
    rr = torch.from_numpy(r).to(torch.bfloat16).double()
    exact = {"weight": (yn * rr).sum((0, 2, 3)).numpy(), "bias": rr.sum((0, 2, 3)).numpy()}
    for name, got, want in (("weight", gw, jgw), ("bias", gb, jgb)):
        err, jerr = np.abs(got - exact[name]).max(), np.abs(want - exact[name]).max()
        assert err <= 2.0 ** -8 * np.abs(exact[name]).max(), name
        assert err <= jerr, name


def test_bf16_mode_leaves_float32_inputs_on_the_f32_path():
    x, w, b, _ = _inputs(2)
    m = tlayers.InstanceNorm2d(SHAPE[1])
    m.weight.data, m.bias.data = torch.from_numpy(w), torch.from_numpy(b)
    xt = torch.from_numpy(x)
    want = m(xt)
    tlayers.set_norm_stats_mode("bf16")
    assert torch.equal(m(xt), want)


def test_bf16_norm_stats_close_to_f32():
    """makani_tpu's gate (tests/test_pallas_adam.py:128) on the port."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 4, 24, 48) * 1.7 + 0.6).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    m = tlayers.InstanceNorm2d(4)
    tlayers.set_norm_stats_mode("f32")
    ref = m(xb).float().detach().numpy()
    tlayers.set_norm_stats_mode("bf16")
    got = m(xb).float().detach().numpy()
    np.testing.assert_allclose(got, ref, atol=0.05, rtol=0.05)
    assert np.abs(got.mean()) < 0.05 and abs(got.std() - 1.0) < 0.1
