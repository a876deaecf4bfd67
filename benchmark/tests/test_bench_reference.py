"""The plain references against a tiny port model on the CPU, float32: the
same weights (drawn by the benchmark, loaded into the port by name), the
same inputs. Also the reference's own quadratures and Legendre tables
against the port's."""

import numpy as np
import pytest
import torch

from benchmark.harness.traffic import generator
from benchmark.reference import afno, sfno
from benchmark.reference.common import make_leaves, round_fp8
from makani_tpu_torch.models.model_registry import get_model, update_channel_params
from makani_tpu_torch.ops import complex_ops, legendre, quadrature, sht
from makani_tpu_torch.utils.yparams import ParamsBase

C5 = list(range(5))
SFNO = dict(nettype="SFNO", img_shape_x=37, img_shape_y=72, scale_factor=3, embed_dim=16,
            num_layers=3, mlp_ratio=2, model_grid_type="equiangular",
            sht_grid_type="legendre-gauss", filter_type="linear", operator_type="dhconv",
            normalization_layer="instance_norm", use_mlp=True, activation_function="gelu",
            hard_thresholding_fraction=1.0, in_channels=C5, out_channels=C5, n_history=0,
            target="default", pos_embed="none", separable=False, dt=1)
AFNO = dict(nettype="AFNO", img_shape_x=16, img_shape_y=32, crop_size_x=16, crop_size_y=32,
            patch_size=[8, 8], embed_dim=32, num_layers=2, num_blocks=4,
            sparsity_threshold=0.01, hard_thresholding_fraction=1.0,
            normalization_layer="instance_norm", skip_fno="identity", nested_skip_fno=True,
            in_channels=C5, out_channels=C5, n_history=0, target="default", dt=1)


def port_model(params, weights):
    p = update_channel_params(ParamsBase.from_dict(dict(params)))
    model = get_model(p, device="cpu")
    model.load_state_dict(weights)
    return model


@pytest.mark.parametrize("grid,n", [("equiangular", 37), ("legendre-gauss", 12)])
def test_quadrature_and_tables(grid, n):
    theta, w = (sfno.clenshaw_curtis if grid == "equiangular" else sfno.gauss_legendre)(n)
    cost, want = quadrature.quadrature_nodes_weights(grid, n)
    np.testing.assert_allclose(theta, np.flip(np.arccos(cost)), atol=1e-12)
    np.testing.assert_allclose(w, np.flip(want), atol=1e-13)
    np.testing.assert_allclose(sfno.legendre_table(13, 12, theta),
                               legendre.precompute_legpoly(13, 12, theta), atol=1e-12)


@pytest.fixture
def float32_program():
    """The port's spectral transforms and contractions in float32 (a run
    under AMP elsewhere in the process leaves them at "default")."""
    saved = sht.get_transform_precision(), complex_ops.get_contraction_precision()
    sht.set_transform_precision("highest")
    complex_ops.set_contraction_precision("highest")
    yield
    sht.set_transform_precision(saved[0])
    complex_ops.set_contraction_precision(saved[1])


def test_sfno_forward_and_gradients_match_the_port(float32_program):
    torch.manual_seed(0)
    w = make_leaves(sfno.parameters(SFNO), generator(torch.device("cpu"), 11), "cpu")
    model = port_model(SFNO, w)
    ref = sfno.Model(SFNO, "cpu")
    x = torch.randn(2, 5, 37, 72)
    t = torch.randn(2, 5, 37, 72)
    want = model(x)
    with torch.no_grad():
        got = ref.forward(w, x)
    assert float((got - want).norm() / want.norm()) < 1e-5
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss = ref.loss(ref.forward(params, x, recompute=True), t)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    from makani_tpu_torch.utils.losses import LossHandler
    lp = ParamsBase.from_dict(dict(SFNO, loss="absolute squared geometric l2", n_future=0,
                                   N_out_channels=5, img_crop_shape_x=37, img_crop_shape_y=72,
                                   img_crop_offset_x=0, img_crop_offset_y=0,
                                   channel_weights="auto"))
    port_loss = LossHandler(lp)(model(x), t)
    assert float(port_loss) == pytest.approx(float(loss), rel=1e-5)
    port_loss.backward()
    # against the leaf's norm or the median leaf's, whichever is larger (a
    # bias under instance norm has a gradient of round-off alone)
    median = float(np.median([float(p.grad.norm()) for p in model.parameters()]))
    for k, p in model.named_parameters():
        scale = max(float(p.grad.norm()), median)
        assert float((grads[k] - p.grad).norm()) / scale < 1e-4, k


def test_afno_forward_matches_the_port():
    w = make_leaves(afno.parameters(AFNO), generator(torch.device("cpu"), 12), "cpu")
    model = port_model(AFNO, w).eval()
    x = torch.randn(1, 5, 16, 32)
    with torch.no_grad():
        want = model(x)
        got = afno.Model(AFNO, "cpu").forward(w, x)
    assert float((got - want).norm() / want.norm()) < 1e-5


def test_fp8_rounding():
    x = torch.linspace(-3.0, 5.0, 101, requires_grad=True)
    q = round_fp8(x)
    # e4m3 keeps 3 bits of mantissa: within 2**-4 of each value, relative
    rel = ((q - x).abs() / x.abs().clamp_min(1e-2)).max()
    assert 0 < float(rel) <= 2 ** -4 + 1e-6
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
