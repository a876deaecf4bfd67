"""InstanceNorm2d at "f32" statistics on the CPU: the plain twins of
ops/instance_norm.py against the eager chain the port ran before the
kernels, and the layer's dispatch between the Function and the eager paths.

The twin's forward is that chain itself, so it is held to it bit for bit.
Its closed-form backward, dx = rstd (g^ - mean(g^) - x^ mean(g^ x^)) with
g^ = g w and x^ = (x - mean) rstd, is held to autograd through the chain:
in float64 (the chain and the closed form both in float64) within 1e-10 of
the largest magnitude, the two forms being equal in exact arithmetic; in bf16
(both in float32 over bf16 x and g, dx rounded once to bf16) within one bf16
ulp of each element plus 1e-6 of the largest magnitude, the float32 sums of
the two forms rounding apart where dx is a small difference of larger terms,
and the affine's float32 gradients within 1e-5 of the sums of magnitudes
they add. The kernels themselves are held to these twins on the card
(tests/test_torch_port_cuda.py).
"""

import pytest
import torch

from makani_tpu_torch.models.common import layers
from makani_tpu_torch.ops import instance_norm, kernels
from makani_tpu_torch.parallel import spmd

EPS = 1e-6


def _eager(x, weight, bias, eps=EPS, dtype=torch.float32):
    """The chain InstanceNorm2d ran at "f32" statistics before the kernels,
    its float32 steps in `dtype`."""
    xf = x.to(dtype)
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    xc = xf - mean
    var = xc.square().mean(dim=(-2, -1), keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight[None, :, None, None] + bias[None, :, None, None]
    return y.to(x.dtype)


def _inputs(shape, dtype, seed=0, affine=True):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 1.7 + 0.6).to(dtype)
    r = torch.randn(shape, generator=g).to(dtype)
    c = shape[1]
    w = 1.0 + 0.3 * torch.randn(c, generator=g) if affine else None
    b = 0.2 * torch.randn(c, generator=g) if affine else None
    return x, r, w, b


def _bf16_ulp(t):
    """One bf16 ulp of each element of `t` (of the smallest normal at 0)."""
    a = t.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


SHAPES = [(2, 5, 12, 20), (1, 3, 7, 13), (2, 4, 1, 9)]


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_twin_forward_is_the_eager_chain_bit_for_bit(shape, dtype, affine):
    x, _, w, b = _inputs(shape, dtype, affine=affine)
    y, (mean, rstd) = instance_norm.instance_norm_plain(x, w, b, EPS)
    assert y.dtype == dtype and torch.equal(y, _eager(x, w, b))
    xf = x.float()
    want_mean = xf.mean(dim=(-2, -1))
    want_var = (xf - want_mean[..., None, None]).square().mean(dim=(-2, -1))
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == shape[:2]
    assert torch.equal(mean, want_mean) and torch.equal(rstd, torch.rsqrt(want_var + EPS))


def _autograd(x, r, w, b, dtype):
    """dx, dweight, dbias of sum(y * r) by autograd through the eager chain
    (float32 steps in `dtype`)."""
    xl = x.clone().requires_grad_(True)
    wl = None if w is None else w.to(dtype).clone().requires_grad_(True)
    bl = None if b is None else b.to(dtype).clone().requires_grad_(True)
    y = _eager(xl, wl, bl, dtype=dtype)
    (y.to(dtype) * r.to(dtype)).sum().backward()
    return xl.grad, None if wl is None else wl.grad, None if bl is None else bl.grad


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_twin_backward_is_autograd_through_the_chain_float64(shape, affine):
    x, r, w, b = _inputs(shape, torch.float64, affine=affine)
    w, b = (None, None) if w is None else (w.double(), b.double())
    gx, gw, gb = _autograd(x, r, w, b, torch.float64)
    mean = x.mean(dim=(-2, -1))
    rstd = torch.rsqrt((x - mean[..., None, None]).square().mean(dim=(-2, -1)) + EPS)
    dx, dw, db = instance_norm.instance_norm_grad_plain(x, r, w, torch.stack((mean, rstd)))
    assert dx.dtype == torch.float64
    assert float((dx - gx).abs().max()) <= 1e-10 * float(gx.abs().max())
    if affine:
        for got, want in ((dw, gw), (db, gb)):
            assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())
    else:
        assert dw is None and db is None


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_twin_backward_is_autograd_through_the_chain_bf16(shape, affine):
    """The Function on the CPU (the twins, x and the statistics saved)
    against autograd through the eager chain on the same bf16 x and r."""
    x, r, w, b = _inputs(shape, torch.bfloat16, affine=affine)
    gx, gw, gb = _autograd(x, r, w, b, torch.float32)
    xl = x.clone().requires_grad_(True)
    wl = None if w is None else w.clone().requires_grad_(True)
    bl = None if b is None else b.clone().requires_grad_(True)
    y = instance_norm.instance_norm(xl, wl, bl, EPS)
    assert torch.equal(y, _eager(x, w, b))
    (y.float() * r.float()).sum().backward()
    assert xl.grad.dtype == torch.bfloat16
    err = (xl.grad.float() - gx.float()).abs()
    assert bool((err <= _bf16_ulp(gx) + 1e-6 * gx.float().abs().max()).all())
    if affine:
        xhat = (x.float() - x.float().mean(dim=(-2, -1), keepdim=True))
        xhat = xhat * torch.rsqrt(xhat.square().mean(dim=(-2, -1), keepdim=True) + EPS)
        scale = {"w": (r.float() * xhat).abs().sum(dim=(0, 2, 3)),
                 "b": r.float().abs().sum(dim=(0, 2, 3))}
        assert bool(((wl.grad - gw).abs() <= 1e-5 * scale["w"]).all())
        assert bool(((bl.grad - gb).abs() <= 1e-5 * scale["b"]).all())


def test_function_saves_x_and_float32_statistics():
    x, _, w, b = _inputs((2, 3, 6, 10), torch.bfloat16)
    xl = x.clone().requires_grad_(True)
    y = instance_norm.instance_norm(xl, w.requires_grad_(True), b.requires_grad_(True), EPS)
    saved_x, saved_w, stats = y.grad_fn.saved_tensors
    assert saved_x.data_ptr() == xl.data_ptr() and saved_x.dtype == torch.bfloat16
    assert saved_w.data_ptr() == w.data_ptr()
    assert stats.dtype == torch.float32 and stats.shape == (2, 2, 3)


def test_channel_slice_affine_gets_its_slice_of_the_gradient():
    """The affine as leaf_part cuts it for a rank's channels (x_axis): a slice
    of the whole leaf, whose gradient lands in that slice alone."""
    x, r, w, b = _inputs((2, 3, 8, 10), torch.float32, seed=3)
    wf = torch.cat([torch.randn(2), w, torch.randn(4)]).requires_grad_(True)
    bf = torch.cat([torch.randn(2), b, torch.randn(4)]).requires_grad_(True)
    y = instance_norm.instance_norm(x, wf[2:5], bf[2:5], EPS)
    assert torch.equal(y, _eager(x, w, b))
    (y * r).sum().backward()
    _, gw, gb = _autograd(x, r, w, b, torch.float32)
    for full, want in ((wf.grad, gw), (bf.grad, gb)):
        assert not bool(full[:2].any()) and not bool(full[5:].any())
        torch.testing.assert_close(full[2:5], want, rtol=1e-5, atol=1e-5)


@pytest.fixture
def f32_stats():
    yield
    layers.set_norm_stats_mode("f32")


def _layer(c=4):
    m = layers.InstanceNorm2d(c)
    g = torch.Generator().manual_seed(5)
    m.weight.data = 1.0 + 0.3 * torch.randn(c, generator=g)
    m.bias.data = 0.2 * torch.randn(c, generator=g)
    return m


def test_cpu_tensor_takes_the_twin_and_counts_nothing():
    m = _layer()
    x = _inputs((2, 4, 6, 9), torch.bfloat16)[0].requires_grad_(True)
    before, eager = dict(kernels.launches), dict(kernels.eager_calls)
    y = m(x)
    assert type(y.grad_fn).__name__ == "_InstanceNormBackward"
    assert torch.equal(y, _eager(x.detach(), m.weight.detach(), m.bias.detach()))
    y.float().sum().backward()
    assert kernels.launches == before and dict(kernels.eager_calls) == eager


def test_eager_paths_on_the_card_are_counted(monkeypatch, f32_stats):
    """Spatial ranks and the "bf16" statistics stay eager (no Function, no
    launch) and count one eager call each on a tensor the kernels would
    take (dispatch patched to say so on the CPU); the "f32" path counts
    none."""
    monkeypatch.setattr(instance_norm, "dispatch", lambda x: True)
    m = _layer()
    x = _inputs((2, 4, 6, 9), torch.bfloat16)[0]
    kernels.reset_launches()
    layers.set_norm_stats_mode("bf16")
    y = m(x.requires_grad_(True))
    assert type(y.grad_fn).__name__ != "_InstanceNormBackward"
    assert kernels.eager_calls["instance_norm"] == 1
    layers.set_norm_stats_mode("f32")
    monkeypatch.setattr(spmd, "spatial_distributed", lambda: True)
    monkeypatch.setattr(layers.InstanceNorm2d, "_global_stats", staticmethod(
        lambda xf: (xf.mean(dim=(-2, -1), keepdim=True),
                    (xf - xf.mean(dim=(-2, -1), keepdim=True)).square().mean(
                        dim=(-2, -1), keepdim=True))))
    y = m(x)
    assert type(y.grad_fn).__name__ != "_InstanceNormBackward"
    assert torch.equal(y, _eager(x.detach(), m.weight.detach(), m.bias.detach()))
    assert kernels.eager_calls["instance_norm"] == 2
    assert not any(kernels.launches.values())
    kernels.reset_launches()
    assert kernels.eager_calls["instance_norm"] == 0


def test_no_grad_runs_the_forward_without_the_function():
    m = _layer()
    x = _inputs((1, 4, 5, 7), torch.bfloat16)[0]
    with torch.no_grad():
        y = m(x.requires_grad_(True))
    assert y.grad_fn is None
    assert torch.equal(y, _eager(x.detach(), m.weight.detach(), m.bias.detach()))
    y = m(x.detach())
    assert type(y.grad_fn).__name__ == "_InstanceNormBackward"


def test_float32_input_at_bf16_statistics_takes_the_function(f32_stats):
    m = _layer()
    x = _inputs((1, 4, 5, 7), torch.float32)[0].requires_grad_(True)
    layers.set_norm_stats_mode("bf16")
    y = m(x)
    assert type(y.grad_fn).__name__ == "_InstanceNormBackward"
    assert torch.equal(y, _eager(x.detach(), m.weight.detach(), m.bias.detach()))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch, dtype):
    monkeypatch.setattr(instance_norm, "dispatch", lambda x: True)
    x = torch.randn((1, 2, 3, 4)).to(dtype)
    with pytest.raises(ValueError, match="bf16 or float32"):
        instance_norm.instance_norm_forward(x, None, None, EPS)
    with pytest.raises(ValueError, match="bf16 or float32"):
        instance_norm.instance_norm_forward(torch.randn((2, 3, 4)), None, None, EPS)
    w = torch.ones(3)
    with pytest.raises(ValueError, match="of 2 channels, or neither"):
        instance_norm.instance_norm_forward(torch.randn((1, 2, 3, 4)), w, torch.zeros(3), EPS)
    with pytest.raises(ValueError, match="of 2 channels, or neither"):
        instance_norm.instance_norm_forward(torch.randn((1, 2, 3, 4)), torch.ones(2), None, EPS)
    with pytest.raises(ValueError, match="statistics"):
        instance_norm.instance_norm_backward(torch.randn((1, 2, 3, 4)), torch.randn((1, 2, 3, 4)),
                                             None, torch.randn((2, 2)))
