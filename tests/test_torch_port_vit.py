"""makani_tpu_torch's attention and ViT, and registration from a file,
against makani_tpu on the CPU.

The attention at (B, H, N, D) = (2, 3, 300, 16) and (1, 2, 256, 8): the
materialised softmax, and the blockwise recurrence forced with
`min_blockwise_tokens=0` at a block that does not divide N (padded keys) and
at one that does, forward and the gradients of q, k and v, in float32 and
bf16; its block steps are recomputed in backward (no block's logits kept).
A small ViT (config/vit.yaml vit_backbone, patch (2, 4), 3 input and 5
output channels, embed 16, 4 heads, 2 blocks; weights made in JAX and
carried by load_jax_params), on the materialised path and with both
packages forced onto the blockwise one; its full-width tree (720x1440,
patch 8, embed 768, 12 blocks: 150 leaves); dropout in training; bf16 AMP;
two Trainer steps of vit_smoke (36x72 cropped to 32x72, the "geometric l2"
loss on the cropped equiangular grid) from files against makani_tpu's
Trainer. Registration: a torch.nn.Module named as "path.py:Class" in
`nettype` is built by get_model, as makani_tpu's registry builds a flax one.

Tolerances:
  - the attention in float32: ATTN_TOL (2e-6) of the largest magnitude of
    the output and of each gradient, einsums that sum in other orders (the
    deviations read ~5e-7); in bf16, where both sides round P and the
    output to bf16, BF16_TOL (2e-2, a few bf16 ulps at a row's largest);
  - the network, AMP and the Trainer: test_torch_port_afno.py's (TOL,
    GRAD_TOL, AMP_SHARE with its float32 control, STEP_LOSS_TOL and
    UPDATE_TOL).
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from makani_tpu.models import model_registry as jregistry
from makani_tpu.models.common.attention import scaled_dot_product_attention as jsdpa
from makani_tpu.models.networks import vit as jvit
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.models import model_registry as tregistry
from makani_tpu_torch.models.common import attention
from makani_tpu_torch.models.common.layers import DropoutKey, use_dropout_key
from makani_tpu_torch.models.networks import vit as tvit
from makani_tpu_torch.utils.param_layout import jax_key_to_torch

from test_torch_port_afno import (  # noqa: F401 (_one_thread: a module fixture)
    AMP_SHARE,
    COUT,
    EVEN,
    ODD,
    ROUND_EVERY_OP,
    TOL,
    _configs,
    _CountGelu,
    _dev,
    _one_thread,
    _rel,
    assert_grads_close,
    assert_trainer_steps_match,
    inputs,
    jax_output_and_grads,
    matched_models,
    port_output_and_grads,
    smoke_configs,
    smoke_dataset,
)

ATTN_TOL = 2e-6
BF16_TOL = 2e-2
VIT_YAML = "config/vit.yaml"


# --------------------------------------------------------------------------
# the attention
# --------------------------------------------------------------------------

# (B, H, N, D, block_size, min_blockwise_tokens): blockwise with padded keys,
# blockwise on whole blocks, materialised
ATTN_CASES = [(2, 3, 300, 16, 128, 0), (1, 2, 256, 8, 64, 0), (1, 2, 64, 8, None, 2048)]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_matches_jax(case):
    b, h, n, d, block, min_tokens = case
    rng = np.random.RandomState(n)
    q, k, v, r = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(4))
    kw = dict(block_size=block, min_blockwise_tokens=min_tokens)

    def loss(q, k, v):
        return jnp.sum(jsdpa(q, k, v, **kw) * r)
    want = np.asarray(jsdpa(*(jnp.asarray(a) for a in (q, k, v)), **kw))
    jgrads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = attention.scaled_dot_product_attention(tq, tk, tv, **kw)
    (got * torch.from_numpy(r)).sum().backward()
    assert got.dtype == torch.float32 and _rel(got.detach().numpy(), want) < ATTN_TOL
    for t, g in zip((tq, tk, tv), jgrads):
        assert _rel(t.grad.numpy(), np.asarray(g)) < ATTN_TOL
    # bf16 operands: float32 logits, P cast to bf16, a bf16 output
    wantb = np.asarray(jsdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), **kw)
                       .astype(jnp.float32))
    gotb = attention.scaled_dot_product_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), **kw)
    assert gotb.dtype == torch.bfloat16
    assert _rel(gotb.float().numpy(), wantb) < BF16_TOL


def test_blockwise_steps_are_recomputed_in_backward():
    """Backward keeps each block step's carries and inputs, not its
    (B, H, N, block) logits or probabilities: the steps are recomputed; the
    default block size is set_attention_block_size's."""
    b, h, n, d, block = 1, 2, 300, 8, 64
    q, k, v = (torch.randn(b, h, n, d, requires_grad=True) for _ in range(3))
    saved = []
    prev = attention._DEFAULT_BLOCK_SIZE
    attention.set_attention_block_size(block)
    try:
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                      lambda t: t):
            y = attention.scaled_dot_product_attention(q, k, v, min_blockwise_tokens=0)
    finally:
        attention.set_attention_block_size(prev)
    assert saved and all(s[-1] != block for s in saved)
    ref = attention.scaled_dot_product_attention(q, k, v, min_blockwise_tokens=n)
    assert _rel(y.detach().numpy(), ref.detach().numpy()) < ATTN_TOL
    y.square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


# --------------------------------------------------------------------------
# the ViT
# --------------------------------------------------------------------------

@pytest.fixture
def blockwise():
    """Both packages' ViT on the blockwise attention, at a 7-key block that
    divides no token count here (30 and 35 tokens)."""
    kw = dict(block_size=7, min_blockwise_tokens=0)
    with mock.patch.object(jvit, "scaled_dot_product_attention",
                           functools.partial(jsdpa, **kw)), \
            mock.patch.object(tvit, "scaled_dot_product_attention",
                              functools.partial(attention.scaled_dot_product_attention, **kw)):
        yield


@pytest.mark.parametrize("grid,overrides", [
    pytest.param(EVEN, {}, id="materialised"),
    pytest.param(ODD, dict(qkv_bias=False, mlp_ratio=3.0, attn_drop_rate=0.2, mlp_drop_rate=0.1,
                           path_drop_rate=0.1), id="no_qkv_bias_dropout_rates"),
])
def test_vit_forward_and_gradients_match_jax(grid, overrides):
    _check_vit(grid, overrides)


def test_vit_on_the_blockwise_attention_matches_jax(blockwise):
    _check_vit(ODD, {})


def _check_vit(grid, overrides):
    jmodel, jparams, tmodel = matched_models(VIT_YAML, "vit_backbone", grid, **overrides)
    net = tmodel.model
    assert type(net).__name__ == "VisionTransformer"
    assert (net.blocks[0].attn.qkv.bias is not None) == overrides.get("qkv_bias", True)
    x, r = inputs(5, grid), inputs(6, grid, COUT)
    want, jgrads = jax_output_and_grads(jmodel, jparams, x, r)
    got, grads = port_output_and_grads(tmodel, x, r)
    assert got.shape == want.shape == (2, COUT, *grid)
    assert _rel(got.numpy(), want) < TOL
    assert_grads_close(grads, jgrads)


def test_vit_full_width_tree_matches_jax():
    """config/vit.yaml's vit_backbone at full width (73 channels cropped to
    720x1440, patch 8x8, embed 768, 12 blocks of 12 heads): the same 150
    leaves with the same shapes in makani_tpu's tree (jax.eval_shape) and
    the port's (meta device); `normalization_layer`, not a field of the
    ViT, is filtered out, and qkv_bias defaults to True."""
    p = JYParams(VIT_YAML, "vit_backbone")
    kw = dict(inp_shape=(720, 1440), inp_chans=73, out_chans=73)
    jnet = jvit.VisionTransformer(**jregistry._filter_kwargs(
        jvit.VisionTransformer, dict(p.to_dict(), **kw, patch_size=tuple(p.patch_size))))
    tree = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 73, 720, 1440))))["params"]
    want = {jax_key_to_torch(k): tuple(v.shape) for k, v in flatten_dict(tree, sep="/").items()}
    tkw = tregistry._filter_kwargs(tvit.VisionTransformer, dict(p.to_dict(), **kw))
    assert "normalization_layer" not in tkw and "qkv_bias" not in tkw
    tnet = tvit.VisionTransformer(**tkw, device="meta")
    got = {k: tuple(v.shape) for k, v in tnet.named_parameters()}
    assert got == want and len(got) == 150
    assert got["blocks.0.attn.qkv.bias"] == (3 * 768,)
    assert tnet.grid == (90, 180)


def test_vit_dropout_in_training():
    """With attn_drop_rate > 0 a training forward materialises the softmax
    and drops on it (the attention's dropout keeps 1 - rate of the
    probabilities); the masks come from the dropout key: the same key gives
    the same output, another step another."""
    _, tp = _configs(VIT_YAML, "vit_backbone", EVEN, attn_drop_rate=0.3, mlp_drop_rate=0.1,
                     path_drop_rate=0.2)
    model = tregistry.get_model(tp, device="cpu", generator=torch.Generator().manual_seed(2))
    net = model.model
    # pos_drop, then per block the attention's two, a DropPath each branch
    # and the MLP's two
    assert net.n_dropout_sites == 1 + 6 * 2
    x = torch.from_numpy(inputs(7))
    kept = []
    drop = net.blocks[1].attn.attn_drop
    forward = drop.forward

    def record(p, deterministic=True):
        out = forward(p, deterministic)
        kept.append(float((out != 0).float().mean()))
        return out
    with mock.patch.object(drop, "forward", record), torch.no_grad():
        with use_dropout_key(DropoutKey(3, 1, 0)):
            y1, y2 = model(x, deterministic=False), model(x, deterministic=False)
        with use_dropout_key(DropoutKey(3, 2, 0)):
            y3 = model(x, deterministic=False)
        y_eval = model(x)
    assert torch.equal(y1, y2) and not torch.equal(y1, y3) and not torch.equal(y1, y_eval)
    n = 2 * 4 * 30 * 30
    assert len(kept) == 3 and all(abs(f - 0.7) < 5 * (0.21 / n) ** 0.5 for f in kept)


def test_vit_amp_matches_jax():
    """The input cast to bf16: the ViT is bf16 only up to block 0's first
    residual, its output float32, no bf16 GELU."""
    jmodel, jparams, tmodel = matched_models(VIT_YAML, "vit_backbone", ODD)
    x, r = inputs(8, ODD), inputs(9, ODD, COUT)
    j32, g32 = jax_output_and_grads(jmodel, jparams, x, r, ROUND_EVERY_OP)
    jamp, gamp = jax_output_and_grads(jmodel, jparams, x.astype(jnp.bfloat16), r,
                                      ROUND_EVERY_OP)
    count = _CountGelu()
    from makani_tpu_torch.models.common import activations
    with mock.patch.object(activations, "gelu_bf16", count):
        tmodel.zero_grad(set_to_none=True)
        y = tmodel(torch.from_numpy(x).to(torch.bfloat16))
        (y * torch.from_numpy(r)).sum().backward()
    assert y.dtype == torch.float32 and count.calls == 0
    tamp = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    t32, tf32 = port_output_and_grads(tmodel, x, r)

    def flat(grads):
        return np.concatenate([grads[k].ravel() for k in sorted(grads)])
    for got, control, want, ref in ((y.detach().numpy(), t32.numpy(), jamp, j32),
                                    (flat(tamp), flat(tf32), flat(gamp), flat(g32))):
        bound = AMP_SHARE * _dev(want, ref)
        assert _dev(got, want) < bound < _dev(control, want)


# --------------------------------------------------------------------------
# registration from a file
# --------------------------------------------------------------------------

NET_FILE = '''
import torch


class TinyNet(torch.nn.Module):
    def __init__(self, inp_chans=2, out_chans=2, width=4, device="cpu", generator=None):
        super().__init__()
        self.mix = torch.nn.Parameter(torch.randn(out_chans, inp_chans, generator=generator,
                                                  device=device))
        self.width = width

    def forward(self, x, deterministic=True):
        return torch.einsum("oc,bchw->bohw", self.mix, x)


NotAModule = int
'''


def test_register_model_from_a_file(tmp_path):
    path = tmp_path / "tiny_net.py"
    path.write_text(NET_FILE)
    nettype = f"{path}:TinyNet"
    _, tp = _configs(VIT_YAML, "vit_backbone", EVEN, nettype=nettype, width=6)
    try:
        model = tregistry.get_model(tp, device="cpu")
        assert type(model.model).__name__ == "TinyNet" and model.model.width == 6
        assert tregistry.list_models()[-1] == nettype
        y = model(torch.from_numpy(inputs(10)))
        assert y.shape == (2, COUT, *EVEN) and torch.isfinite(y).all()
        # a second registration under the same name, and a class that is
        # not a torch.nn.Module, are refused
        with pytest.raises(ValueError, match="already in use"):
            tregistry.register_model(nettype, nettype)
        with pytest.raises(ValueError, match="torch.nn.Module"):
            tregistry.register_model(f"{path}:NotAModule")
        with pytest.raises(ValueError, match="does not exist"):
            tregistry.register_model(f"{tmp_path / 'none.py'}:TinyNet")
        tregistry.register_model(tvit.Attention, "AttentionNet")
        assert tregistry._model_registry["AttentionNet"] is tvit.Attention
    finally:
        for name in (nettype, "AttentionNet"):
            tregistry._model_registry.pop(name, None)
    assert tregistry.list_models() == jregistry.list_models()


# --------------------------------------------------------------------------
# the Trainer: vit_smoke from files
# --------------------------------------------------------------------------

def test_vit_smoke_trainer_steps_match_jax(smoke_dataset):
    jp, tp = smoke_configs(VIT_YAML, "vit_smoke", smoke_dataset)
    assert jp.loss == tp.loss == "geometric l2"
    assert_trainer_steps_match(jp, tp, "VisionTransformer")
