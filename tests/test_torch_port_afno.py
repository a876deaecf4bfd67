"""makani_tpu_torch's AFNO v2, AFNO v1, PrecipNet and 3D FFT pair against
makani_tpu on the CPU.

Small models with every dimension distinct (patch (2, 4), 3 input and 5
output channels, an H other than W, embed 16, 4 spectral blocks, 2 layers)
are made in JAX from a seed and carried by load_jax_params; inputs come from
numpy seeds. AFNO v2's spectral weights w1, w2 are scaled by SPECTRAL_GAIN
on both sides before the comparison: at their init scale (0.02) the
spectral MLP's output stays under the softshrink threshold, the filter
passes its input through, and half of its paths would go untested.

Covered: the RealFFT3 pair (odd and even sizes, truncated or not); AFNO v2
with skip_fno "identity", "linear" and "none", nested or not, its
"layer_norm" variant, hard_thresholding_fraction 0.75 at an odd and an even
token grid, and its MLP recomputed in backward (checkpointing 2) with
dropout; AFNO v1 at 0.75 on both grids; the mode masks against the rows
makani_tpu keeps; PrecipNet over AFNO v1; the full-width configurations'
parameter trees (config/afnonet.yaml afno_v2, afno_backbone at 720x1440:
136 and 148 leaves); the forward and gradients under bf16 AMP; two Trainer
steps of afno_smoke (AFNO v1, 36x72 cropped to 32x72) from files against
makani_tpu's Trainer.

Tolerances:
  - the 3D FFT pair and the AFNO filters alone: FFT_TOL (1e-5) of the
    largest magnitude, float32 FFTs that sum in other orders (ROADMAP Queue
    3 divergence 9);
  - the networks: TOL (2e-4) of the largest output and GRAD_TOL (2e-4) of
    each leaf's largest gradient, tests/test_torch_port_fno.py's bounds
    (the deviations read ~3e-7 and up to ~8e-5). The leaves that feed only
    per-channel constants into an instance norm that removes them (the
    filter's b1, the linear skip's bias and norm1's bias under nested skips)
    have an exact gradient of zero; both sides hold rounding noise there,
    measured against the largest gradient of the model instead;
  - bf16 AMP: test_torch_port_amp.py's bounds. Port AMP against makani_tpu
    AMP below AMP_SHARE (0.85) of makani_tpu's own AMP deviation from
    float32, in the output and over every leaf's gradient, with the port's
    float32 run as the control, which must come out above it. makani_tpu's
    programs are compiled without excess precision (ROUND_EVERY_OP), so
    they round where their dtypes say, as the port does;
  - Trainer steps: test_torch_port_train.py's (losses STEP_LOSS_TOL,
    updates UPDATE_TOL norm-wise over the elements whose first gradient is
    at least SIGN_FLOOR of their leaf's largest); an element whose first
    gradient is exactly zero (AFNO v1's spectral outputs that softshrink
    removes) takes no first update on either side.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from makani_tpu.models import model_registry as jregistry
from makani_tpu.models.networks import afnonet as jafno
from makani_tpu.models.networks import afnonet_v2 as jafno2
from makani_tpu.ops import fft3d as jfft3d
from makani_tpu.utils.dataset_metadata import parse_dataset_metadata as jparse
from makani_tpu.utils.yparams import YParams as JYParams

from makani_tpu_torch.models import model_registry as tregistry
from makani_tpu_torch.models.common import activations
from makani_tpu_torch.models.common.layers import DropoutKey, use_dropout_key
from makani_tpu_torch.models.networks import afnonet as tafno
from makani_tpu_torch.models.networks import afnonet_v2 as tafno2
from makani_tpu_torch.ops import complex_ops, fft3d as tfft3d, sht
from makani_tpu_torch.tools import make_synthetic_dataset as tsynth
from makani_tpu_torch.tools.convert_jax_params import load_jax_opt_state, load_jax_params
from makani_tpu_torch.utils.param_layout import jax_key_to_torch
from makani_tpu_torch.utils.yparams import YParams as TYParams

from test_torch_port_train import GRAD_TOL, SIGN_FLOOR, STEP_LOSS_TOL, UPDATE_TOL, _as_port

TOL = 2e-4
FFT_TOL = 1e-5
AMP_SHARE = 0.85
ROUND_EVERY_OP = {"xla_allow_excess_precision": False}
SPECTRAL_GAIN = 25.0
# 12x20 and 14x20 inputs, patch (2, 4): token grids 6x5 (even h) and 7x5
EVEN, ODD = (12, 20), (14, 20)
CIN, COUT = 3, 5
SMALL = dict(patch_size=[2, 4], embed_dim=16, num_layers=2, depth=2, num_heads=4, num_blocks=4)
ZERO_GRAD = ("filter.b1", "skip_bias", "norm1.bias")
AFNO_YAML = "config/afnonet.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread; both packages' Trainers set the precision, a module
    global shared with every test file of the worker: back to "high"
    after."""
    from makani_tpu.ops import complex_ops as jcomplex
    from makani_tpu.ops import sht as jsht
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    for mod in (sht, jsht):
        mod.set_transform_precision("high")
    for mod in (complex_ops, jcomplex):
        mod.set_contraction_precision("high")
    torch.set_num_threads(prev)


def _rel(got, want):
    dtype = np.complex128 if np.iscomplexobj(want) else np.float64
    got, want = np.asarray(got, dtype), np.asarray(want, dtype)
    return np.abs(got - want).max() / np.abs(want).max()


def _dev(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# --------------------------------------------------------------------------
# the 3D FFT pair
# --------------------------------------------------------------------------

# (nd, nh, nw, ldmax, lhmax, lwmax): untruncated, truncated on every axis at
# odd and even sizes, a max of 1 (makani_tpu's [-0:] slice)
FFT3_CASES = [(6, 9, 10, None, None, None), (6, 9, 10, 3, 5, 4), (7, 8, 12, 4, 4, None),
              (5, 7, 9, 1, 1, 2)]


@pytest.mark.parametrize("case", FFT3_CASES, ids=str)
def test_fft3_pair_matches_jax(case):
    nd, nh, nw = case[:3]
    rng = np.random.RandomState(sum(case[:3]))
    x = rng.randn(2, nd, nh, nw).astype(np.float32)
    fwd, inv = tfft3d.RealFFT3(*case), tfft3d.InverseRealFFT3(*case)
    jfwd, jinv = jfft3d.RealFFT3(*case), jfft3d.InverseRealFFT3(*case)
    names = ("ldmax", "lhmax", "lwmax", "ldmax_high", "ldmax_low", "lhmax_high", "lhmax_low")
    assert [getattr(fwd, n) for n in names] == [getattr(jfwd, n) for n in names]
    want = np.asarray(jax.jit(jfwd.__call__)(jnp.asarray(x)))
    got = fwd(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert _rel(got.numpy(), want) < FFT_TOL
    c = (rng.randn(*want.shape) + 1j * rng.randn(*want.shape)).astype(np.complex64)
    want_x = np.asarray(jax.jit(jinv.__call__)(jnp.asarray(c)))
    got_x = inv(torch.from_numpy(c))
    assert got_x.dtype == torch.float32 and got_x.shape == want_x.shape == (2, nd, nh, nw)
    assert _rel(got_x.numpy(), want_x) < FFT_TOL
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(fwd(xb), fwd(xb.float()))


# --------------------------------------------------------------------------
# the AFNO filters alone: masks, forward, gradients
# --------------------------------------------------------------------------

def test_mode_masks_keep_makani_tpus_rows():
    """v2 keeps both ends of the latitude axis (all of it once the kept count
    reaches h // 2 + 1), v1 the centred window [total - kept, total + kept);
    both the first kept longitudes (v1 counts them from h)."""
    v2 = tafno2.AFNO2Dv2(16, 4, hard_thresholding_fraction=0.75)
    v1 = tafno.AFNO2Dv1(16, 4, hard_thresholding_fraction=0.75)
    rows = {9: ([0, 1, 2, 6, 7, 8], [2, 3, 4, 5, 6, 7]),
            8: ([0, 1, 2, 5, 6, 7], [2, 3, 4, 5, 6, 7])}
    for h, (keep2, keep1) in rows.items():
        m2, m1 = v2.mode_mask(h, 10, "cpu"), v1.mode_mask(h, 10, "cpu")[0, :, :, 0, 0]
        assert m2.shape == m1.shape == (h, 6)
        assert torch.nonzero(m2[:, 0]).flatten().tolist() == keep2
        assert torch.nonzero(m1[:, 0]).flatten().tolist() == keep1
        assert m2[keep2[0]].tolist() == [1.0] * 4 + [0.0] * 2
        assert m1[keep1[0]].tolist() == [1.0] * 3 + [0.0] * 3
    assert bool(tafno2.AFNO2Dv2(16, 4).mode_mask(9, 10, "cpu").all())


@pytest.mark.parametrize("version", ["v2", "v1"])
@pytest.mark.parametrize("h", [9, 8])
def test_afno_filter_matches_jax(version, h):
    """The filter at hard_thresholding_fraction 0.75 on an odd and an even
    latitude count: forward and the gradients of its weights and input."""
    w, c, blocks = 10, 16, 4
    if version == "v2":
        jmod = jafno2.AFNO2Dv2(c, blocks, 0.01, 0.75)
        tmod = tafno2.AFNO2Dv2(c, blocks, 0.01, 0.75)
        shape = (2, c, h, w)
    else:
        jmod = jafno.AFNO2Dv1(c, blocks, 0.01, 0.75)
        tmod = tafno.AFNO2Dv1(c, blocks, 0.01, 0.75)
        shape = (2, h, w, c)
    rng = np.random.RandomState(h)
    x, r = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(h), jnp.asarray(x))["params"]
    params = {k: v * SPECTRAL_GAIN if k.startswith("w") else v for k, v in params.items()}
    for k, v in params.items():
        getattr(tmod, k).data = torch.tensor(np.asarray(v))

    def loss(p, x):
        y = jmod.apply({"params": p}, x)
        return jnp.sum(y * r), y
    (_, want), (jg, jgx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = tmod(tx)
    (got * torch.from_numpy(r)).sum().backward()
    assert _rel(got.detach().numpy(), np.asarray(want)) < FFT_TOL
    assert _rel(tx.grad.numpy(), np.asarray(jgx)) < FFT_TOL
    for k, g in jg.items():
        assert _rel(getattr(tmod, k).grad.numpy(), np.asarray(g)) < FFT_TOL, k


# --------------------------------------------------------------------------
# the networks
# --------------------------------------------------------------------------

def _configs(yaml, name, grid=EVEN, **overrides):
    """Matching (JAX, port) params of `name` cut small."""
    out = []
    for cls in (TYParams, JYParams):
        p = cls(yaml, name)
        p.update_params(dict(SMALL, img_shape_x=grid[0], img_shape_y=grid[1],
                             in_channels=list(range(CIN)), out_channels=list(range(COUT)),
                             n_future=0, **overrides))
        out.append(p)
    tp, jp = out
    tregistry.update_channel_params(tp)
    jp.update_params({k: v for k, v in tp.to_dict().items() if k not in jp.to_dict()})
    return jp, tp


def _gain(params):
    """AFNO v2's spectral weights times SPECTRAL_GAIN (module docstring)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a * SPECTRAL_GAIN if path[-1].key in ("w1", "w2") else a, params)


def matched_models(yaml, name, grid=EVEN, seed=3, **overrides):
    """(JAX model, its params, the port's model with the same weights)."""
    jp, tp = _configs(yaml, name, grid, **overrides)
    jmodel = jregistry.get_model(jp)
    v = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, CIN, *grid)),
                                      deterministic=True))(jax.random.PRNGKey(seed))
    params = _gain(v["params"])
    flat = {k: np.asarray(a) for k, a in flatten_dict(params, sep="/").items()}
    tmodel = load_jax_params(tregistry.get_model(tp, device="cpu"), flat)
    return jmodel, params, tmodel


def inputs(seed, grid=EVEN, chans=CIN):
    return np.random.RandomState(seed).randn(2, chans, *grid).astype(np.float32)


def jax_output_and_grads(jmodel, jparams, x, r, compiler_options=None):
    """makani_tpu's float32 output and the gradients of sum(y * r)."""
    def loss(p):
        y = jmodel.apply({"params": p}, jnp.asarray(x), deterministic=True).astype(jnp.float32)
        return jnp.sum(y * jnp.asarray(r)), y
    (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True),
                            compiler_options=compiler_options)(jparams)
    return np.asarray(y), {jax_key_to_torch(k): np.asarray(g)
                           for k, g in flatten_dict(grads, sep="/").items()}


def port_output_and_grads(tmodel, x, r):
    tmodel.zero_grad(set_to_none=True)
    y = tmodel(torch.from_numpy(x))
    (y.float() * torch.from_numpy(r)).sum().backward()
    return y.detach(), {k: p.grad.numpy() for k, p in tmodel.named_parameters()}


def assert_grads_close(got, want, tol=GRAD_TOL):
    assert set(got) == set(want)
    largest = max(np.abs(g).max() for g in want.values())
    for k, g in want.items():
        scale = largest if k.endswith(ZERO_GRAD) else np.abs(g).max()
        assert np.abs(got[k].astype(np.float64) - g).max() / scale < tol, k


NETWORKS = [
    pytest.param("afno_v2", EVEN, {}, id="v2_identity"),
    pytest.param("afno_v2", ODD, dict(skip_fno="linear", normalization_layer="layer_norm",
                                      hard_thresholding_fraction=0.75), id="v2_linear_layer_norm"),
    pytest.param("afno_v2", EVEN, dict(skip_fno="linear", nested_skip_fno=False,
                                       hard_thresholding_fraction=0.75), id="v2_linear_unnested"),
    pytest.param("afno_v2", ODD, dict(skip_fno="none", hard_thresholding_fraction=0.75),
                 id="v2_none"),
    pytest.param("afno_backbone", ODD, dict(hard_thresholding_fraction=0.75), id="v1_odd"),
    pytest.param("afno_backbone", EVEN, dict(hard_thresholding_fraction=0.75), id="v1_even"),
]


@pytest.mark.parametrize("name,grid,overrides", NETWORKS)
def test_afno_forward_and_gradients_match_jax(name, grid, overrides):
    jmodel, jparams, tmodel = matched_models(AFNO_YAML, name, grid, **overrides)
    kind = "AdaptiveFourierNeuralOperatorNet" + ("V1" if name == "afno_backbone" else "")
    assert type(tmodel.model).__name__ == kind
    x, r = inputs(5, grid), inputs(6, grid, COUT)
    want, jgrads = jax_output_and_grads(jmodel, jparams, x, r)
    got, grads = port_output_and_grads(tmodel, x, r)
    assert got.shape == want.shape == (2, COUT, *grid)
    assert _rel(got.numpy(), want) < TOL
    assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("name,leaves", [("afno_v2", 136), ("afno_backbone", 148)])
def test_full_width_trees_match_jax(name, leaves):
    """config/afnonet.yaml's `name` at full width (73 channels cropped to
    720x1440, patch 8x8, embed 768, 12 layers, 8 blocks): makani_tpu's
    parameter tree (shapes only, jax.eval_shape) and the port's (on the meta
    device) hold the same leaves with the same shapes."""
    p = JYParams(AFNO_YAML, name)
    p.update_params(dict(img_crop_shape_x=720, img_crop_shape_y=1440, N_in_channels=73,
                         N_out_channels=73))
    cls = jregistry._model_registry[p.nettype]
    kw = dict(inp_shape=(720, 1440), inp_chans=73, out_chans=73)
    jnet = cls(**jregistry._filter_kwargs(cls, dict(p.to_dict(), **kw,
                                                    patch_size=tuple(p.patch_size))))
    tree = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 73, 720, 1440))))["params"]
    want = {jax_key_to_torch(k): tuple(v.shape) for k, v in flatten_dict(tree, sep="/").items()}
    tcls = tregistry._model_registry[p.nettype]
    tnet = tcls(**tregistry._filter_kwargs(tcls, dict(p.to_dict(), **kw)), device="meta")
    got = {k: tuple(v.shape) for k, v in tnet.named_parameters()}
    assert got == want and len(got) == leaves


# --------------------------------------------------------------------------
# bf16 AMP
# --------------------------------------------------------------------------

class _CountGelu:
    """Counts the port's bf16 GELU calls (the kernel on the card, its twin
    here)."""

    def __init__(self):
        self.calls = 0
        self.gelu = activations.gelu_bf16

    def __call__(self, x):
        self.calls += 1
        return self.gelu(x)


@pytest.mark.parametrize("name,gelu_calls", [("afno_v2", 2), ("afno_backbone", 0)])
def test_amp_matches_jax(name, gelu_calls):
    """The input cast to bf16, as the Trainer casts it: AFNO v2 stays bf16
    to its output (its MLPs' GELU on bf16, one call a block), AFNO v1 is
    float32 from block 0's first norm on (no bf16 GELU)."""
    jmodel, jparams, tmodel = matched_models(AFNO_YAML, name, ODD,
                                             hard_thresholding_fraction=0.75)
    x, r = inputs(7, ODD), inputs(8, ODD, COUT)
    xb = x.astype(jnp.bfloat16)
    j32, g32 = jax_output_and_grads(jmodel, jparams, x, r, ROUND_EVERY_OP)
    jamp, gamp = jax_output_and_grads(jmodel, jparams, xb, r, ROUND_EVERY_OP)
    count = _CountGelu()
    with mock.patch.object(activations, "gelu_bf16", count):
        tmodel.zero_grad(set_to_none=True)
        y = tmodel(torch.from_numpy(x).to(torch.bfloat16))
        (y.float() * torch.from_numpy(r)).sum().backward()
    assert y.dtype == (torch.bfloat16 if name == "afno_v2" else torch.float32)
    assert count.calls == gelu_calls
    tamp = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    t32, tf32 = port_output_and_grads(tmodel, x, r)

    def flat(grads):
        return np.concatenate([grads[k].ravel() for k in sorted(grads)])
    for got, control, want, ref in ((y.detach().float().numpy(), t32.numpy(), jamp, j32),
                                    (flat(tamp), flat(tf32), flat(gamp), flat(g32))):
        bound = AMP_SHARE * _dev(want, ref)
        assert _dev(got, want) < bound < _dev(control, want)


# --------------------------------------------------------------------------
# dropout under recomputation, PrecipNet
# --------------------------------------------------------------------------

def test_afno_v2_dropout_masks_survive_recomputation():
    """AFNO v2 with dropout and stochastic depth at every site: the kept
    fraction of the MLP's dropout is the rate's, a training forward draws
    its masks from the dropout key, and the MLP recomputed in backward
    (checkpointing 2) draws its forward's, so the gradients equal
    checkpointing 0's bit for bit."""
    results = []
    for level in (0, 2):
        _, tp = _configs(AFNO_YAML, "afno_v2", EVEN, drop_rate=0.25, drop_path_rate=0.5,
                         checkpointing=level)
        model = tregistry.get_model(tp, device="cpu", generator=torch.Generator().manual_seed(1))
        assert model.model.n_dropout_sites == 1 + 2 * 3
        assert model.model.blocks[1].mlp.checkpointing == level
        x = torch.from_numpy(inputs(9))
        with use_dropout_key(DropoutKey(7, 3, 0)):
            y = model(x, deterministic=False)
            y.square().sum().backward()
            again = model(x, deterministic=False)
        assert torch.equal(y, again)
        results.append((y.detach(), {k: p.grad for k, p in model.named_parameters()}))
    (y0, g0), (y2, g2) = results
    assert torch.equal(y0, y2) and not torch.equal(y0, model(x))
    for k, g in g0.items():
        assert torch.equal(g, g2[k]), k
    drop = model.model.blocks[0].mlp.drop1
    h = torch.ones(4, 16, 60, 50)
    with use_dropout_key(DropoutKey(7, 3, 0)):
        kept = float((drop(h, deterministic=False) != 0).float().mean())
    assert abs(kept - 0.75) < 5 * (0.75 * 0.25 / h.numel()) ** 0.5


def test_precipnet_matches_jax():
    """PrecipNet over AFNO v1: the periodic pad, the VALID 3x3 convolution
    (kernel HWIO) and the ReLU, forward and every gradient, the backbone's
    weights under backbone/."""
    jp, tp = _configs(AFNO_YAML, "afno_backbone", ODD, hard_thresholding_fraction=0.75)
    kw = dict(inp_shape=ODD, patch_size=(2, 4), inp_chans=CIN, out_chans=COUT, embed_dim=16,
              num_layers=2, num_blocks=4, hard_thresholding_fraction=0.75)
    jmodel = jafno.PrecipNet(backbone=jafno.AdaptiveFourierNeuralOperatorNetV1(**kw),
                             out_chans=2)
    x, r = inputs(10, ODD), inputs(11, ODD, 2)
    params = jax.jit(lambda k: jmodel.init(k, jnp.asarray(x)))(jax.random.PRNGKey(4))["params"]
    flat = {k: np.asarray(a) for k, a in flatten_dict(params, sep="/").items()}
    assert flat["conv/kernel"].shape == (3, 3, COUT, 2)
    tmodel = tafno.PrecipNet(tafno.AdaptiveFourierNeuralOperatorNetV1(**kw), out_chans=2)
    load_jax_params(tmodel, flat)
    want, jgrads = jax_output_and_grads(jmodel, params, x, r)
    got, grads = port_output_and_grads(tmodel, x, r)
    assert got.shape == want.shape == (2, 2, *ODD) and (want == 0).any()
    assert _rel(got.numpy(), want) < TOL
    assert_grads_close(grads, jgrads)
    pad = tafno.PeriodicPad2d(1)(torch.from_numpy(x))
    jpad = np.asarray(jafno.PeriodicPad2d(1)(jnp.asarray(x)))
    np.testing.assert_array_equal(pad.numpy(), jpad)


# --------------------------------------------------------------------------
# the Trainer: afno_smoke from files
# --------------------------------------------------------------------------

TRAIN_STEPS = 2


def smoke_configs(yaml, name, root, **overrides):
    """Matching (JAX, port) params of `name` on the dataset at `root`
    (36x72, cropped to 32x72 by the config), 2 steps; JAX's parsed from
    data.json as makani_tpu's train.py parses it."""
    stats = root / "stats"
    common = dict(
        metadata_json_path=str(root / "data.json"), train_data_path=str(root / "train"),
        valid_data_path=str(root / "test"), inf_data_path=str(root / "test"),
        global_means_path=str(stats / "global_means.npy"),
        global_stds_path=str(stats / "global_stds.npy"),
        time_means_path=str(stats / "time_means.npy"),
        time_diff_means_path=str(stats / "time_diff_means.npy"),
        time_diff_stds_path=str(stats / "time_diff_stds.npy"),
        min_path=str(stats / "mins.npy"), max_path=str(stats / "maxs.npy"),
        n_train_samples_per_epoch=TRAIN_STEPS, n_eval_samples=1, skip_validation=True,
        save_checkpoint="none", num_data_workers=1, log_to_screen=False, n_future=0,
        **overrides)
    tp, jp = TYParams(yaml, name), JYParams(yaml, name)
    for p in (tp, jp):
        p.update_params(common)
    jparse(jp.metadata_json_path, jp)
    return jp, tp


@pytest.fixture(scope="module")
def smoke_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    tsynth.make_dataset(str(root), img_shape=(36, 72), n_samples_per_year=TRAIN_STEPS + 1,
                        n_valid_samples=5, mode="ar", fmt="h5", seed=5)
    return root


def _determined(key, g):
    """The elements whose first gradient is at least SIGN_FLOOR of their
    leaf's largest. A ViT's fused qkv leaf is taken as its q, k and v thirds,
    whose gradients differ by orders of magnitude at init; the k third of
    its bias has an exact gradient of zero (the softmax of a row is blind to
    a constant added to its logits), so both sides hold rounding noise and
    Adam turns it into full steps of either sign: it is checked finite
    only."""
    if ".attn.qkv." not in key:
        return np.abs(g) >= SIGN_FLOOR * np.abs(g).max()
    parts = [np.abs(p) >= SIGN_FLOOR * np.abs(p).max() for p in np.split(g, 3, axis=-1)]
    return np.concatenate(parts, axis=-1) & ~_structural_zero(key, g.shape)


def _structural_zero(key, shape):
    """The k third of a ViT's qkv bias (see _determined)."""
    zero = np.zeros(shape, bool)
    if key.endswith(".attn.qkv.bias"):
        zero[shape[-1] // 3: 2 * shape[-1] // 3] = True
    return zero


def assert_trainer_steps_match(jp, tp, kind):
    """TRAIN_STEPS steps of the port's Trainer against makani_tpu's, on the
    batches each reads from the files, from the same weights and optimizer
    state: the losses, and the updates of every leaf after each step."""
    from makani_tpu.parallel import comm
    from makani_tpu.utils.trainer import Trainer as JTrainer
    from makani_tpu_torch.utils.trainer import Trainer
    comm.reset()
    comm.init(devices=jax.devices()[:1])
    try:
        jtrainer = JTrainer(jp, world_rank=0)
        trainer = Trainer(tp, device="cpu")
        assert type(trainer.model.model).__name__ == kind
        for key in ("N_in_channels", "N_out_channels", "img_crop_shape_x", "img_crop_shape_y"):
            assert getattr(trainer.params, key) == getattr(jtrainer.params, key), key
        assert (trainer.params.img_crop_shape_x, trainer.params.img_crop_shape_y) == (32, 72)
        load_jax_params(trainer.model, {k: np.asarray(v) for k, v in
                                        flatten_dict(jtrainer.model_params, sep="/").items()})
        state = jtrainer.opt_state[0]
        load_jax_opt_state(trainer.adam_state(), trainer.model, {
            "count": int(state.count),
            **{n: {k: np.asarray(v, np.float32)
                   for k, v in flatten_dict(getattr(state, n), sep="/").items()}
               for n in ("mu", "nu")}})
        start = {k: p.detach().clone() for k, p in trainer.model_params.items()}
        jstart = _as_port(jtrainer.model_params)
        jparams, jstate = jtrainer.model_params, jtrainer.opt_state
        steps = 0
        for step, (tbatch, jbatch) in enumerate(zip(trainer.train_dataloader,
                                                    jtrainer.train_dataloader), start=1):
            for a, b in zip(tbatch, jbatch):
                np.testing.assert_array_equal(a, b)
            lr = trainer.scheduler(step)
            if step == 1:
                _, g1 = trainer.loss_and_grads(*trainer._device_batch(tbatch))
                determined = {k: _determined(k, g.numpy()) for k, g in g1.items()}
                # the spectral MLP's outputs under the softshrink threshold
                # have an exact gradient of zero: no update on either side
                still = {k: (g.numpy() == 0) & ~_structural_zero(k, g.shape)
                         for k, g in g1.items()}
            loss = trainer.train_step(*trainer._device_batch(tbatch), lr)
            jparams, jstate, jloss = jtrainer.train_step(
                jparams, jstate, *jtrainer._device_batch(jbatch), jnp.float32(lr),
                jax.random.fold_in(jtrainer.dropout_key, step))
            np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_TOL)
            want = _as_port(jparams)
            for k, p in trainer.model_params.items():
                du = p.detach().numpy() - start[k].numpy()
                keep = determined[k]
                jdu = want[k] - jstart[k]
                covered = keep | still[k] | _structural_zero(k, du.shape)
                assert np.isfinite(du).all() and covered.mean() > 0.9, (step, k)
                if step == 1:
                    assert not du[still[k]].any() and not jdu[still[k]].any(), k
                assert (np.linalg.norm((du - jdu)[keep])
                        <= UPDATE_TOL * np.linalg.norm(jdu[keep])), (step, k)
            steps = step
        assert steps == TRAIN_STEPS and trainer.adam_state().count == TRAIN_STEPS
    finally:
        comm.reset()


def test_afno_smoke_trainer_steps_match_jax(smoke_dataset):
    jp, tp = smoke_configs(AFNO_YAML, "afno_smoke", smoke_dataset)
    assert_trainer_steps_match(jp, tp, "AdaptiveFourierNeuralOperatorNetV1")
