"""makani_tpu_torch's FFT pairs and its other model families on spatial ranks
against serial makani_tpu.

makani_tpu runs its FFT pair's distributed branch (makani_tpu/ops/fft.py:
33-54, 80-104) and the FNO, AFNO and ViT families on a spatial mesh through
its partitioner, and its own gates hold them to the serial results
(tests/test_distributed.py:59, :80). The port writes the moves out; here each
rank's block of the output and of every gradient is held against the same
block of serial makani_tpu's, run in this process on the CPU. The port runs
as spawned ranks on the CPU (tests/torch_port_parallel_ranks.py, gloo, no
JAX imported): one spawn of h 2 x w 2 for every case, one of h 2 x fin 2 for
the mixed layout; the one makani_tpu Trainer is serial. Initial weights are makani_tpu's, carried as
load_jax_params carries them (tools/convert_jax_params._map_flat).

Cases, each dimension a size of its own and the splits uneven where the
family allows it:
  - the FFT2 pair at test_distributed.py's shapes, (lmax, mmax) (32, 33)
    and (16, 17), and on 33 x 70 at (15, 13); the FFT3 pair at its shape:
    the coefficients, the round trip and the input's gradient;
  - the planar FNO (diagonal filter, l over h and m over w);
  - AFNO v2 with LayerNormHW (statistics over the whole (H, W), its affine
    cut to a rank's patch), hard_thresholding_fraction 0.5 (the mode mask
    at the modes' global indices), its spectral weights scaled by
    SPECTRAL_GAIN as tests/test_torch_port_afno.py scales them;
  - PrecipNet over AFNO v1 (the halo at both global latitude edges and
    across the longitude wrap);
  - the ViT at 2,100 tokens (above min_blockwise_tokens) with key blocks of
    ATTN_BLOCK, so that the blockwise recurrence and its padded last block
    run across ranks;
  - InstanceNorm2d at "bf16" statistics on bf16 inputs (one all-reduce of
    the sums and the count);
  - dropout in training: AFNO v1 and a small ViT (attention dropout on)
    against the serial port under the same key (the masks are the port's
    own, ROADMAP Queue 3 divergence 8);
  - h 2 x fin 2: the ViT (its channels over fin beside the spatial split);
  - two Trainer steps of afno_smoke (AFNO v1) on h 2 x w 2 against
    makani_tpu's serial Trainer, and the Inferencer's scored epoch there
    against the serial port's (the validation loss and the files rank 0
    writes of the whole field);
  - networks registered from a file (FILE_NETS), which set no
    spatially_parallel and so run on the whole field on every rank
    (spmd.whole_field), through get_model: a non-local one (a 3x3
    convolution periodic in longitude and zero-padded in latitude, plus the
    mean over (H, W) of a 1x1 mix, plus a pointwise MLP whose `mlp.fc1`
    leaf a channel rule would cut) on h 2 x w 2 and on h 2 x fin 2 against
    makani_tpu's registration of the same file's flax class, every leaf
    whole and the state dict's keys the serial ones; the same net run on
    the patch alone, which must miss; its 2-step MultiStepWrapper unroll on
    h 2 x w 2 against the serial port's, with a control by the same ranks
    without the gathered field's copy_to, which must miss the gradients;
    and a 1-block port SFNO held in a file class, recomputed in backward
    (checkpointing 3), against the serial port.

Tolerances: the FFT pairs at makani_tpu's own gate, rtol and atol 1e-5
(the port's distributed DFTs are float32 matmuls, makani_tpu's serial ones
FFTs; their gap reads ~1e-6); the networks' forwards at the same gate's
2e-4 (tests/test_distributed.py:188), their gradients within GRAD_TOL (2e-4,
tests/test_torch_port_afno.py's) of each leaf's largest magnitude, a rank's
shard of a split leaf against the same block of serial makani_tpu's, a ViT
qkv leaf as its q, k and v thirds (their gradients lie orders of magnitude
apart at init, so a bound on the whole leaf would not see the k third), a
gradient that is exactly zero (ZERO_GRAD: biases that a norm removes; the k
third of the qkv bias, a constant added to a softmax row) against the
model's largest; the dropout runs the same against the serial port; the bf16 norm against makani_tpu's serial one by
test_torch_port_norm_stats.py's bounds, its forward within one bf16 ulp of
the largest output (2**-7 of it: the patch sums reach the float32 mean in
another order, and a mean or scale may round to the other bf16 neighbour);
the Trainer by tests/test_torch_port_train.py's bounds; the scored epoch by
tests/test_torch_port_parallel_trainer.py's (the loss rtol 1e-5, the files
rtol 1e-4 and atol 1e-6: sums in another order); the networks from a file
by the networks' bounds, the serial port's unroll and SFNO as makani_tpu's
(test_torch_port_multistep.py holds the port's unroll to makani_tpu's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from makani_tpu_torch.tools.convert_jax_params import _map_flat

from test_torch_port_train import SIGN_FLOOR, STEP_LOSS_TOL, UPDATE_TOL, _as_port
from torch_port_parallel_ranks import run_cases, run_ranks

SPATIAL = [2, 2, 1, 1]
H_FIN = [2, 1, 2, 1]
FFT_CASES = [("fft2", (2, 3, 32, 64), dict(lmax=32, mmax=33), 1),
             ("fft2", (2, 3, 32, 64), dict(lmax=16, mmax=17), 1),
             ("fft2", (2, 5, 33, 70), dict(lmax=15, mmax=13), 3),
             ("fft3", (2, 3, 4, 16, 32), dict(ldmax=4, lhmax=8, lwmax=9), 2)]
FNO = dict(inp_shape=(17, 38), out_shape=(17, 38), scale_factor=2, inp_chans=3, out_chans=5,
           embed_dim=12, num_layers=2, operator_type="diagonal", spectral_transform="fft",
           normalization_layer="instance_norm", use_mlp=True, mlp_ratio=1.5)
# token grid (6, 8): 3 + 3 rows and 4 + 4 columns a rank, modes l 3 + 3,
# m 3 + 2
AFNO2 = dict(inp_shape=(24, 32), patch_size=(4, 4), inp_chans=3, out_chans=2, embed_dim=32,
             num_layers=2, num_blocks=8, hard_thresholding_fraction=0.5,
             normalization_layer="layer_norm")
# token grid (6, 10)
AFNO1 = dict(inp_shape=(24, 40), patch_size=(4, 4), inp_chans=3, out_chans=4, embed_dim=16,
             num_layers=2, num_blocks=4, hard_thresholding_fraction=0.5)
PRECIP_OUT = 2
# token grid (42, 50): 2,100 tokens, 525 a rank
VIT = dict(inp_shape=(84, 100), patch_size=(2, 2), inp_chans=3, out_chans=2, embed_dim=16,
           depth=2, num_heads=2)
ATTN_BLOCK = 512
VIT_DROP = dict(inp_shape=(16, 24), patch_size=(4, 4), inp_chans=3, out_chans=2, embed_dim=16,
                depth=2, num_heads=2, mlp_drop_rate=0.2, attn_drop_rate=0.2, path_drop_rate=0.2)
AFNO1_DROP = dict(AFNO1, drop_rate=0.2, drop_path_rate=0.2)
# the DropoutKey seed of each dropout case
DROP_SEEDS = {"afno1": 21, "vit": 22}
SPECTRAL_GAIN = 25.0
SMOKE_STEPS = 2
GRAD_TOL = 2e-4
NORM_SHAPE = (2, 5, 12, 20)
ZERO_GRAD = ("mlp.fc2.bias", "filter.b1", "skip_bias", "norm1.bias")
MOD = "makani_tpu_torch.models.networks."
# the networks registered from a file: (B, C, H, W) inputs, H and W split
# unevenly (13: 7 + 6, 21: 11 + 10); FILE_OUT output channels where one
# step is taken, the input's where the unroll feeds the output back
FILE_SHAPE = (2, 4, 13, 21)
FILE_OUT = 5
FILE_WIDTH = 6
# A file registered in both packages; `__getattr__` builds the class asked
# for, so each package imports only its own framework
FILE_NETS = """
import inspect


def __getattr__(name):
    if name == "FileNet":
        return _torch_net()
    if name == "JaxFileNet":
        return _flax_net()
    if name == "FileSFNO":
        return _torch_sfno()
    raise AttributeError(name)


def _torch_net():
    import torch
    from torch import nn

    class Weight(nn.Module):
        def __init__(self, shape, device, generator):
            super().__init__()
            self.weight = nn.Parameter(
                0.3 * torch.randn(shape, device=device, generator=generator))

    class FileNet(nn.Module):
        def __init__(self, inp_chans, out_chans, embed_dim=2, device="cpu", generator=None):
            super().__init__()
            kw = dict(device=device, generator=generator)
            self.conv = Weight((out_chans, inp_chans, 3, 3), **kw)
            self.mix = Weight((out_chans, inp_chans), **kw)
            self.mlp = nn.ModuleDict({"fc1": Weight((embed_dim, inp_chans), **kw),
                                      "fc2": Weight((out_chans, embed_dim), **kw)})

        def forward(self, x, deterministic=True):
            xp = nn.functional.pad(x, (1, 1, 0, 0), mode="circular")
            y = nn.functional.conv2d(nn.functional.pad(xp, (0, 0, 1, 1)), self.conv.weight)
            y = y + torch.einsum("oc,bc->bo", self.mix.weight, x.mean((-2, -1)))[..., None, None]
            h = torch.tanh(torch.einsum("kc,bchw->bkhw", self.mlp["fc1"].weight, x))
            return y + torch.einsum("ok,bkhw->bohw", self.mlp["fc2"].weight, h)

    return FileNet


def _flax_net():
    import jax
    import jax.numpy as jnp
    import flax.linen as nn

    normal = nn.initializers.normal(0.3)
    hi = jax.lax.Precision.HIGHEST

    class Weight(nn.Module):
        shape: tuple

        @nn.compact
        def __call__(self):
            return self.param("weight", normal, self.shape)

    class Mlp(nn.Module):
        shapes: tuple

        @nn.compact
        def __call__(self, x):
            fc1, fc2 = (Weight(shape, name=n)() for n, shape in zip(("fc1", "fc2"), self.shapes))
            h = jnp.tanh(jnp.einsum("kc,bchw->bkhw", fc1, x, precision=hi))
            return jnp.einsum("ok,bkhw->bohw", fc2, h, precision=hi)

    class JaxFileNet(nn.Module):
        inp_chans: int = 2
        out_chans: int = 2
        embed_dim: int = 2

        @nn.compact
        def __call__(self, x, deterministic=True):
            o, c, k = self.out_chans, self.inp_chans, self.embed_dim
            conv = Weight((o, c, 3, 3), name="conv")()
            xp = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (1, 1)), mode="wrap")
            xp = jnp.pad(xp, ((0, 0), (0, 0), (1, 1), (0, 0)))
            y = jax.lax.conv_general_dilated(xp, conv, (1, 1), "VALID", precision=hi,
                                             dimension_numbers=("NCHW", "OIHW", "NCHW"))
            mix = Weight((o, c), name="mix")()
            y = y + jnp.einsum("oc,bc->bo", mix, x.mean((-2, -1)), precision=hi)[..., None, None]
            return y + Mlp(((k, c), (o, k)), name="mlp")(x)

    return JaxFileNet


def _torch_sfno():
    import torch
    from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet

    class FileSFNO(torch.nn.Module):
        # the port's SFNO by composition: this class sets no spatially_parallel
        def __init__(self, device="cpu", generator=None, **kwargs):
            super().__init__()
            self.net = SphericalFourierNeuralOperatorNet(device=device, generator=generator,
                                                         **kwargs)

        def forward(self, x, deterministic=True):
            return self.net(x, deterministic=deterministic)

    # get_model passes the config's keys that the SFNO takes
    FileSFNO.__init__.__signature__ = inspect.signature(SphericalFourierNeuralOperatorNet.__init__)
    return FileSFNO
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _input(kwargs, seed):
    return np.random.RandomState(seed).randn(
        2, kwargs["inp_chans"], *kwargs["inp_shape"]).astype(np.float32)


def _reference(jmodel, template, x, scale=None, **apply_kw):
    """Serial makani_tpu: (the port's whole state from makani_tpu's initial
    weights, the output, the gradients of mean(y**2) in the port's names and
    layout). `scale` maps a flax leaf path to a factor for it."""
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    if scale is not None:
        params = jax.tree_util.tree_map_with_path(lambda p, a: a * scale(p), params)

    def fwd(p, a):
        return jmodel.apply({"params": p}, a, **apply_kw)

    y = np.asarray(jax.jit(fwd)(params, jnp.asarray(x)))
    g = jax.jit(jax.grad(lambda p, a: jnp.mean(fwd(p, a) ** 2)))(params, jnp.asarray(x))
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    gflat = {k: np.asarray(v) for k, v in flatten_dict(g, sep="/").items()}
    return (_map_flat(template, flat, "parameters"), y,
            _map_flat(template, gflat, "gradients"))


def _spectral_gain(path):
    return SPECTRAL_GAIN if path[-1].key in ("w1", "w2") else 1.0


@pytest.fixture(scope="module")
def refs():
    """Serial makani_tpu's runs of every network of the file."""
    from makani_tpu.models.common import attention as jattention
    from makani_tpu.models.networks import FourierNeuralOperatorNet as JFNO
    from makani_tpu.models.networks import afnonet as jafno
    from makani_tpu.models.networks.afnonet_v2 import AdaptiveFourierNeuralOperatorNet as JA2
    from makani_tpu.models.networks.vit import VisionTransformer as JViT
    from makani_tpu.parallel import comm as jcomm
    from makani_tpu_torch.models.networks.afnonet import (
        AdaptiveFourierNeuralOperatorNetV1 as TA1,
        PrecipNet as TPrecip,
    )
    from makani_tpu_torch.models.networks.afnonet_v2 import (
        AdaptiveFourierNeuralOperatorNet as TA2,
    )
    from makani_tpu_torch.models.networks.sfnonet import FourierNeuralOperatorNet as TFNO
    from makani_tpu_torch.models.networks.vit import VisionTransformer as TViT
    jcomm.reset()
    out = {}
    x = _input(FNO, 1)
    out["fno"] = (*_reference(JFNO(**FNO), TFNO(**FNO).state_dict(), x), x)
    x = _input(AFNO2, 2)
    out["afno2"] = (*_reference(JA2(**AFNO2), TA2(**AFNO2).state_dict(), x, _spectral_gain,
                                deterministic=True), x)
    x = _input(AFNO1, 3)
    jprecip = jafno.PrecipNet(backbone=jafno.AdaptiveFourierNeuralOperatorNetV1(**AFNO1),
                              out_chans=PRECIP_OUT)
    out["precip"] = (*_reference(jprecip, TPrecip(TA1(**AFNO1), out_chans=PRECIP_OUT)
                                 .state_dict(), x, deterministic=True), x)
    x = _input(VIT, 4)
    prev = jattention._DEFAULT_BLOCK_SIZE
    jattention.set_attention_block_size(ATTN_BLOCK)
    try:
        out["vit"] = (*_reference(JViT(**VIT), TViT(**VIT).state_dict(), x,
                                  deterministic=True), x)
    finally:
        jattention.set_attention_block_size(prev)
    return out


def _net(ref, module, name, kwargs, dropout_seed=None):
    state, _, _, x = ref
    return ("network_forward_and_grads", (module, name, dict(kwargs), state, x, "xla",
                                          "highest", dropout_seed))


@pytest.fixture(scope="module")
def drop_states():
    """The dropout cases' weights, drawn by the port, and their inputs."""
    from makani_tpu_torch.models.networks.afnonet import AdaptiveFourierNeuralOperatorNetV1
    from makani_tpu_torch.models.networks.vit import VisionTransformer
    out = {}
    for name, cls, kw, seed in (("afno1", AdaptiveFourierNeuralOperatorNetV1, AFNO1_DROP, 5),
                                ("vit", VisionTransformer, VIT_DROP, 6)):
        net = cls(**kw, generator=torch.Generator().manual_seed(seed))
        out[name] = (net, {k: v.detach().numpy().copy() for k, v in net.state_dict().items()},
                     _input(kw, seed))
    return out


def _norm_inputs():
    rng = np.random.RandomState(12)
    x = (rng.randn(*NORM_SHAPE) * 1.7 + 0.6).astype(np.float32)
    w = (1.0 + 0.3 * rng.randn(NORM_SHAPE[1])).astype(np.float32)
    b = (0.2 * rng.randn(NORM_SHAPE[1])).astype(np.float32)
    return x, w, b, rng.randn(*NORM_SHAPE).astype(np.float32)


def _file_config(path, cls, out, **overrides):
    """The port's flagship_synth_drive_bare config at the file's shapes,
    nettype the file's `cls`, `out` output channels."""
    from makani_tpu_torch.models import model_registry as tregistry
    from makani_tpu_torch.utils.yparams import YParams as TYParams
    _, c, h, w = FILE_SHAPE
    tp = TYParams("config/sfnonet.yaml", "flagship_synth_drive_bare")
    tp.update_params(dict(nettype=f"{path}:{cls}", img_shape_x=h, img_shape_y=w,
                          embed_dim=FILE_WIDTH, num_layers=1, in_channels=list(range(c)),
                          out_channels=list(range(out)), global_seed=7, **overrides))
    return tregistry.update_channel_params(tp)


def _serial_port(tp, x, unroll=False):
    """The serial port's stepper for `tp` from its own seeded weights: (the
    config, its state, x, its output, the gradients of mean(y**2))."""
    from makani_tpu_torch.models import model_registry as tregistry
    model = tregistry.get_model(tp, device="cpu")
    y = model(torch.from_numpy(x), deterministic=not unroll)
    y.square().mean().backward()
    return (tp.to_dict(), {k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
            x, y.detach().numpy(), {k: p.grad.numpy() for k, p in model.named_parameters()})


@pytest.fixture(scope="module")
def file_nets(tmp_path_factory):
    """The networks registered from FILE_NETS: makani_tpu's serial run of
    its flax class (the port's state from its initial weights, output and
    gradients, and the serial port's state-dict keys); the serial port's
    2-step unroll, and its 1-block SFNO held in a file class at
    checkpointing 3. Both registries forget the file's classes after."""
    from makani_tpu.models import model_registry as jregistry
    from makani_tpu.utils.yparams import YParams as JYParams
    from makani_tpu_torch.models import model_registry as tregistry
    path = tmp_path_factory.mktemp("file_nets") / "file_nets.py"
    path.write_text(FILE_NETS)
    names = [f"{path}:{cls}" for cls in ("FileNet", "JaxFileNet", "FileSFNO")]
    try:
        tp = _file_config(path, "FileNet", FILE_OUT)
        jp = JYParams("config/sfnonet.yaml", "flagship_synth_drive_bare")
        jp.update_params(dict(tp.to_dict(), nettype=names[1]))
        template = tregistry.get_model(tp, device="cpu").state_dict()
        x = np.random.RandomState(31).randn(*FILE_SHAPE).astype(np.float32)
        state, y, grads = _reference(jregistry.get_model(jp), template, x)
        yield dict(
            net=(tp.to_dict(), state, x, y, grads, list(template)),
            unroll=_serial_port(_file_config(path, "FileNet", FILE_SHAPE[1], n_future=1),
                                np.random.RandomState(32).randn(*FILE_SHAPE)
                                .astype(np.float32), unroll=True),
            sfno=_serial_port(_file_config(path, "FileSFNO", FILE_OUT, checkpointing=3),
                              np.random.RandomState(33).randn(*FILE_SHAPE).astype(np.float32)))
    finally:
        for registry in (tregistry._model_registry, jregistry._model_registry):
            for name in names:
                registry.pop(name, None)


def _file_case(case, **kw):
    tp, state, x = case[:3]
    return ("registered_model", (tp, state, x, *(kw.get(k, False) for k in (
        "unroll", "control", "patch_only"))))


@pytest.fixture(scope="module")
def spatial(refs, drop_states, smoke, file_nets):
    """Every case of h 2 x w 2, one spawn of the ranks."""
    vit = _net(refs["vit"], MOD + "vit", "VisionTransformer", VIT)
    cases = [("fft_pairs", (FFT_CASES,)),
             _net(refs["fno"], MOD + "sfnonet", "FourierNeuralOperatorNet", FNO),
             _net(refs["afno2"], MOD + "afnonet_v2", "AdaptiveFourierNeuralOperatorNet", AFNO2),
             _net(refs["precip"], "torch_port_parallel_ranks", "precipnet",
                  dict(AFNO1, precip_out_chans=PRECIP_OUT)),
             ("with_attention_block", (ATTN_BLOCK, *vit)),
             ("norm_bf16", _norm_inputs())]
    for name, module, cls, kw in (
            ("afno1", MOD + "afnonet", "AdaptiveFourierNeuralOperatorNetV1", AFNO1_DROP),
            ("vit", MOD + "vit", "VisionTransformer", VIT_DROP)):
        _, state, x = drop_states[name]
        cases.append(("network_forward_and_grads", (module, cls, dict(kw), state, x, "xla",
                                                    "highest", DROP_SEEDS[name])))
    cases += [_file_case(file_nets["net"], patch_only=True),
              _file_case(file_nets["unroll"], unroll=True),
              _file_case(file_nets["unroll"], unroll=True, control=True),
              _file_case(file_nets["sfno"])]
    ranks = run_ranks(run_cases, SPATIAL, 4, cases + smoke["cases"])
    names = ("fft", "fno", "afno2", "precip", "vit", "norm", "afno1_drop", "vit_drop", "file_net",
             "file_unroll", "file_control", "file_sfno", "trainer", "scores")
    return {name: [r[i] for r in ranks] for i, name in enumerate(names)}


@pytest.fixture(scope="module")
def h_fin(refs, file_nets):
    vit = _net(refs["vit"], MOD + "vit", "VisionTransformer", VIT)
    ranks = run_ranks(run_cases, H_FIN, 4, [("with_attention_block", (ATTN_BLOCK, *vit)),
                                            _file_case(file_nets["net"])])
    return {name: [r[i] for r in ranks] for i, name in enumerate(("vit", "file_net"))}


def _block(a, lat, lon):
    return a[..., lat[0]:lat[0] + lat[1], lon[0]:lon[0] + lon[1]]


def _shard(ref, key, shards):
    if key not in shards:
        return ref
    index = [slice(None)] * ref.ndim
    for s in shards[key].splits:
        index[s.dim] = slice(s.start, s.start + s.length)
    return ref[tuple(index)]


def _check_forward(ranks, y, tol=2e-4):
    for rank in ranks:
        block = _block(y, rank["lat"], rank["lon"])
        assert rank["y"].shape == block.shape
        np.testing.assert_allclose(rank["y"], block, rtol=tol, atol=tol)


def _parts(key, a):
    """A leaf's gradient, or a ViT qkv leaf's as its q, k and v thirds, whose
    gradients lie orders of magnitude apart at init."""
    if ".attn.qkv." in key:
        return list(zip("qkv", np.split(a, 3, axis=-1)))
    return [("", a)]


def _check_grads(ranks, want):
    """Every rank's gradient of every leaf (its shard of a split one)
    against serial makani_tpu's, within GRAD_TOL of the leaf's (or qkv
    third's) largest magnitude, one whose exact gradient is zero against the
    model's largest; returns {split leaf: its splits}."""
    largest = max(np.abs(w).max() for w in want.values())
    split = {}
    for rank in ranks:
        assert set(rank["grads"]) == set(want)
        for key, got in rank["grads"].items():
            ref = _shard(want[key], key, rank["shards"])
            assert got.shape == ref.shape, key
            if key in rank["shards"]:
                split[key] = tuple((s.dim, s.axis) for s in rank["shards"][key].splits)
            for (part, g), (_, r) in zip(_parts(key, got), _parts(key, ref)):
                scale = np.abs(r).max()
                if key.endswith(ZERO_GRAD) or (key.endswith("qkv.bias") and part == "k"):
                    scale = largest
                assert np.abs(g - r).max() <= GRAD_TOL * scale, (key, part)
    return split


# --------------------------------------------------------------------------
# the transforms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(FFT_CASES)),
                         ids=["fft2-32x33", "fft2-16x17", "fft2-33x70-15x13", "fft3"])
def test_distributed_fft_pairs_match_serial_jax(spatial, case):
    """Each rank's coefficient block, round-trip patch and input gradient
    against makani_tpu's serial transforms (its test_distributed.py gate)."""
    from makani_tpu.ops import InverseRealFFT2, RealFFT2
    from makani_tpu.ops.fft3d import InverseRealFFT3, RealFFT3
    kind, shape, kw, seed = FFT_CASES[case]
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    pair = (RealFFT2, InverseRealFFT2) if kind == "fft2" else (RealFFT3, InverseRealFFT3)
    fwd, inv = (cls(*shape[2:], **kw) for cls in pair)
    y = np.asarray(jax.jit(fwd.__call__)(jnp.asarray(x)))
    back = np.asarray(jax.jit(lambda v: inv(fwd(v)))(jnp.asarray(x)))
    grad = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(inv(fwd(v)) ** 2)))(jnp.asarray(x)))
    for ranks in spatial["fft"]:
        rank = ranks[case]
        np.testing.assert_allclose(rank["coeffs"], _block(y, rank["l"], rank["m"]),
                                   rtol=1e-5, atol=1e-5)
        for got, want in ((rank["back"], back), (rank["grad"], grad)):
            np.testing.assert_allclose(got, _block(want, rank["lat"], rank["lon"]),
                                       rtol=1e-5, atol=1e-5)


def test_fft_pairs_raise_on_a_patch_of_another_rank(monkeypatch):
    """Under a spatial decomposition a patch of another rank than 4 (5 for
    the 3D pair) cannot be transformed alone: it raises."""
    from makani_tpu_torch.ops.fft import RealFFT2
    from makani_tpu_torch.ops.fft3d import RealFFT3
    from makani_tpu_torch.parallel import spmd
    monkeypatch.setattr(spmd, "spatial_distributed", lambda: True)
    with pytest.raises(ValueError, match="4-D"):
        RealFFT2(8, 16)(torch.zeros(3, 8, 16))
    with pytest.raises(ValueError, match="5-D"):
        RealFFT3(4, 8, 16)(torch.zeros(2, 4, 8, 16))


# --------------------------------------------------------------------------
# the networks
# --------------------------------------------------------------------------

def test_fno_on_spatial_ranks_matches_serial_jax(refs, spatial):
    _, y, grads, _ = refs["fno"]
    ranks = spatial["fno"]
    _check_forward(ranks, y)
    split = _check_grads(ranks, grads)
    # the diagonal filter (i, o, l, m, 2): l over h, m over w
    assert split == {f"blocks.{i}.filter_layer.filter.weight": ((2, "h"), (3, "w"))
                     for i in range(2)}


def test_afno_v2_on_spatial_ranks_matches_serial_jax(refs, spatial):
    _, y, grads, _ = refs["afno2"]
    ranks = spatial["afno2"]
    _check_forward(ranks, y)
    # makani_tpu's rules split no leaf over h or w: LayerNormHW's affine and
    # the (1, C, N) embedding stay whole, their gradients summed
    assert _check_grads(ranks, grads) == {}


def test_precipnet_on_spatial_ranks_matches_serial_jax(refs, spatial):
    _, y, grads, _ = refs["precip"]
    ranks = spatial["precip"]
    assert (y == 0).any()
    _check_forward(ranks, y)
    _check_grads(ranks, grads)
    # every rank holds a global latitude edge and a longitude wrap
    assert {r["lat"][0] for r in ranks} == {0, 12} and {r["lon"][0] for r in ranks} == {0, 20}


def test_vit_blockwise_attention_on_spatial_ranks_matches_serial_jax(refs, spatial):
    _, y, grads, _ = refs["vit"]
    ranks = spatial["vit"]
    _check_forward(ranks, y)
    assert _check_grads(ranks, grads) == {}


def test_vit_on_h_and_fin_ranks_matches_serial_jax(refs, h_fin):
    """The spatial split beside the channel split over fin."""
    _, y, grads, _ = refs["vit"]
    _check_forward(h_fin["vit"], y)
    split = _check_grads(h_fin["vit"], grads)
    assert split["pos_embed"] == ((2, "fin"),)
    assert not any(ax in ("h", "w") for dims in split.values() for _, ax in dims)


@pytest.mark.parametrize("name", ["afno1", "vit"])
def test_dropout_on_spatial_ranks_matches_the_serial_port(drop_states, spatial, name):
    """A training forward's masks, drawn at the whole token grid and cut to
    a rank's tile (the ViT's query rows of its attention included), give the
    serial port's output and gradients under the same key."""
    from makani_tpu_torch.models.common.layers import DropoutKey, use_dropout_key
    net, _, x = drop_states[name]
    net.zero_grad()
    with use_dropout_key(DropoutKey(DROP_SEEDS[name], 1, 0)):
        y = net(torch.from_numpy(x), deterministic=False)
    (y.square().mean()).backward()
    want = {k: p.grad.numpy() for k, p in net.named_parameters()}
    y = y.detach().numpy()
    ranks = spatial[name + "_drop"]
    assert not np.array_equal(y, net(torch.from_numpy(x)).detach().numpy())
    _check_forward(ranks, y)
    for rank in ranks:
        _check_grads([dict(rank, shards={})], want)


# --------------------------------------------------------------------------
# networks registered from a file: the whole field on every rank
# --------------------------------------------------------------------------

def _worst_grad_dev(ranks, want):
    """The largest deviation of any rank's gradient of any leaf from
    `want`'s, relative to that leaf's largest magnitude."""
    return max(np.abs(g - want[k]).max() / np.abs(want[k]).max()
               for r in ranks for k, g in r["grads"].items())


def test_file_class_on_spatial_ranks_matches_serial_jax(file_nets, spatial):
    """The non-local file class on h 2 x w 2 against makani_tpu's
    registration of the same file's flax class: each rank gathers the whole
    field, runs the class on it and keeps its patch; every leaf whole, its
    gradient summed over the ranks; the state dict's keys the serial ones."""
    _, _, _, y, grads, keys = file_nets["net"]
    ranks = spatial["file_net"]
    _check_forward(ranks, y)
    assert _check_grads(ranks, grads) == {}
    assert all(r["keys"] == keys for r in ranks)
    assert {(r["lat"], r["lon"]) for r in ranks} == {((0, 7), (0, 11)), ((0, 7), (11, 10)),
                                                    ((7, 6), (0, 11)), ((7, 6), (11, 10))}


def test_file_class_on_its_patch_alone_misses_serial_jax(file_nets, spatial):
    """The control of the case above: the class run on a rank's patch
    alone, nothing gathered, misses the forward bound on every rank (the
    class is not local: its convolution reads the neighbours' edges and its
    mix the whole field's mean)."""
    y = file_nets["net"][3]
    errs = [np.abs(r["alone"] - _block(y, r["lat"], r["lon"])).max()
            for r in spatial["file_net"]]
    print(f"the file class on the patch alone: max error {errs} (forward bound 2e-4)")
    assert min(errs) > 2e-4


def test_file_class_on_h_and_fin_ranks_matches_serial_jax(file_nets, h_fin):
    """h 2 x fin 2: the rules would cut `mlp.fc1.weight` (6, 4) over fin; the
    class keeps it whole, as every other leaf, and every rank of a fin group
    computes the same output."""
    _, _, _, y, grads, keys = file_nets["net"]
    ranks = h_fin["file_net"]
    _check_forward(ranks, y)
    assert _check_grads(ranks, grads) == {}
    assert all(r["keys"] == keys for r in ranks)
    assert ranks[0]["grads"]["model.mlp.fc1.weight"].shape == (FILE_WIDTH, FILE_SHAPE[1])


def test_file_class_unroll_on_spatial_ranks_matches_the_serial_port(file_nets, spatial):
    """The MultiStepWrapper's 2-step unroll (n_future 1: step 2 runs on step
    1's output) on h 2 x w 2 against the serial port's. The control, run by
    the same ranks, drops the whole field's copy_to: the gather's backward
    then keeps the rank's own share of the input's cotangent, and step 1's
    gradients miss."""
    _, _, _, y, grads = file_nets["unroll"]
    ranks = spatial["file_unroll"]
    _check_forward(ranks, y)
    assert _check_grads(ranks, grads) == {}
    held = _worst_grad_dev(ranks, grads)
    control = _worst_grad_dev(spatial["file_control"], grads)
    print(f"the 2-step unroll: gradients within {held:.3g} of each leaf's largest; without "
          f"copy_to {control:.3g} (bound {GRAD_TOL})")
    assert control > GRAD_TOL


def test_port_sfno_inside_a_file_class_on_spatial_ranks_matches_the_serial_port(
        file_nets, spatial):
    """A 1-block port SFNO held in a file class: inside the whole-field call
    the model axes read serial, so its transforms, norms and filter take
    their serial branches on the whole field, also where checkpointing 3
    recomputes the block in backward; its SpectralConv stays whole."""
    _, _, _, y, grads = file_nets["sfno"]
    ranks = spatial["file_sfno"]
    _check_forward(ranks, y)
    assert _check_grads(ranks, grads) == {}


def test_bf16_norm_stats_on_spatial_ranks_match_serial_jax(spatial):
    """One all-reduce of (sum x, sum x * x, count) over the spatial group."""
    from makani_tpu.models.common import layers as jlayers
    x, w, b, r = _norm_inputs()
    m = jlayers.InstanceNorm2d(num_features=NORM_SHAPE[1])
    v = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}}
    xb, rb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, r))
    opts = {"xla_allow_excess_precision": False}
    jlayers.set_norm_stats_mode("bf16")
    try:
        y = np.asarray(jax.jit(m.apply, compiler_options=opts)(v, xb).astype(jnp.float32))
        gv, gx = jax.jit(jax.grad(lambda v, a: jnp.sum((m.apply(v, a) * rb).astype(jnp.float32)),
                                  argnums=(0, 1)), compiler_options=opts)(v, xb)
    finally:
        jlayers.set_norm_stats_mode("f32")
    gx = np.asarray(gx.astype(jnp.float32))
    jgrads = {k: np.asarray(gv["params"][k]) for k in ("weight", "bias")}
    for rank in spatial["norm"]:
        assert np.abs(rank["y"] - _block(y, rank["lat"], rank["lon"])).max() \
            <= 2.0 ** -7 * np.abs(y).max()
        assert np.abs(rank["gx"] - _block(gx, rank["lat"], rank["lon"])).max() \
            <= 2.0 ** -6 * np.abs(gx).max()
        for k, want in jgrads.items():
            # makani_tpu sums the products in bf16 steps: within its own
            # distance from the float32-accumulated sum (norm_stats tests)
            assert np.abs(rank["grads"][k] - want).max() <= 2.0 ** -4 * np.abs(want).max(), k


# --------------------------------------------------------------------------
# the Trainer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """afno_smoke (AFNO v1, 36x72 cropped to 32x72, patch 4: 16 + 16 rows and
    36 + 36 columns a rank) on a synthetic dataset: makani_tpu's serial
    Trainer, SMOKE_STEPS steps (its initial weights, first gradients, losses
    and weights after each step), the serial port's scored epoch of those
    initial weights, and the ranks' cases (their Trainer steps and scored
    epoch, run in the spawn of `spatial`)."""
    from makani_tpu.parallel import comm as jcomm
    from makani_tpu.utils.dataset_metadata import parse_dataset_metadata as jparse
    from makani_tpu.utils.trainer import Trainer as JTrainer
    from makani_tpu.utils.yparams import YParams as JYParams
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.tools import make_synthetic_dataset as tsynth
    from makani_tpu_torch.utils.inferencer import Inferencer
    from makani_tpu_torch.utils.yparams import YParams as TYParams
    root = tmp_path_factory.mktemp("smoke")
    tsynth.make_dataset(str(root), img_shape=(36, 72), n_samples_per_year=SMOKE_STEPS + 1,
                        n_valid_samples=5, mode="ar", fmt="h5", seed=5)
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
        n_train_samples_per_epoch=SMOKE_STEPS, n_eval_samples=2, valid_autoreg_steps=1,
        skip_validation=True, save_checkpoint="none", num_data_workers=1, log_to_screen=False,
        n_future=0)
    tp, jp = TYParams("config/afnonet.yaml", "afno_smoke"), JYParams("config/afnonet.yaml",
                                                                     "afno_smoke")
    for p in (tp, jp):
        p.update_params(common)
    jparse(jp.metadata_json_path, jp)
    jcomm.reset()
    jcomm.init(devices=jax.devices()[:1])
    try:
        jtrainer = JTrainer(jp, world_rank=0)
        start = _as_port(jtrainer.model_params)
        flat = {k: np.asarray(v) for k, v in flatten_dict(jtrainer.model_params, sep="/").items()}
        jparams, jstate = jax.tree.map(jnp.copy, (jtrainer.model_params, jtrainer.opt_state))
        losses, weights = [], []
        for step, jbatch in enumerate(jtrainer.train_dataloader, start=1):
            batch = jtrainer._device_batch(jbatch)
            if step == 1:
                _, g1 = jtrainer._grad_step(jparams, *batch)
                grads = _as_port(g1)
            jparams, jstate, jloss = jtrainer.train_step(
                jparams, jstate, *batch, jnp.float32(jtrainer.scheduler(step)),
                jax.random.fold_in(jtrainer.dropout_key, step))
            losses.append(float(jloss))
            weights.append(_as_port(jparams))
        resolved = dict(jtrainer.params.to_dict())
    finally:
        jcomm.reset()
    model = get_model(TYParams.from_dict(resolved), device="cpu")
    state = _map_flat(model.state_dict(), flat, "parameters")
    serial_dir, dist_dir = (tmp_path_factory.mktemp(n) for n in ("serial", "ranks"))
    init = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    serial = Inferencer(TYParams.from_dict(dict(tp.to_dict(), experiment_dir=str(serial_dir))),
                        device="cpu", weights=init)
    scored = serial.inference_epoch(output_channels=list(serial.params.out_channels))
    tp_dict = dict(tp.to_dict(), model_parallel_sizes=SPATIAL, world_size=4,
                   experiment_dir=str(dist_dir))
    return dict(start=start, grads=grads, losses=losses, weights=weights,
                loss=scored["base"]["validation loss"], serial_dir=serial_dir, dist_dir=dist_dir,
                cases=[("trainer_steps", (tp_dict, state)), ("validation_loss", (tp_dict, state))])


def test_afno_smoke_trainer_and_scores_on_spatial_ranks(smoke, spatial):
    """SMOKE_STEPS steps of the port's Trainer on h 2 x w 2 against
    makani_tpu's serial Trainer from the same weights; the Inferencer's
    scored epoch of those weights on the same ranks against the serial
    port's."""
    scores = spatial["scores"]
    assert len(set(scores)) == 1
    np.testing.assert_allclose(scores[0], smoke["loss"], rtol=1e-5)
    for name in ("acc_curves.npy", "RMSE_over_space.npy"):
        np.testing.assert_allclose(np.load(smoke["dist_dir"] / name),
                                   np.load(smoke["serial_dir"] / name), rtol=1e-4, atol=1e-6)
    ranks = spatial["trainer"]
    assert all(r["data"] == 1 and not r["shards"] for r in ranks)
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
    got, start, grads = ranks[0], smoke["start"], smoke["grads"]
    np.testing.assert_allclose(got["losses"], smoke["losses"], rtol=STEP_LOSS_TOL)
    for step in range(SMOKE_STEPS):
        for key, w in got["weights"][step].items():
            du, jdu = w - start[key], smoke["weights"][step][key] - start[key]
            assert np.isfinite(du).all(), (step, key)
            keep = np.abs(grads[key]) >= SIGN_FLOOR * np.abs(grads[key]).max()
            assert (np.linalg.norm((du - jdu)[keep])
                    <= UPDATE_TOL * np.linalg.norm(jdu[keep])), (step, key)
