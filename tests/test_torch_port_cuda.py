"""makani_tpu_torch's Hopper kernels against their plain twins, on the card.

Every test here but the last two needs an NVIDIA GPU and nvcc: it is marked
`cuda` and skips without a card; the last two check on the CPU the twins
that the card's no-work test compares with. The file imports neither JAX nor
makani_tpu, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Shapes are small and ragged in every dimension (no multiple of a tile), so the
kernels' zero-filled loads and masked stores are exercised at every edge.
Tolerance: kernel and twin split the same operands into the same bf16 parts,
and every bf16 product is exact in float32; they differ only in the order of
the float32 sums, so the gap is a few ulps of the largest partial sum —
bounded here at 1e-5 relative to the output's largest magnitude. The same
bound holds the differentiable wrappers' gradients on the card against the
twins on the CPU. The fused Adam kernel and its twin perform the same
correctly rounded operations in the same order: bit-identical; so do the bf16
GELU kernels and theirs. A bf16
output (gridmm, grid_dot) rounds the float32 sum once, so kernel and twin may
round to neighbouring bf16 values: they are held to one bf16 ulp of each
element on top of the float32 bound.
"""

import functools

import numpy as np
import pytest
import torch

from makani_tpu_torch.ops import complex_kernels, fused_adam, gelu, kernels, spectral_mm
from makani_tpu_torch.tools import bench_gridmm, bench_spectral_mm, kernel_isolate
from makani_tpu_torch.utils.optimizers import AdamState

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# (C, K, L) across legmm's 128 x 128 tiles: count * C not a multiple of 128
# (C = 130, 200); synthesis N = K > 256 (several column tiles); K and L of a
# pitch that is not a multiple of 4 floats (rows moved by their misalignment
# in shared memory) and of one that is (rows on 16 bytes), in both directions
LEGMM_SHAPES = [(70, 25, 19), (130, 97, 33), (200, 101, 240), (130, 96, 240), (200, 301, 33),
                (130, 300, 240)]


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("contract", ["k", "l"])
@pytest.mark.parametrize("C,K,L", LEGMM_SHAPES)
@pytest.mark.parametrize("rows", ["2mmax", "2mmax-1"])
def test_legmm_kernel_matches_plain(cuda, passes, contract, C, K, L, rows):
    """M2 = 2*mmax (the stacked layout) and 2*mmax - 1 (the last m has one row)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    mmax = 5
    M2 = 2 * mmax if rows == "2mmax" else 2 * mmax - 1
    z = torch.randn((M2, C, K if contract == "k" else L), device=cuda, generator=g)
    p = torch.randn((mmax, L, K), device=cuda, generator=g)
    before = kernels.launches["legmm"]
    got = spectral_mm.legmm(z, p, passes=passes, contract=contract)
    torch.cuda.synchronize()
    assert kernels.launches["legmm"] == before + 1
    want = spectral_mm.legmm_plain(z, p, passes=passes, contract=contract)
    assert _rel(got, want) < TOL


def _sliced_randn(shape, device, gen, dtype=torch.float32, offset=1):
    """A contiguous tensor whose base lies `offset` elements past an
    allocation's start (odd: rows off 16 bytes (float32) or pairs on 8 bytes
    (complex64))."""
    n = int(np.prod(shape))
    return torch.randn(n + offset, device=device, generator=gen,
                       dtype=dtype)[offset:].view(shape)


# (B, L, C, O, M, sliced) across dhconv_gemm.cuh's 128 m x 96 channel blocks
# and 32-deep stages, for wdim 0 (Ci = C, Co = O) and 1 (Ci = O, Co = C):
# Co of 45, 200 and 257 (ragged blocks, one channel past a block) and 70, 97;
# Ci of 70, 97 (ragged stages) and 45, 200, 257; M of 1, 130, 241 (rows off 16
# bytes) and 257 (three m blocks); x sliced from an odd offset
DHCONV_SHAPES = [(2, 3, 70, 45, 130, False), (2, 2, 97, 200, 241, False),
                 (1, 2, 70, 257, 257, False), (2, 3, 97, 45, 1, False),
                 (2, 2, 97, 200, 241, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("m3", [True, False])
@pytest.mark.parametrize("wdim,conj_w", [(0, False), (1, True), (1, False)])
@pytest.mark.parametrize("B,L,C,O,M,sliced", DHCONV_SHAPES)
def test_dhconv_mm_kernel_matches_plain(cuda, passes, m3, wdim, conj_w, B, L, C, O, M, sliced):
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (2, B, L, C if wdim == 0 else O, M)
    x = (_sliced_randn(shape, cuda, g) if sliced
         else torch.randn(shape, device=cuda, generator=g))
    w = torch.randn((2, L, C, O), device=cuda, generator=g)
    before = kernels.launches["dhconv_mm"]
    got = spectral_mm.dhconv_mm(x, w, passes=passes, m3=m3, wdim=wdim, conj_w=conj_w)
    torch.cuda.synchronize()
    assert kernels.launches["dhconv_mm"] == before + 1
    want = spectral_mm.dhconv_mm_plain(x, w, passes=passes, m3=m3, wdim=wdim, conj_w=conj_w)
    assert _rel(got, want) < TOL


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    z = torch.randn((4, 8, 6), device=cuda)
    p = torch.randn((2, 5, 6), device=cuda)
    with pytest.raises(ValueError):
        spectral_mm.legmm(z.transpose(1, 2).contiguous().transpose(1, 2), p)
    with pytest.raises(TypeError):
        spectral_mm.legmm(z.double(), p.double())


# (B, L, C, O, M, cut) across dhconv_dw.cu's 128 x 96 tiles and 32-deep
# stages: C and O of 33, 97, 200 and 384 (ragged and whole tiles); M of 1, 16
# and 17 (one 16-deep step, or a second holding one m), 241 (the flagship:
# rows off 16 bytes, a last step of one m) and 257; B = 3, so the sum over b
# crosses stages; L = 1, and L = 300, more tiles than the persistent grid has
# blocks; x and g cut from a larger contiguous tensor at l = 1 with C M and
# O M odd, so their bases are not on 16 bytes
DW_SHAPES = [(2, 3, 70, 45, 130, False), (1, 2, 33, 64, 241, False), (1, 2, 33, 97, 1, False),
             (1, 2, 97, 33, 16, False), (3, 2, 200, 200, 17, False),
             (1, 1, 384, 384, 241, False), (1, 300, 33, 97, 17, False),
             (2, 2, 97, 200, 257, False), (3, 2, 33, 97, 241, True),
             (1, 3, 97, 33, 257, True)]


def _dw_inputs(B, L, C, O, M, cut, device, gen):
    if not cut:
        return (torch.randn((2, B, L, C, M), device=device, generator=gen),
                torch.randn((2, B, L, O, M), device=device, generator=gen))
    assert (C * M) % 2 == 1 and (O * M) % 2 == 1
    return (_sliced_randn((2, B, L, C, M), device, gen, offset=C * M),
            _sliced_randn((2, B, L, O, M), device, gen, offset=O * M))


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("m3", [True, False])
@pytest.mark.parametrize("B,L,C,O,M,cut", DW_SHAPES)
def test_dhconv_dw_kernel_matches_plain(cuda, passes, m3, B, L, C, O, M, cut):
    g = torch.Generator(device=cuda).manual_seed(2)
    x, cot = _dw_inputs(B, L, C, O, M, cut, cuda, g)
    before = kernels.launches["dhconv_dw"]
    got = spectral_mm.dhconv_dw(x, cot, passes=passes, m3=m3)
    torch.cuda.synchronize()
    assert kernels.launches["dhconv_dw"] == before + 1
    want = spectral_mm.dhconv_dw_plain(x, cot, passes=passes, m3=m3)
    assert _rel(got, want) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("m3", [True, False])
def test_dhconv_dw_kernel_is_deterministic(cuda, m3):
    """The sum over b and m runs inside one accumulator: no atomics, the same
    bits every run."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x, cot = _dw_inputs(3, 40, 200, 200, 241, False, cuda, g)
    first = spectral_mm.dhconv_dw(x, cot, passes=3, m3=m3)
    second = spectral_mm.dhconv_dw(x, cot, passes=3, m3=m3)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("m3", [True, False])
def test_dhconv_dw_ignores_stale_shared_memory(cuda, passes, m3):
    """A NaN-filled call at M = 256 leaves NaN in every staged row; the next
    call, at M = 241 on the same stream and the same blocks, zeroes the depth
    past M in both operands and masks the rows past C: finite, and the twin's
    value."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, L, C, O = 1, 64, 200, 200
    nan_x = torch.full((2, B, L, C, 256), float("nan"), device=cuda)
    nan_g = torch.full((2, B, L, O, 256), float("nan"), device=cuda)
    x, cot = _dw_inputs(B, L, C, O, 241, False, cuda, g)
    spectral_mm.dhconv_dw(nan_x, nan_g, passes=passes, m3=m3)
    got = spectral_mm.dhconv_dw(x, cot, passes=passes, m3=m3)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    want = spectral_mm.dhconv_dw_plain(x, cot, passes=passes, m3=m3)
    assert _rel(got, want) < TOL


def _adam_leaves(gen, device):
    """Odd leaf sizes, a scalar-like leaf and a dhconv weight in the port's
    (2, L, C, O) layout, whose dither index follows makani_tpu's layout, and
    the scanned blocks' stacked one (3, 2, L, C, O), five dimensions that
    the kernel indexes in four."""
    shapes = {"a": (7,), "b.w": (3, 65), "b.v": (2, 3, 129), "c": (1,),
              "model.blocks.0.filter_layer.filter.weight": (2, 5, 6, 7),
              "model.scan_blocks.block.filter_layer.filter.weight": (3, 2, 5, 6, 7)}
    return {k: torch.randn(s, device=device, generator=gen) for k, s in shapes.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("moments,stochastic,wd", [
    (torch.bfloat16, True, 0.0), (torch.bfloat16, False, 0.01), (torch.float32, False, 0.0),
    (torch.float16, False, 0.0), (torch.float16, True, 0.01)])
def test_fused_adam_kernel_bitwise_against_plain(cuda, moments, stochastic, wd):
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = _adam_leaves(gen, cuda)
    twin = {k: v.clone() for k, v in params.items()}

    def state():
        return AdamState(0, {k: torch.zeros_like(v, dtype=moments) for k, v in params.items()},
                         {k: torch.zeros_like(v, dtype=moments) for k, v in params.items()})

    s_kernel, s_twin = state(), state()
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd, stochastic_rounding=stochastic,
              seed=340)
    for step in range(2):
        grads = {k: 0.1 * torch.randn(v.shape, device=cuda, generator=gen)
                 for k, v in params.items()}
        before = kernels.launches["fused_adam"]
        fused_adam.fused_adam_apply(params, grads, s_kernel, 1e-3, **kw)
        torch.cuda.synchronize()
        assert kernels.launches["fused_adam"] == before + len(params)
        fused_adam.fused_adam_apply_plain(twin, grads, s_twin, 1e-3, **kw)
    for k in params:
        assert torch.equal(params[k], twin[k]), k
        assert torch.equal(s_kernel.mu[k], s_twin.mu[k]), k
        assert torch.equal(s_kernel.nu[k], s_twin.nu[k]), k
    assert s_kernel.count == s_twin.count == 2


@pytest.mark.cuda
@pytest.mark.parametrize("moments,stochastic", [(torch.bfloat16, True), (torch.float32, False),
                                                (torch.float16, False)])
@pytest.mark.parametrize("max_norm,lamb", [(2.0, False), (None, True), (2.0, True)])
def test_fused_adam_modes_bitwise_against_plain(cuda, moments, stochastic, max_norm, lamb):
    """The clipping mode (the global norm read by the kernel from the card)
    and the LAMB mode (the direction written, the trust ratio applied after),
    over a clipped step and an unclipped one: bit-identical to the twin."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    params = _adam_leaves(gen, cuda)
    twin = {k: v.clone() for k, v in params.items()}

    def state():
        return AdamState(0, {k: torch.zeros_like(v, dtype=moments) for k, v in params.items()},
                         {k: torch.zeros_like(v, dtype=moments) for k, v in params.items()})

    s_kernel, s_twin = state(), state()
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01, stochastic_rounding=stochastic,
              seed=340, max_norm=max_norm, lamb=lamb)
    for scale in (1.0, 1e-3):   # global norm ~30, then ~0.03: clipped, then not
        grads = {k: scale * torch.randn(v.shape, device=cuda, generator=gen)
                 for k, v in params.items()}
        if max_norm is not None:
            norm = float(fused_adam.global_norm(grads.values()))
            assert (norm >= max_norm) == (scale == 1.0)
        before = kernels.launches["fused_adam"]
        fused_adam.fused_adam_apply(params, grads, s_kernel, 1e-3, **kw)
        torch.cuda.synchronize()
        assert kernels.launches["fused_adam"] == before + len(params)
        fused_adam.fused_adam_apply_plain(twin, grads, s_twin, 1e-3, **kw)
    for k in params:
        assert torch.equal(params[k], twin[k]), k
        assert torch.equal(s_kernel.mu[k], s_twin.mu[k]), k
        assert torch.equal(s_kernel.nu[k], s_twin.nu[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "clip", "lamb"])
def test_fused_adam_float16_subnormal_moments(cuda, mode):
    """float16 moments where nu lies below float16's smallest normal, 3
    updates in each mode (the clip mode scales the gradients, global norm
    ~0.13, by ~0.8): kernel and twin store the same subnormal values, none
    flushed."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    params = _adam_leaves(gen, cuda)
    twin = {k: v.clone() for k, v in params.items()}

    def state():
        return AdamState(0, {k: torch.zeros_like(v, dtype=torch.float16)
                             for k, v in params.items()},
                         {k: torch.zeros_like(v, dtype=torch.float16)
                          for k, v in params.items()})

    s_kernel, s_twin = state(), state()
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01, stochastic_rounding=False, seed=340,
              max_norm=0.1 if mode == "clip" else None, lamb=mode == "lamb")
    for step in range(3):
        grads = {k: 3e-3 * torch.randn(v.shape, device=cuda, generator=gen)
                 for k, v in params.items()}
        fused_adam.fused_adam_apply(params, grads, s_kernel, 1e-3, **kw)
        fused_adam.fused_adam_apply_plain(twin, grads, s_twin, 1e-3, **kw)
    torch.cuda.synchronize()
    nu = torch.cat([v.float().flatten() for v in s_kernel.nu.values()])
    tiny = torch.finfo(torch.float16).tiny
    assert float(((nu > 0) & (nu < tiny)).float().mean()) > 0.5
    for k in params:
        assert torch.equal(params[k], twin[k]), k
        assert torch.equal(s_kernel.mu[k], s_twin.mu[k]), k
        assert torch.equal(s_kernel.nu[k], s_twin.nu[k]), k


@pytest.mark.cuda
def test_fft_pair_on_the_card(cuda):
    """The truncated FFT pair (cuFFT) on the card against the CPU, at a
    small odd grid and at the ICML FNO's input grid (721 x 1440, 180 x 180
    modes): a few float32 ulps of the largest magnitude."""
    from makani_tpu_torch.ops.fft import InverseRealFFT2, RealFFT2
    g = torch.Generator().manual_seed(2)
    for nlat, nlon, lmax, mmax in ((17, 32, 5, 4), (721, 1440, 180, 180)):
        fwd, inv = RealFFT2(nlat, nlon, lmax, mmax), InverseRealFFT2(nlat, nlon, lmax, mmax)
        x = torch.randn((2, 3, nlat, nlon), generator=g)
        want = fwd(x)
        got = fwd(x.to(cuda)).cpu()
        assert float((got - want).abs().max() / want.abs().max()) < TOL
        want_x = inv(want)
        got_x = inv(want.to(cuda)).cpu()
        assert float((got_x - want_x).abs().max() / want_x.abs().max()) < TOL


@pytest.mark.cuda
def test_fft3_pair_on_the_card(cuda):
    """The truncated 3D FFT pair (cuFFT) on the card against the CPU: a few
    float32 ulps of the largest magnitude."""
    from makani_tpu_torch.ops.fft3d import InverseRealFFT3, RealFFT3
    g = torch.Generator().manual_seed(3)
    for case in ((6, 9, 10, 3, 5, 4), (16, 90, 180, 8, 45, 60)):
        fwd, inv = RealFFT3(*case), InverseRealFFT3(*case)
        x = torch.randn((2, *case[:3]), generator=g)
        want = fwd(x)
        got = fwd(x.to(cuda)).cpu()
        assert float((got - want).abs().max() / want.abs().max()) < TOL
        want_x = inv(want)
        got_x = inv(want.to(cuda)).cpu()
        assert float((got_x - want_x).abs().max() / want_x.abs().max()) < TOL


# (N, block, min_blockwise_tokens): the blockwise recurrence with padded
# keys, on whole blocks, and the materialised softmax
ATTENTION_CASES = [(1000, 128, 0), (2100, None, 2048), (1500, None, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,block,min_tokens", ATTENTION_CASES)
def test_attention_on_the_card(cuda, n, block, min_tokens):
    """models/common/attention.py on the card (TF32 off) against the
    materialised softmax in float64, forward and the gradients of q, k and
    v: 1e-5 of the largest magnitude."""
    from makani_tpu_torch.models.common.attention import scaled_dot_product_attention
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, r = (torch.randn((1, 3, n, 64), device=cuda, generator=g) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = scaled_dot_product_attention(*leaves, block_size=block, min_blockwise_tokens=min_tokens)
    (got * r).sum().backward()
    ref = [t.double().requires_grad_() for t in (q, k, v)]
    p = torch.softmax(ref[0] @ ref[1].transpose(-1, -2) * 64 ** -0.5, dim=-1)
    want = p @ ref[2]
    (want * r.double()).sum().backward()
    assert _rel(got.detach().double(), want.detach()) < TOL
    for t, w in zip(leaves, ref):
        assert _rel(t.grad.double(), w.grad) < TOL


@pytest.mark.cuda
def test_afno_v2_amp_on_the_card(cuda):
    """A small AFNO v2 under bf16 AMP on the card: one gelu_bf16 launch a
    block in the forward and one gelu_bf16_grad a block in the backward,
    the output bf16 and within bf16 rounding of the same weights on the CPU
    (the twins; cuFFT and the CPU's FFT may round a few activations to other
    bf16 values)."""
    from makani_tpu_torch.models.networks.afnonet_v2 import AdaptiveFourierNeuralOperatorNet
    net = AdaptiveFourierNeuralOperatorNet(inp_shape=(24, 48), patch_size=(4, 8), inp_chans=3,
                                           out_chans=5, embed_dim=32, num_layers=3, num_blocks=4,
                                           generator=torch.Generator().manual_seed(6))
    x = torch.randn((2, 3, 24, 48), generator=torch.Generator().manual_seed(7)).bfloat16()
    want = net(x).float()
    net = net.to(cuda)
    before = dict(kernels.launches)
    y = net(x.to(cuda))
    assert kernels.launches["gelu_bf16"] == before["gelu_bf16"] + 3
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert kernels.launches["gelu_bf16_grad"] == before["gelu_bf16_grad"] + 3
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()
    assert float((y.float().cpu() - want).norm() / want.norm()) < 1e-2


@pytest.mark.cuda
def test_capture_frames_on_the_card(cuda):
    """A small SFNO Trainer's validation rollout on the card with its frames
    captured (eval_step(..., capture_frames=True), as log_video asks): each
    frame is the prediction and the target its AR step scored, bit for bit,
    on the host; the metrics equal those of the same rollout without capture,
    bit for bit; each AR step launches legmm and dhconv_mm."""
    from makani_tpu_torch.utils.trainer import Trainer
    from makani_tpu_torch.utils.yparams import YParams
    params = YParams("config/sfnonet.yaml", "flagship_synth_drive_bare")
    params.update_params(dict(
        img_shape_x=24, img_shape_y=48, embed_dim=16, num_layers=2, scale_factor=2,
        enable_synthetic_data=True, n_train_samples_per_epoch=2, n_eval_samples=2,
        valid_autoreg_steps=3, save_checkpoint="none", max_epochs=1, num_data_workers=1,
        log_to_screen=False, in_channels=[0, 1, 2], out_channels=[0, 1, 2],
        channel_names=["c0", "c1", "c2"], batch_size=1, dhours=6, log_video=0))
    trainer = Trainer(params, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    batch = trainer._device_batch(next(iter(trainer.valid_dataloader)))
    scored = []
    update = trainer.metrics.update

    def recording(buffers, pred, targ, loss, idt):
        scored.append((pred[0, 0].cpu().numpy(), targ[0, 0].cpu().numpy()))
        return update(buffers, pred, targ, loss, idt)
    trainer.metrics.update = recording
    before = dict(kernels.launches)
    buffers, frames = trainer.eval_step(trainer.metrics.initialize_buffers(), *batch,
                                        capture_frames=True)
    steps = params.valid_autoreg_steps + 1
    assert kernels.launches["legmm"] - before["legmm"] == 6 * steps
    assert kernels.launches["dhconv_mm"] - before["dhconv_mm"] == 2 * steps
    assert len(frames) == len(scored) == steps
    for (pf, tf), (ps, ts) in zip(frames, scored):
        assert isinstance(pf, np.ndarray) and pf.shape == (24, 48) and np.isfinite(pf).all()
        np.testing.assert_array_equal(pf, ps)
        np.testing.assert_array_equal(tf, ts)
    plain = trainer.eval_step(trainer.metrics.initialize_buffers(), *batch)
    assert trainer.metrics.finalize(buffers) == trainer.metrics.finalize(plain)


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
def test_sht_without_csphase_through_legmm(cuda, passes):
    """The SHT pair without the Condon-Shortley phase at the ICML model's
    inner grid (360 x 720 Legendre-Gauss, 180 x 180 modes) through legmm on
    the card: the phased pair with the odd orders negated, bit for bit, and
    the same transforms on the CPU (the kernels' twins) within the bound
    both keep to the exact transform (tests/test_pallas_mm.py's 5e-5 at 3
    passes, 5e-2 at 1: the longitude DFTs differ in float32, and at 1 pass
    their outputs can round to other bf16 values)."""
    from makani_tpu_torch.ops import sht
    g = torch.Generator().manual_seed(5)
    prev = sht.get_transform_precision()
    sht.set_transform_precision("default" if passes == 1 else "high")
    try:
        x = torch.randn((1, 4, ICML_NLAT, 2 * ICML_NLAT), generator=g)
        out = {}
        for dev in ("cpu", cuda):
            for cs in (True, False):
                fwd = sht.RealSHT(ICML_NLAT, 2 * ICML_NLAT, ICML_L, ICML_M, grid="legendre-gauss",
                                  csphase=cs, device=dev)
                inv = sht.InverseRealSHT(ICML_NLAT, 2 * ICML_NLAT, ICML_L, ICML_M,
                                         grid="legendre-gauss", csphase=cs, device=dev)
                before = kernels.launches["legmm"]
                c = fwd(x.to(dev))
                y = inv(c)
                if dev != "cpu":
                    torch.cuda.synchronize()
                    assert kernels.launches["legmm"] == before + 2
                out[str(dev), cs] = c.cpu(), y.cpu()
    finally:
        sht.set_transform_precision(prev)
    sign = (-1.0) ** torch.arange(ICML_M)
    for dev in ("cpu", str(cuda)):
        c_true, y_true = out[dev, True]
        c_false, y_false = out[dev, False]
        assert torch.equal(c_false, c_true * sign)
        # synthesis without the phase of phase-free coefficients: the same field
        assert float((y_false - y_true).abs().max() / y_true.abs().max()) < TOL
    for i in range(2):
        got, want = out[str(cuda), False][i], out["cpu", False][i]
        assert float((got - want).abs().max() / want.abs().max()) < {3: 5e-5, 1: 5e-2}[passes]


@pytest.mark.cuda
def test_lowmem_adam_chain_stays_off_the_card(cuda):
    """The optax-style chain's bf16 Adam emulates XLA's CPU arithmetic in
    float64: it refuses CUDA tensors, where the fused kernel runs the same
    update (LAMB and clipping included)."""
    from makani_tpu_torch.utils import optimizers
    opt = optimizers.build_optimizer({"optimizer_type": "LAMB", "optimizer_max_grad_norm": 1.0,
                                      "optimizer_moment_dtype": "bfloat16"})
    params = {"w": torch.randn((3, 5), device=cuda)}
    state = opt.init(params)
    with pytest.raises(RuntimeError, match="off the card"):
        opt.update({"w": torch.randn((3, 5), device=cuda)}, state, params)


# the ICML SFNO's inner grid (config/icml_models.yaml sfno_dhealy_73ch: 721 x
# 1440 at scale factor 2, a 360 x 720 Legendre-Gauss grid, hard thresholding
# 0.5: 180 degrees and 180 orders) at embed 384, batch 1
ICML_L = ICML_M = 180
ICML_NLAT = 360


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("contract,K", [("k", ICML_NLAT), ("l", ICML_NLAT), ("k", 721)])
def test_legmm_at_icml_shapes(cuda, passes, contract, K):
    """Analysis and synthesis on the inner grid, and the analysis of the
    721-row input grid."""
    g = torch.Generator(device=cuda).manual_seed(9)
    z = torch.randn((2 * ICML_M, 384, K if contract == "k" else ICML_L), device=cuda, generator=g)
    p = torch.randn((ICML_M, ICML_L, K), device=cuda, generator=g)
    got = spectral_mm.legmm(z, p, passes=passes, contract=contract)
    want = spectral_mm.legmm_plain(z, p, passes=passes, contract=contract)
    assert _rel(got, want) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("wdim,conj_w", [(0, False), (1, True)])
def test_dhconv_kernels_at_icml_shapes(cuda, passes, wdim, conj_w):
    """The forward and dx contractions, and the weight gradient, at L = M =
    180 and 384 channels."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((2, 1, ICML_L, 384, ICML_M), device=cuda, generator=g)
    w = torch.randn((2, ICML_L, 384, 384), device=cuda, generator=g)
    got = spectral_mm.dhconv_mm(x, w, passes=passes, wdim=wdim, conj_w=conj_w)
    want = spectral_mm.dhconv_mm_plain(x, w, passes=passes, wdim=wdim, conj_w=conj_w)
    assert _rel(got, want) < TOL
    if wdim == 0:
        cot = torch.randn((2, 1, ICML_L, 384, ICML_M), device=cuda, generator=g)
        got = spectral_mm.dhconv_dw(x, cot, passes=passes)
        assert _rel(got, spectral_mm.dhconv_dw_plain(x, cot, passes=passes)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("contract", ["k", "l"])
def test_legdot_backward_on_card_matches_cpu(cuda, contract):
    rng = np.random.RandomState(4)
    mmax, C, K, L = 5, 70, 97, 33
    z = rng.randn(2 * mmax, C, K if contract == "k" else L).astype(np.float32)
    p = torch.from_numpy(rng.randn(mmax, L, K).astype(np.float32))
    cot = torch.from_numpy(rng.randn(2 * mmax, C, L if contract == "k" else K).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        zt = torch.from_numpy(z).to(dev).requires_grad_()
        spectral_mm.legdot(zt, p.to(dev), contract, 3).backward(cot.to(dev))
        grads.append(zt.grad.cpu())
    assert _rel(grads[1], grads[0]) < TOL


@pytest.mark.cuda
def test_dhconv_backward_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(5)
    B, L, C, O, M = 2, 3, 70, 45, 130
    x = rng.randn(2, B, L, C, M).astype(np.float32)
    w = rng.randn(2, L, C, O).astype(np.float32)
    cot = torch.from_numpy(rng.randn(2, B, L, O, M).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        wt = torch.from_numpy(w).to(dev).requires_grad_()
        spectral_mm.dhconv(xt, wt, 3).backward(cot.to(dev))
        grads.append((xt.grad.cpu(), wt.grad.cpu()))
    assert _rel(grads[1][0], grads[0][0]) < TOL
    assert _rel(grads[1][1], grads[0][1]) < TOL


@pytest.mark.cuda
def test_raw_wrappers_refuse_gradients_on_card(cuda):
    z = torch.randn((4, 8, 6), device=cuda, requires_grad=True)
    p = torch.randn((2, 5, 6), device=cuda)
    x = torch.randn((2, 1, 5, 4, 9), device=cuda, requires_grad=True)
    w = torch.randn((2, 5, 4, 3), device=cuda)
    with pytest.raises(RuntimeError, match="legdot"):
        spectral_mm.legmm(z, p)
    with pytest.raises(RuntimeError, match="dhconv"):
        spectral_mm.dhconv_mm(x, w)


def _cplx(gen, shape, device):
    return torch.complex(torch.randn(shape, device=device, generator=gen),
                         torch.randn(shape, device=device, generator=gen))


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("B,C,O,L,M,sliced", [(2, 70, 45, 3, 130, False),
                                              (3, 33, 64, 2, 241, False),
                                              (2, 97, 200, 2, 241, False),
                                              (1, 70, 257, 2, 257, False),
                                              (2, 97, 45, 3, 1, False),
                                              (2, 97, 200, 2, 241, True)])
def test_dhconv_complex_kernel_matches_plain(cuda, passes, B, C, O, L, M, sliced):
    """The shapes of DHCONV_SHAPES; sliced: x's pairs start on 8 bytes, not 16."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = (_sliced_randn((B, C, L, M), cuda, g, torch.complex64) if sliced
         else _cplx(g, (B, C, L, M), cuda))
    w = _cplx(g, (C, O, L), cuda)
    before = kernels.launches["dhconv_complex"]
    got = complex_kernels.contract_dhconv_raw(x, w, passes)
    torch.cuda.synchronize()
    assert kernels.launches["dhconv_complex"] == before + 1
    assert got.dtype == torch.complex64 and got.shape == (B, O, L, M)
    want = complex_kernels.contract_dhconv_plain(x, w, passes)
    assert _rel(got, want) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("case", ["strided x", "dx view"])
def test_dhconv_complex_reads_conj_bit_and_strided_inputs(cuda, case, passes):
    """w.conj().transpose(0, 1), the backward's dx weight, is lazily
    conjugated and strided. "strided x": x a strided view of its values too
    (the wrapper copies x). "dx view": x contiguous, and the weight reaches
    the kernel without a copy: the call allocates the output and the
    prepared weight's scratch, and less than the weight's bytes besides."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = _cplx(g, (2, 70, 3, 130), cuda)
    w = _cplx(g, (45, 70, 3), cuda)
    wt = w.conj().transpose(0, 1)               # lazily conjugated, strided (70, 45, 3)
    assert wt.is_conj() and not wt.is_contiguous()
    if case == "strided x":
        xs = x.transpose(2, 3).contiguous().transpose(2, 3)   # strided view of x's values
        assert not xs.is_contiguous()
        got = complex_kernels.contract_dhconv_raw(xs, wt, passes)
    else:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = complex_kernels.contract_dhconv_raw(x, wt, passes)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        scratch = spectral_mm.dhconv_weight_scratch(3, 70, 45, 3, 2 if passes == 3 else 1, "meta")
        w_bytes = w.numel() * w.element_size()
        assert extra < got.numel() * got.element_size() + scratch.numel() * 2 + w_bytes, extra
    want = complex_kernels.contract_dhconv_plain(
        x, w.conj().resolve_conj().transpose(0, 1).contiguous(), passes)
    assert _rel(got, want) < TOL


@pytest.mark.cuda
def test_dhconv_complex_backward_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(8)
    B, C, O, L, M = 2, 70, 45, 3, 130

    def cplx(*shape):
        return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)

    x, w, cot = cplx(B, C, L, M), cplx(C, O, L), torch.from_numpy(cplx(B, O, L, M))
    grads = []
    for dev in ("cpu", cuda):
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        wt = torch.from_numpy(w).to(dev).requires_grad_()
        before = kernels.launches["dhconv_complex"]
        complex_kernels.contract_dhconv_kernel(xt, wt, 3).backward(cot.to(dev))
        # on the card the forward and dx launch the kernel; dw is an einsum
        assert kernels.launches["dhconv_complex"] == before + (2 if dev == cuda else 0)
        grads.append((xt.grad.cpu(), wt.grad.cpu()))
    assert _rel(grads[1][0], grads[0][0]) < TOL
    assert _rel(grads[1][1], grads[0][1]) < TOL


@pytest.mark.cuda
def test_dhconv_complex_raw_wrapper_refuses_gradients_on_card(cuda):
    x = torch.randn((1, 4, 3, 9), device=cuda, dtype=torch.complex64, requires_grad=True)
    w = torch.randn((4, 5, 3), device=cuda, dtype=torch.complex64)
    with pytest.raises(RuntimeError, match="contract_dhconv_kernel"):
        complex_kernels.contract_dhconv_raw(x, w)
    with torch.no_grad():
        complex_kernels.contract_dhconv_raw(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("contract", ["k", "l"])
@pytest.mark.parametrize("C,K,L", [(70, 97, 33), *LEGMM_SHAPES[2:]])
def test_legmm_kernel_paired_layout(cuda, passes, contract, C, K, L):
    """M2 = mmax: row g against table g, the paired layout."""
    g = torch.Generator(device=cuda).manual_seed(9)
    mmax = 7
    z = torch.randn((mmax, C, K if contract == "k" else L), device=cuda, generator=g)
    p = torch.randn((mmax, L, K), device=cuda, generator=g)
    before = kernels.launches["legmm"]
    got = spectral_mm.legmm(z, p, passes=passes, contract=contract)
    torch.cuda.synchronize()
    assert kernels.launches["legmm"] == before + 1
    assert _rel(got, spectral_mm.legmm_plain(z, p, passes=passes, contract=contract)) < TOL


def _bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits): 2**(e - 8)
    for |v| in [2**(e-1), 2**e), e from frexp (exact at powers of two)."""
    return torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 8)


def _check_grid(got, want):
    """TOL of the largest magnitude, plus one bf16 ulp of each element for a
    bf16 output."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.double(), want.double()
    slack = TOL * w.abs().max()
    if want.dtype == torch.bfloat16:
        slack = slack + _bf16_ulp(w)
    assert bool(((g - w).abs() <= slack).all()), float((g - w).abs().max() / w.abs().max())


# (R, K, N) across gridmm.cu's 128 x 256 blocks and 32-deep stages: R not a
# multiple of 128; N = 482 (two column blocks, the second ragged), 1440, 256
# (one whole block), 257 (one column past it), 200 and 201 (one ragged
# block, odd N stored element by element); K = 482 (rows off 16 bytes in
# float32 and in bf16), 97 (odd: rows at every misalignment) and 1440
# (aligned)
GRID_SHAPES = [(300, 97, 201), (1000, 482, 1440), (129, 482, 482), (383, 1440, 256),
               (257, 97, 257), (130, 482, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("R,K,N", GRID_SHAPES)
def test_gridmm_kernel_matches_plain(cuda, R, K, N, passes, xdtype, out):
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((R, K), device=cuda, generator=g).to(xdtype)
    t = torch.randn((K, N), device=cuda, generator=g)
    before = kernels.launches["gridmm"]
    got = spectral_mm.gridmm(x, t, passes, out)
    torch.cuda.synchronize()
    assert kernels.launches["gridmm"] == before + 1
    _check_grid(got, spectral_mm.gridmm_plain(x, t, passes, out))


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,K,N", GRID_SHAPES)
def test_grid_dot_kernel_matches_plain(cuda, R, K, N, xdtype, out):
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((R, K), device=cuda, generator=g).to(xdtype)
    th, tl = bench_gridmm.split_table(torch.randn((K, N), device=cuda, generator=g))
    before = kernels.launches["grid_dot"]
    got = bench_gridmm.grid_dot(x, th, tl, out)
    torch.cuda.synchronize()
    assert kernels.launches["grid_dot"] == before + 1
    _check_grid(got, bench_gridmm.grid_dot_plain(x, th, tl, out))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gridmm", "grid_dot"])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [482, 97, 1440])
def test_grid_kernels_read_a_slice_at_an_odd_row(cuda, kernel, xdtype, K):
    """x a contiguous slice from row 1: its base is off 16 bytes unless K
    elements are a multiple of 16 bytes."""
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((301, K), device=cuda, generator=g).to(xdtype)[1:]
    t = torch.randn((K, 482), device=cuda, generator=g)
    assert x.is_contiguous()
    if kernel == "gridmm":
        got, want = spectral_mm.gridmm(x, t, 3), spectral_mm.gridmm_plain(x, t, 3)
    else:
        th, tl = bench_gridmm.split_table(t)
        got, want = bench_gridmm.grid_dot(x, th, tl), bench_gridmm.grid_dot_plain(x, th, tl)
    torch.cuda.synchronize()
    _check_grid(got, want)


@pytest.mark.cuda
def test_grid_kernels_refuse_what_they_do_not_take(cuda):
    x, t = torch.randn((8, 6), device=cuda), torch.randn((6, 5), device=cuda)
    with pytest.raises(ValueError):
        spectral_mm.gridmm(x.T.contiguous().T, t)
    with pytest.raises(ValueError):
        spectral_mm.gridmm(x, t.cpu())
    with pytest.raises(RuntimeError, match="no VJP"):
        spectral_mm.gridmm(x.requires_grad_(), t)
    th, tl = bench_gridmm.split_table(t)
    with pytest.raises(ValueError):
        bench_gridmm.grid_dot(x.detach(), th.T.contiguous().T, tl)


@pytest.mark.cuda
def test_probe_battery_nine_pass(cuda, capsys):
    before = dict(kernels.launches)
    assert kernel_isolate.main([]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS") == 9 and "FAIL" not in out, out
    for name in kernels.PROBES:
        assert kernels.launches[name] == before[name] + 1, name
    # dhconv_tiny's forward, dhconv_grad's forward and dx
    assert kernels.launches["dhconv_complex"] == before["dhconv_complex"] + 3


# (B, L, C, O, M) against the gridded probes' tiles (32 columns of m, 16 of
# o in pairs, 16 rows of c a staged chunk): M = 1, 31, 33, 130; O = 1, 33;
# C = 1 and 257 (17 chunks); B * L = 1 and 210; M, O and B empty, and C = 0
# (nothing to compute: no launch, an empty output or zeros)
GRIDDED_SHAPES = [(1, 1, 16, 16, 1), (2, 4, 16, 16, 31), (2, 4, 16, 16, 33),
                  (3, 2, 70, 33, 130), (2, 3, 1, 1, 130), (1, 2, 257, 33, 33),
                  (3, 70, 16, 5, 64), (2, 4, 16, 16, 0), (2, 4, 16, 0, 128),
                  (0, 4, 16, 16, 128), (2, 4, 0, 16, 128)]
GRIDDED = ("grid_blocks", "stacked_output_5d", "multi_output")


def _gridded_inputs(shape):
    b, l, c, o, m = shape
    return [(b, l, c, m), (l, c, o)]


@pytest.mark.cuda
@pytest.mark.parametrize("probe,shapes,launched", [
    ("dot_plain", [(33, 70), (70, 130)], 1), ("dot_transposed", [(70, 33), (70, 130)], 1),
    ("bf16_split", [(70, 33), (70, 130)], 1), ("grid_blocks", [(3, 2, 70, 130), (2, 70, 33)], 1),
    ("stacked_output_5d", [(3, 2, 70, 130), (2, 70, 33)], 1),
    ("multi_output", [(3, 2, 70, 130), (2, 70, 33)], 1), ("copy", [(5, 1031)], 1),
    *((p, _gridded_inputs(s), int(0 not in s)) for p in GRIDDED for s in GRIDDED_SHAPES)])
def test_probe_kernels_at_ragged_shapes(cuda, probe, shapes, launched):
    """A shape with nothing to compute (an empty output, or C = 0) launches
    nothing and counts nothing."""
    _, _, kernel, twin = next(c for c in kernel_isolate.CASES if c[0] == probe)
    before = kernels.launches[kernel.__name__]
    assert kernel_isolate.run_case(probe, shapes, kernel, twin, cuda, seed=12)
    assert kernels.launches[kernel.__name__] == before + launched


def _gridded_case(probe, x, w):
    """Runs a gridded probe once on x and w; checks its launch and every
    output against its twin's."""
    _, _, kernel, twin = next(c for c in kernel_isolate.CASES if c[0] == probe)
    before = kernels.launches[kernel.__name__]
    got = kernel(x, w)
    torch.cuda.synchronize()
    assert kernels.launches[kernel.__name__] == before + 1
    want = twin(x, w)
    got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w_) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("probe", GRIDDED)
def test_gridded_probes_read_x_off_16_bytes(cuda, probe):
    """x taken from a larger buffer, 4 bytes past a 16-byte boundary."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = _sliced_randn((2, 3, 17, 130), cuda, g)
    assert x.data_ptr() % 16 == 4
    _gridded_case(probe, x, torch.randn((3, 17, 33), device=cuda, generator=g))


@pytest.mark.cuda
@pytest.mark.parametrize("probe", GRIDDED)
def test_gridded_probes_after_a_nan_call(cuda, probe):
    """A NaN-filled call fills every staged tile with NaN; a finite call at
    a ragged shape after it must read none of it."""
    _, _, kernel, _ = next(c for c in kernel_isolate.CASES if c[0] == probe)
    kernel(torch.full((2, 3, 300, 130), float("nan"), device=cuda),
           torch.full((3, 300, 40), float("nan"), device=cuda))
    g = torch.Generator(device=cuda).manual_seed(6)
    _gridded_case(probe, torch.randn((2, 3, 17, 33), device=cuda, generator=g),
                  torch.randn((3, 17, 5), device=cuda, generator=g))


@pytest.mark.cuda
def test_bench_tools_run_on_card(cuda):
    shapes = dict(dhconv=dict(B=2, L=3, C=70, O=45, M=130), legendre=dict(mmax=5, C=70, K=97, L=33),
                  legendre2=dict(mmax=5, C=70, K=97, L=33),
                  grid=dict(shapes=((300, 97, 202, "a"),), rows=128))
    assert bench_spectral_mm.run("all", "cuda", 2, **shapes) == 0
    assert bench_gridmm.run("cuda", 2, R=300, K=97, N=202, rows=128, legendre=(30, 24, 17)) == 0


# element counts around the GELU kernels' 8-element vectors and 2048-element
# blocks, with special values first: signed zeros, infinities, NaN, values
# where tanh saturates
GELU_SIZES = [7, 8, 9, 2053, 3 * 2048 + 5]
GELU_SPECIALS = [0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e30, -1e30, 12.0, -12.0]


def _same_bits(a, b):
    """Equal bf16 tensors, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", GELU_SIZES)
def test_gelu_bf16_kernels_bitwise_against_plain(cuda, n, offset):
    """Forward and gradient against their twins on the card, bit for bit;
    offset 1 puts every pointer 2 bytes past 16 (the element-by-element
    path)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x, dy = ((3 * torch.randn(n + offset, device=cuda, generator=g)).bfloat16()[offset:]
             for _ in range(2))
    x[:len(GELU_SPECIALS)] = torch.tensor(GELU_SPECIALS[:n], dtype=torch.bfloat16)
    before = dict(kernels.launches)
    y, dx = gelu.gelu_bf16_forward(x), gelu.gelu_bf16_backward(x, dy)
    torch.cuda.synchronize()
    assert kernels.launches["gelu_bf16"] == before["gelu_bf16"] + 1
    assert kernels.launches["gelu_bf16_grad"] == before["gelu_bf16_grad"] + 1
    assert _same_bits(y, gelu.gelu_bf16_plain(x))
    assert _same_bits(dx, gelu.gelu_bf16_grad_plain(x, dy))


@pytest.mark.cuda
def test_gelu_bf16_function_on_card(cuda):
    """The autograd Function: one forward and one gradient launch, the
    twins' values, and a non-contiguous input taken through a copy."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (3 * torch.randn((2, 33, 40), device=cuda, generator=g)).bfloat16().transpose(1, 2)
    x.requires_grad_()
    dy = torch.randn((2, 40, 33), device=cuda, generator=g).bfloat16()
    before = dict(kernels.launches)
    y = gelu.gelu_bf16(x)
    y.backward(dy)
    torch.cuda.synchronize()
    assert kernels.launches["gelu_bf16"] == before["gelu_bf16"] + 1
    assert kernels.launches["gelu_bf16_grad"] == before["gelu_bf16_grad"] + 1
    xd = x.detach()
    assert torch.equal(y.detach(), gelu.gelu_bf16_plain(xd))
    assert torch.equal(x.grad, gelu.gelu_bf16_grad_plain(xd, dy))


def _no_work_cases():
    """(case id, kernel counted, inputs' shapes, call on the inputs): one empty
    output and one contraction of length 0 for each kernel whose launcher
    computes (an empty tensor for the elementwise GELU kernels); the twin
    gives the expected output on the CPU."""
    dh = spectral_mm.dhconv_mm
    dx = functools.partial(spectral_mm.dhconv_mm, wdim=1, conj_w=True)
    gd = lambda x, t: bench_gridmm.grid_dot(x, *bench_gridmm.split_table(t))  # noqa: E731
    ki = kernel_isolate
    return [
        # legmm analysis: C = 0 empty; K = 0 contracts nothing
        ("legmm empty", "legmm", [(4, 0, 7), (2, 5, 7)], spectral_mm.legmm),
        ("legmm depth 0", "legmm", [(4, 3, 0), (2, 5, 0)], spectral_mm.legmm),
        ("dhconv_mm empty", "dhconv_mm", [(2, 0, 3, 4, 5), (2, 3, 4, 6)], dh),
        ("dhconv_mm depth 0", "dhconv_mm", [(2, 1, 3, 0, 5), (2, 3, 0, 6)], dh),
        ("dhconv_mm dx empty", "dhconv_mm", [(2, 1, 3, 6, 0), (2, 3, 4, 6)], dx),
        ("dhconv_mm dx depth 0", "dhconv_mm", [(2, 1, 3, 0, 5), (2, 3, 4, 0)], dx),
        # dhconv_dw contracts b and m
        ("dhconv_dw empty", "dhconv_dw", [(2, 1, 3, 0, 5), (2, 1, 3, 6, 5)], spectral_mm.dhconv_dw),
        ("dhconv_dw depth 0", "dhconv_dw", [(2, 1, 3, 4, 0), (2, 1, 3, 6, 0)],
         spectral_mm.dhconv_dw),
        ("dhconv_dw no batch", "dhconv_dw", [(2, 0, 3, 4, 5), (2, 0, 3, 6, 5)],
         spectral_mm.dhconv_dw),
        ("dhconv_complex empty", "dhconv_complex", [(1, 4, 3, 0), (4, 6, 3)], None),
        ("dhconv_complex depth 0", "dhconv_complex", [(1, 0, 3, 5), (0, 6, 3)], None),
        ("gridmm empty", "gridmm", [(0, 7), (7, 5)], spectral_mm.gridmm),
        ("gridmm depth 0", "gridmm", [(4, 0), (0, 5)], spectral_mm.gridmm),
        ("grid_dot empty", "grid_dot", [(4, 7), (7, 0)], gd),
        ("grid_dot depth 0", "grid_dot", [(4, 0), (0, 5)], gd),
        ("probe_copy empty", "probe_copy", [(0, 128)], ki.probe_copy),
        ("probe_copy empty rows", "probe_copy", [(8, 0)], ki.probe_copy),
        ("probe_dot_plain empty", "probe_dot_plain", [(0, 16), (16, 128)], ki.probe_dot_plain),
        ("probe_dot_plain depth 0", "probe_dot_plain", [(16, 0), (0, 128)], ki.probe_dot_plain),
        ("probe_dot_transposed empty", "probe_dot_transposed", [(16, 0), (16, 128)],
         ki.probe_dot_transposed),
        ("probe_dot_transposed depth 0", "probe_dot_transposed", [(0, 16), (0, 128)],
         ki.probe_dot_transposed),
        ("probe_bf16_split empty", "probe_bf16_split", [(16, 16), (16, 0)], ki.probe_bf16_split),
        ("probe_bf16_split depth 0", "probe_bf16_split", [(0, 16), (0, 128)],
         ki.probe_bf16_split),
        ("probe_multi_output empty", "probe_multi_output", [(2, 0, 16, 128), (0, 16, 16)],
         ki.probe_multi_output),
        ("probe_multi_output depth 0", "probe_multi_output", [(2, 4, 0, 128), (4, 0, 16)],
         ki.probe_multi_output),
        # elementwise: an empty tensor is the one shape without work
        ("gelu_bf16 empty", "gelu_bf16", [(2, 0, 5)],
         lambda x: gelu.gelu_bf16_forward(x.bfloat16())),
        ("gelu_bf16_grad empty", "gelu_bf16_grad", [(0, 3), (0, 3)],
         lambda x, g: gelu.gelu_bf16_backward(x.bfloat16(), g.bfloat16())),
    ]


def _complex_planes(x, w):
    return complex_kernels.contract_dhconv_raw(torch.complex(x[0], x[1]),
                                               torch.complex(w[0], w[1]), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c[0] for c in _no_work_cases()])
def test_kernels_launch_nothing_without_work(cuda, case):
    """An empty output, or a contraction of length 0, gives what the twin
    gives on the CPU (an empty tensor, or zeros) with no launch and no count."""
    _, name, shapes, fn = next(c for c in _no_work_cases() if c[0] == case)
    g = torch.Generator().manual_seed(7)
    if fn is None:  # the complex kernel: complex64 (re, im) planes
        fn = _complex_planes
        inputs = [torch.randn((2, *s), generator=g) for s in shapes]
    else:
        inputs = [torch.randn(s, generator=g) for s in shapes]
    want = fn(*inputs)
    before = dict(kernels.launches)
    got = fn(*(t.to(cuda) for t in inputs))
    torch.cuda.synchronize()
    assert kernels.launches == before, name
    got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
    for a, b in zip(got, want, strict=True):
        assert a.device.type == "cuda" and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b)
        assert b.numel() == 0 or not bool(b.any())  # empty, or zeros


@pytest.mark.parametrize("case", [c[0] for c in _no_work_cases()])
def test_twins_give_what_the_kernels_give_without_work(case):
    """On the CPU, the card test's reference: each wrapper runs its twin,
    which gives what kernels.no_work gives the card's wrapper (an empty
    output, or zeros for a contraction of length 0), and counts nothing."""
    _, _, shapes, fn = next(c for c in _no_work_cases() if c[0] == case)
    g = torch.Generator().manual_seed(7)
    planes = fn is None
    fn = _complex_planes if planes else fn
    inputs = [torch.randn((2, *s) if planes else s, generator=g) for s in shapes]
    before = dict(kernels.launches)
    got = fn(*inputs)
    assert kernels.launches == before
    for out in got if isinstance(got, tuple) else (got,):
        depth = 0 if out.numel() else 1
        want = kernels.no_work(tuple(out.shape), depth, "cpu", out.dtype)
        assert want is not None and torch.equal(out, want)


def test_no_work_and_the_legmm_table_count():
    assert kernels.no_work((3, 0, 2), 5, "cpu").shape == (3, 0, 2)
    zeros = kernels.no_work((3, 2), 0, "cpu", torch.bfloat16)
    assert zeros.dtype == torch.bfloat16 and not bool(zeros.any())
    assert kernels.no_work((3, 2), 1, "cpu") is None
    # mmax = 0 has no table for row g % mmax: refused, on any device
    with pytest.raises(ValueError, match="mmax"):
        spectral_mm.legmm(torch.zeros((2, 3, 4)), torch.zeros((0, 5, 4)))
