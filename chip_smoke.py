#!/usr/bin/env python3
"""Smoke test of makani_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--record PATH]

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the five Hopper kernels from makani_tpu_torch/csrc/ into
     build/kernels/, one nvcc per source, all started together;
  3. each matmul kernel at the flagship SFNO's shapes, passes 3 and 1:
     against a float64 product on the card (5e-5 / 5e-2 relative, the bounds
     of tests/test_pallas_mm.py) and against its plain PyTorch twin
     (TWIN_TOL), timed with CUDA events beside the twin and one PyTorch
     library call (float32 bmm for legmm, complex64 matmul for dhconv_mm and
     dhconv_dw, TF32 off); and the fused Adam kernel over the flagship's 87
     parameter leaves (572.5 M elements, bf16 moments under stochastic
     rounding): bit-identical to its twin after 2 steps, timed per full
     update beside the twin and torch.optim.Adam(fused=True) on float32
     state (context only: no PyTorch call rounds moments stochastically);
  4. the flagship_synth_drive_bare SFNO at full width (73 channels on
     721x1440, embed 384, 8 blocks, random weights from a seed): one forward
     through the kernels with its launch counts, against one through the plain
     twins (FORWARD_TOL); and a 3-block SFNO at 36x72 on the card against the
     same weights on the CPU (SMALL_TOL);
  5. the serving path: an Inferencer lite rollout of 4 steps at batch 1,
     kernel launch counts read around it, finite outputs, ms per step and
     peak device memory;
  6. the training path: a Trainer of flagship_synth_drive_bare on synthetic
     data (fused Adam, checkpointing 0, no validation or checkpoints) runs
     one epoch of 3 steps at batch 1 with finite losses and its launch
     counts per step asserted (36 legmm, 16 dhconv_mm, 8 dhconv_dw, 87
     fused_adam); the train step timed on a resident batch (median of 3
     after a warm-up) with its peak device memory; the full-width gradients
     through the kernels against those through the twins (FORWARD_TOL per
     leaf), and a 3-block SFNO's gradients on the card against the same
     weights and batch on the CPU (SMALL_TOL per leaf);
  7. the complex coefficient engine ("xla", makani_tpu's default) with the
     complex dhconv kernel on (complex_ops.enable_pallas_kernels), at full
     width: the kernel at x (1, 384, 240, 241) and w (384, 384, 240)
     complex64, forward and dx (conj(w) transposed), passes 3 and 1, against
     its twin (TWIN_TOL) and float64 (F64_TOL), timed beside the twin and a
     complex64 torch.matmul batched over l; one flagship forward (8
     dhconv_complex launches, no other matmul kernel) against the same
     weights on the "kernel" engine and on "xla" without the kernel
     (FORWARD_TOL); a 4-step Inferencer rollout; a Trainer epoch of 3 steps
     with coefficient_engine "xla" (16 dhconv_complex and 87 fused_adam
     launches per step), its step time and peak memory, and its full-width
     gradients against the kernel engine's (FORWARD_TOL per leaf). The
     engine, precisions and kernel toggle are restored afterwards.
The last two lines are the kernels' JSON record and the result line.
--record PATH also writes every measurement of the run to PATH as JSON.

TF32 is off for matmuls and cuDNN (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 = False): the float32 references, the
longitude DFT and the 1x1 channel mixes run in full float32. Serving
precision is "high", i.e. 3 bf16 passes in the kernels.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# kernel vs plain twin: the same bf16 operand parts and exact float32 products,
# summed in another order; the gap is a few ulps of the largest partial sum
TWIN_TOL = 1e-5
# vs a float64 product (tests/test_pallas_mm.py:27,56)
F64_TOL = {3: 5e-5, 1: 5e-2}
# full-width forward, kernels vs twins: the per-contraction ordering gap
# (~1e-6) passes through 26 contractions and 16 instance norms
FORWARD_TOL = 1e-3
# small SFNO, card (kernels) vs CPU (twins): the same arithmetic, other
# summation orders in every matmul
SMALL_TOL = 1e-4

# published H100 SXM peaks (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12

ROLLOUT_STEPS = 4
TRAIN_STEPS = 3
# launches per train step at checkpointing 0, read from the code: 18 forward
# Legendre contractions and their 18 transposes; 8 dhconv forwards, 8 dx and
# 8 dw; one fused Adam launch per parameter leaf (10 per block, 3 in the
# encoder and the decoder each, the residual transform)
TRAIN_LAUNCHES = {"legmm": 36, "dhconv_mm": 16, "dhconv_dw": 8, "fused_adam": 87}
# on the complex engine with the kernel on: 8 forward contractions and their 8
# dx; dw is an einsum, and the Legendre contractions are float32 einsums
COMPLEX_FORWARD_LAUNCHES = {"dhconv_complex": 8}
COMPLEX_TRAIN_LAUNCHES = {"dhconv_complex": 16, "fused_adam": 87}
# the MLP's output bias feeds an instance norm, which removes it: its exact
# gradient is zero, and its rounding noise is measured against the largest
# gradient of the model instead of its own
ZERO_GRAD = "mlp.fc2.bias"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps):
    """Median milliseconds of `fn` over `reps` runs, CUDA events around each."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def rel_err_c(got, ref):
    """rel_err for complex tensors, in complex128."""
    import torch
    return float((got.to(torch.complex128) - ref).abs().max() / ref.abs().max())


def launch_counts(kernels, expected):
    """`expected` with every other kernel at zero launches."""
    return {k: expected.get(k, 0) for k in kernels.launches}


def phase_kernels(torch, spectral_mm, dev, gen):
    """Each kernel at the flagship shapes; returns rows of measurements."""
    rows = []
    mmax, C, Lin, Kfull = 241, 384, 240, 721
    cases = [("full analysis", Kfull, "k"), ("full synthesis", Kfull, "l"),
             ("inner analysis", Lin, "k"), ("inner synthesis", Lin, "l")]
    for label, K, contract in cases:
        D = K if contract == "k" else Lin
        z = torch.randn((2 * mmax, C, D), device=dev, generator=gen)
        p = torch.randn((mmax, Lin, K), device=dev, generator=gen)
        zs = z.view(2, mmax, C, D)
        table = p.transpose(-1, -2) if contract == "k" else p
        ref = torch.matmul(zs.double(), table.double()).reshape(2 * mmax, C, -1)
        # the library yardstick: one float32 bmm against the table repeated
        # for the re and im rows (prepared outside the timing)
        tables = torch.cat([table, table])
        for passes in (3, 1):
            got = spectral_mm.legmm(z, p, passes, contract)
            torch.cuda.synchronize()
            plain = spectral_mm.legmm_plain(z, p, passes, contract)
            e64, etwin = rel_err(got, ref), rel_err(got, plain.double())
            check(e64 < F64_TOL[passes], f"legmm {label} p{passes} vs f64: {e64}")
            check(etwin < TWIN_TOL, f"legmm {label} p{passes} vs twin: {etwin}")
            nbytes = (z.numel() + p.numel() + got.numel()) * 4
            flops = 2 * 2 * mmax * C * Lin * K * passes
            b_ms, b_by = bound(nbytes, flops)
            rows.append(dict(
                name="legmm", shape=f"{label} z{tuple(z.shape)} p{tuple(p.shape)}",
                passes=passes, max_abs_err=float((got - plain).abs().max()),
                rel_err_twin=etwin, rel_err_f64=e64,
                ms=cuda_ms(lambda: spectral_mm.legmm(z, p, passes, contract), 20),
                plain_ms=cuda_ms(lambda: spectral_mm.legmm_plain(z, p, passes, contract), 5),
                library_ms=cuda_ms(lambda: torch.bmm(z, tables), 20),
                bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9, gflop=flops / 1e9))
            del got, plain
        del z, p, zs, table, tables, ref

    B, L, M = 1, Lin, mmax
    x = torch.randn((2, B, L, C, M), device=dev, generator=gen)
    w = torch.randn((2, L, C, C), device=dev, generator=gen)
    # the library yardstick: one complex64 matmul (a float32 bmm cannot form
    # the complex product in one call). The forward contracts w's C, the
    # backward's dx (wdim 1, conj_w) contracts w's O with conj(w); C = O, so
    # one x serves both.
    xc = torch.complex(x[0], x[1])
    wc = torch.complex(w[0], w[1])
    for label, wdim, conj_w, wop in (("forward", 0, False, wc.transpose(-1, -2)),
                                     ("dx", 1, True, torch.conj(wc).resolve_conj())):
        ref = torch.matmul(wop.to(torch.complex128), xc.to(torch.complex128))
        for passes in (3, 1):
            got = spectral_mm.dhconv_mm(x, w, passes, wdim=wdim, conj_w=conj_w)
            torch.cuda.synchronize()
            plain = spectral_mm.dhconv_mm_plain(x, w, passes, wdim=wdim, conj_w=conj_w)
            e64 = max(float((got[0].double() - ref.real).abs().max()),
                      float((got[1].double() - ref.imag).abs().max())) / float(ref.abs().max())
            etwin = rel_err(got, plain.double())
            check(e64 < F64_TOL[passes], f"dhconv_mm {label} p{passes} vs f64: {e64}")
            check(etwin < TWIN_TOL, f"dhconv_mm {label} p{passes} vs twin: {etwin}")
            nbytes = (x.numel() + w.numel() + got.numel()) * 4
            flops = 2 * B * L * C * C * M * 3 * passes  # 3M: three real products
            b_ms, b_by = bound(nbytes, flops)
            rows.append(dict(
                name="dhconv_mm", shape=f"{label} x{tuple(x.shape)} w{tuple(w.shape)}",
                passes=passes, max_abs_err=float((got - plain).abs().max()),
                rel_err_twin=etwin, rel_err_f64=e64,
                ms=cuda_ms(lambda: spectral_mm.dhconv_mm(x, w, passes, wdim=wdim,
                                                         conj_w=conj_w), 20),
                plain_ms=cuda_ms(lambda: spectral_mm.dhconv_mm_plain(x, w, passes, wdim=wdim,
                                                                     conj_w=conj_w), 5),
                library_ms=cuda_ms(lambda: torch.matmul(wop, xc), 20),
                bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9, gflop=flops / 1e9))
            del got, plain
        del ref
    del w, wc

    # dhconv_dw: x and the cotangent g at the forward's shapes
    g = torch.randn((2, B, L, C, M), device=dev, generator=gen)
    xcj = torch.conj(xc)                                 # (L, C, M)
    gct = torch.complex(g[0], g[1]).transpose(-1, -2)    # (L, M, O)
    ref = torch.matmul(xcj.to(torch.complex128), gct.to(torch.complex128))
    for passes in (3, 1):
        got = spectral_mm.dhconv_dw(x, g, passes)
        torch.cuda.synchronize()
        plain = spectral_mm.dhconv_dw_plain(x, g, passes)
        e64 = max(float((got[0].double() - ref.real).abs().max()),
                  float((got[1].double() - ref.imag).abs().max())) / float(ref.abs().max())
        etwin = rel_err(got, plain.double())
        check(e64 < F64_TOL[passes], f"dhconv_dw p{passes} vs f64: {e64}")
        check(etwin < TWIN_TOL, f"dhconv_dw p{passes} vs twin: {etwin}")
        nbytes = (x.numel() + g.numel() + got.numel()) * 4
        flops = 2 * B * L * C * C * M * 3 * passes
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(
            name="dhconv_dw", shape=f"x{tuple(x.shape)} g{tuple(g.shape)}", passes=passes,
            max_abs_err=float((got - plain).abs().max()), rel_err_twin=etwin, rel_err_f64=e64,
            ms=cuda_ms(lambda: spectral_mm.dhconv_dw(x, g, passes), 20),
            plain_ms=cuda_ms(lambda: spectral_mm.dhconv_dw_plain(x, g, passes), 5),
            library_ms=cuda_ms(lambda: torch.matmul(xcj, gct), 20),
            bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9, gflop=flops / 1e9))
        del got, plain
    return rows


def phase_adam(torch, dev, gen, shapes):
    """The fused Adam kernel over the flagship's parameter leaves: 2 steps
    bit-identical to the twin, then timed per full update."""
    from makani_tpu_torch.ops import fused_adam
    from makani_tpu_torch.utils.optimizers import AdamState
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, stochastic_rounding=True, seed=340)
    params = {k: torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
    twin = {k: v.clone() for k, v in params.items()}
    grads = {k: 1e-2 * torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}

    def state():
        return AdamState(0, {k: torch.zeros(s, device=dev, dtype=torch.bfloat16)
                             for k, s in shapes.items()},
                         {k: torch.zeros(s, device=dev, dtype=torch.bfloat16)
                          for k, s in shapes.items()})

    s_kernel, s_twin = state(), state()
    for _ in range(2):
        fused_adam.fused_adam_apply(params, grads, s_kernel, 1e-3, **kw)
        fused_adam.fused_adam_apply_plain(twin, grads, s_twin, 1e-3, **kw)
    torch.cuda.synchronize()
    diff = 0.0
    for k in shapes:
        for a, b in ((params[k], twin[k]), (s_kernel.mu[k], s_twin.mu[k]),
                     (s_kernel.nu[k], s_twin.nu[k])):
            diff = max(diff, float((a.float() - b.float()).abs().max()))
            check(torch.equal(a, b), f"fused_adam kernel vs twin differ in {k}")
    n = sum(math.prod(s) for s in shapes.values())
    nbytes = n * (4 + 4 + 4 + 2 + 2 + 2 + 2)  # p read and written, g, mu and nu read and written
    b_ms, b_by = bound(nbytes, 0)
    ms = cuda_ms(lambda: fused_adam.fused_adam_apply(params, grads, s_kernel, 1e-3, **kw), 10)
    plain_ms = cuda_ms(lambda: fused_adam.fused_adam_apply_plain(twin, grads, s_twin, 1e-3,
                                                                 **kw), 2)
    del twin, s_twin
    torch.cuda.empty_cache()
    # context only: PyTorch's fused Adam on float32 moments, the same leaves
    leaves = list(params.values())
    for p, g in zip(leaves, grads.values()):
        p.grad = g
    opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, fused=True)
    library_ms = cuda_ms(opt.step, 10)
    del opt, leaves, params, grads, s_kernel
    torch.cuda.empty_cache()
    return dict(name="fused_adam", shape=f"{len(shapes)} leaves, {n} elements", passes=None,
                max_abs_err=diff, rel_err_twin=diff,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                gbytes=nbytes / 1e9, elements=n, leaves=len(shapes))


def flagship_params(steps):
    from makani_tpu_torch.models.model_registry import update_channel_params
    from makani_tpu_torch.utils.yparams import YParams
    params = YParams(str(ROOT / "config" / "sfnonet.yaml"), "flagship_synth_drive_bare")
    params["valid_autoreg_steps"] = steps - 1
    return update_channel_params(params, n_channels=73)


def phase_small(torch, dev):
    """A 3-block SFNO on the card (kernels) against the same weights on the
    CPU (plain twins)."""
    from makani_tpu_torch.models.model_registry import get_model
    params = flagship_params(1)
    params.update_params(dict(img_shape_x=36, img_shape_y=72, img_crop_shape_x=36,
                              img_crop_shape_y=72, embed_dim=32, num_layers=3,
                              scale_factor=2))
    cpu = get_model(params, device="cpu", generator=torch.Generator().manual_seed(5))
    gpu = get_model(params, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 73, 36, 72), generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(dev)).cpu()
    err = rel_err(got, want.double())
    check(err < SMALL_TOL, f"small SFNO card vs CPU: {err}")
    return err


def leaf_errors(grads, want):
    """Per-leaf relative error (largest magnitude); the MLP's output bias
    against the largest gradient of the model (ZERO_GRAD)."""
    largest = max(float(w.abs().max()) for w in want.values())
    errs = {}
    for k, g in grads.items():
        scale = largest if k.endswith(ZERO_GRAD) else float(want[k].abs().max())
        errs[k] = float((g.double() - want[k].double()).abs().max()) / scale
    return errs


def train_params(**overrides):
    params = flagship_params(1)
    params.update_params(dict(enable_synthetic_data=True, n_train_samples_per_epoch=TRAIN_STEPS,
                              optimizer_fused=True, skip_validation=True, save_checkpoint="none",
                              max_epochs=1, checkpointing=0, log_to_screen=False, **overrides))
    return params


def phase_train(torch, sht, kernels, dev):
    """The training path at full width, its gradients against the twins, and
    a small SFNO's gradients on the card against the CPU."""
    from makani_tpu_torch.utils.trainer import Trainer
    rec = {}
    trainer = Trainer(train_params(), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    rec["epoch_s"] = time.perf_counter() - t0
    total = dict(kernels.launches)
    rec["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    losses = trainer.last_logs["train"]["step losses"]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"train losses {losses}")
    check(total == launch_counts(kernels,
                                 {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}),
          f"launches over {TRAIN_STEPS} train steps {total}, expected {TRAIN_LAUNCHES} per step")
    rec.update(train_losses=losses, train_launches=total,
               train_launches_per_step={k: v // TRAIN_STEPS for k, v in total.items()},
               n_params=trainer.n_model_params, n_leaves=len(trainer.model_params))

    # the train step on a resident batch: one warm-up, the median of three
    inp, tar = (torch.from_numpy(a[None]).to(dev) for a in trainer.train_dataset[0])
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(inp, tar, None, None, 1e-3)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    rec["train_step_ms"] = statistics.median(times)
    rec["train_step_ms_all"] = times

    # full-width gradients, kernels against twins
    _, g_kernel = trainer.loss_and_grads(inp, tar)
    g_kernel = {k: v.cpu() for k, v in g_kernel.items()}
    sht.set_coeff_engine("stacked")
    _, g_plain = trainer.loss_and_grads(inp, tar)
    sht.set_coeff_engine("kernel")
    errs = leaf_errors(g_kernel, {k: v.cpu() for k, v in g_plain.items()})
    worst = max(errs, key=errs.get)
    check(errs[worst] < FORWARD_TOL, f"full-width gradient {worst}: {errs[worst]}")
    rec.update(grad_rel_err_max=errs[worst], grad_rel_err_leaf=worst)
    del trainer, inp, tar, g_kernel, g_plain
    torch.cuda.empty_cache()

    # a 3-block SFNO at 36x72: gradients on the card against the CPU
    small = dict(img_shape_x=36, img_shape_y=72, img_crop_shape_x=36, img_crop_shape_y=72,
                 embed_dim=32, num_layers=3, scale_factor=2)
    cpu = Trainer(train_params(**small), device="cpu",
                  generator=torch.Generator().manual_seed(5))
    gpu = Trainer(train_params(**small), device=dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    x, y = (torch.from_numpy(a[None]) for a in cpu.train_dataset[0])
    _, want = cpu.loss_and_grads(x, y)
    _, got = gpu.loss_and_grads(x.to(dev), y.to(dev))
    errs = leaf_errors({k: v.cpu() for k, v in got.items()}, want)
    worst = max(errs, key=errs.get)
    check(errs[worst] < SMALL_TOL, f"small SFNO gradient card vs CPU {worst}: {errs[worst]}")
    rec.update(small_grad_rel_err_max=errs[worst], small_grad_rel_err_leaf=worst)
    return rec


def phase_complex_kernel(torch, dev, gen):
    """The complex dhconv kernel at the flagship shapes: the forward and the
    backward's dx (the same kernel on conj(w) transposed), passes 3 and 1."""
    from makani_tpu_torch.ops import complex_kernels
    rows = []
    B, C, L, M = 1, 384, 240, 241

    def cplx(shape):
        return torch.complex(torch.randn(shape, device=dev, generator=gen),
                             torch.randn(shape, device=dev, generator=gen))

    x = cplx((B, C, L, M))          # the activation, or the cotangent g for dx
    w = cplx((C, C, L))
    for label, wop in (("forward", w), ("dx", w.conj().transpose(0, 1))):
        # the library yardstick and the float64 reference: one complex matmul
        # batched over l, (L, O, C) x (L, C, B*M), operands prepared outside
        # the timing
        wl = wop.resolve_conj().permute(2, 1, 0).contiguous()
        xl = x.permute(2, 1, 0, 3).reshape(L, C, B * M).contiguous()
        ref = torch.matmul(wl.to(torch.complex128), xl.to(torch.complex128))
        ref = ref.view(L, C, B, M).permute(2, 1, 0, 3)
        for passes in (3, 1):
            got = complex_kernels.contract_dhconv_raw(x, wop, passes)
            torch.cuda.synchronize()
            plain = complex_kernels.contract_dhconv_plain(x, wop, passes)
            e64, etwin = rel_err_c(got, ref), rel_err_c(got, plain.to(torch.complex128))
            check(e64 < F64_TOL[passes], f"dhconv_complex {label} p{passes} vs f64: {e64}")
            check(etwin < TWIN_TOL, f"dhconv_complex {label} p{passes} vs twin: {etwin}")
            nbytes = (x.numel() + w.numel() + got.numel()) * 8
            flops = 2 * B * L * C * C * M * 3 * passes  # 3M: three real products
            b_ms, b_by = bound(nbytes, flops)
            rows.append(dict(
                name="dhconv_complex", shape=f"{label} x{tuple(x.shape)} w{tuple(wop.shape)}",
                passes=passes, max_abs_err=float((got - plain).abs().max()),
                rel_err_twin=etwin, rel_err_f64=e64,
                ms=cuda_ms(lambda: complex_kernels.contract_dhconv_raw(x, wop, passes), 20),
                # the wrapper's per-call copy of the weight to (L, C, O), inside ms
                permute_ms=cuda_ms(lambda: wop.resolve_conj().permute(2, 0, 1).contiguous(), 20),
                plain_ms=cuda_ms(lambda: complex_kernels.contract_dhconv_plain(x, wop, passes), 5),
                library_ms=cuda_ms(lambda: torch.matmul(wl, xl), 20),
                bound_ms=b_ms, bound_by=b_by, gbytes=nbytes / 1e9, gflop=flops / 1e9))
            del got, plain
        del wl, xl, ref
    del x, w
    torch.cuda.empty_cache()
    return rows


def phase_complex(torch, np, sht, complex_ops, kernels, dev, gen):
    """The complex coefficient engine with the kernel on, at full width:
    kernel checks, a forward, a rollout and a training epoch."""
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.utils.inferencer import Inferencer
    from makani_tpu_torch.utils.trainer import Trainer
    rec = {"kernels": phase_complex_kernel(torch, dev, gen)}
    params = flagship_params(ROLLOUT_STEPS)
    model = get_model(params, device=dev)
    model.eval()
    x = torch.randn((1, params.N_in_channels, 721, 1440), device=dev, generator=gen)
    with torch.inference_mode():
        model(x)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        y = model(x)
        torch.cuda.synchronize()
        rec["forward_ms"] = (time.perf_counter() - t0) * 1e3
        rec["launches_per_forward"] = dict(kernels.launches)
        complex_ops.enable_pallas_kernels(False)
        y_einsum = model(x)
        complex_ops.enable_pallas_kernels(True)
        sht.set_coeff_engine("kernel")
        y_kernel_engine = model(x)
        sht.set_coeff_engine("xla")
    check(rec["launches_per_forward"] == launch_counts(kernels, COMPLEX_FORWARD_LAUNCHES),
          f"complex engine launches per forward {rec['launches_per_forward']}")
    check(bool(torch.isfinite(y).all()), "complex engine forward not finite")
    rec["forward_rel_err_einsum"] = rel_err(y, y_einsum.double())
    rec["forward_rel_err_kernel_engine"] = rel_err(y, y_kernel_engine.double())
    check(rec["forward_rel_err_einsum"] < FORWARD_TOL,
          f"complex engine forward, kernel vs einsum: {rec['forward_rel_err_einsum']}")
    check(rec["forward_rel_err_kernel_engine"] < FORWARD_TOL,
          f"complex engine vs kernel engine forward: {rec['forward_rel_err_kernel_engine']}")
    del y, y_einsum, y_kernel_engine

    # serving: the Inferencer's lite rollout
    inferencer = Inferencer(params, weights=model.state_dict(), device=dev)
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    preds = inferencer._rollout_lite(x)
    rec["step_ms"] = (time.perf_counter() - t0) * 1e3 / ROLLOUT_STEPS
    rec["rollout_launches"] = dict(kernels.launches)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    check(preds.shape == (ROLLOUT_STEPS, 1, 73, 721, 1440), f"rollout shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), "complex engine rollout not finite")
    check(rec["rollout_launches"] == launch_counts(
        kernels, {k: v * ROLLOUT_STEPS for k, v in COMPLEX_FORWARD_LAUNCHES.items()}),
        f"complex engine rollout launches {rec['rollout_launches']}")
    del inferencer, preds, x
    torch.cuda.empty_cache()

    # training: a Trainer with coefficient_engine "xla", the kernel toggle on
    trainer = Trainer(train_params(coefficient_engine="xla"), device=dev)
    check(sht.get_coeff_engine() == "xla", "the Trainer did not select the complex engine")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    trainer.train()
    torch.cuda.synchronize()
    total = dict(kernels.launches)
    rec["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    losses = trainer.last_logs["train"]["step losses"]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"complex engine train losses {losses}")
    check(total == launch_counts(
        kernels, {k: v * TRAIN_STEPS for k, v in COMPLEX_TRAIN_LAUNCHES.items()}),
        f"complex engine launches over {TRAIN_STEPS} train steps {total}")
    rec.update(train_losses=losses, train_launches=total,
               train_launches_per_step={k: v // TRAIN_STEPS for k, v in total.items()})
    inp, tar = (torch.from_numpy(a[None]).to(dev) for a in trainer.train_dataset[0])
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(inp, tar, None, None, 1e-3)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    rec["train_step_ms"] = statistics.median(times)
    rec["train_step_ms_all"] = times
    _, g_complex = trainer.loss_and_grads(inp, tar)
    g_complex = {k: v.cpu() for k, v in g_complex.items()}
    sht.set_coeff_engine("kernel")
    _, g_kernel = trainer.loss_and_grads(inp, tar)
    sht.set_coeff_engine("xla")
    errs = leaf_errors(g_complex, {k: v.cpu() for k, v in g_kernel.items()})
    worst = max(errs, key=errs.get)
    check(errs[worst] < FORWARD_TOL, f"complex vs kernel engine gradient {worst}: {errs[worst]}")
    rec.update(grad_rel_err_max=errs[worst], grad_rel_err_leaf=worst)
    del trainer, inp, tar, g_complex, g_kernel
    torch.cuda.empty_cache()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", type=Path, help="write every measurement to this JSON file")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from makani_tpu_torch.ops import complex_ops, kernels, sht, spectral_mm
    from makani_tpu_torch.utils.inferencer import Inferencer

    # phase 1: card, versions, numerics
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN; serving precision "
          f"{sht.get_transform_precision()!r} ({sht._coeff_passes()} bf16 passes)", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    # phase 2: build
    t0 = time.perf_counter()
    reports = kernels.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"[build] {record['build_s']:.1f} s into {kernels.BUILD_DIR}")
    for name, log in reports.items():
        print(f"[build {name}] " + " | ".join(
            line.strip() for line in log.splitlines() if "registers" in line or "spill" in line))

    # phase 3: kernels at the flagship shapes
    rows = phase_kernels(torch, spectral_mm, dev, gen)
    record["kernels"] = rows
    print("[kernels] name | shape | passes | rel err vs twin | vs f64 | ms | plain ms | "
          "library ms | bound ms (by)")
    for r in rows:
        print(f"  {r['name']} | {r['shape']} | p{r['passes']} | {r['rel_err_twin']:.3g} | "
              f"{r['rel_err_f64']:.3g} | {r['ms']:.4f} | {r['plain_ms']:.4f} | "
              f"{r['library_ms']:.4f} | {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)

    from makani_tpu_torch.models.model_registry import get_model
    params = flagship_params(ROLLOUT_STEPS)
    model = get_model(params, device=dev)
    adam = phase_adam(torch, dev, gen, {k: tuple(p.shape) for k, p in model.named_parameters()})
    rows.append(adam)
    print(f"  fused_adam | {adam['shape']} | bf16 SR | bit-identical (max abs diff "
          f"{adam['max_abs_err']}) | - | {adam['ms']:.4f} | {adam['plain_ms']:.4f} | "
          f"{adam['library_ms']:.4f} (torch fused Adam, f32 moments) | {adam['bound_ms']:.4f} "
          f"({adam['bound_by']})", flush=True)

    # phase 4: full-width forward, kernels vs twins; small SFNO card vs CPU
    model.eval()
    x = torch.randn((1, params.N_in_channels, 721, 1440), device=dev, generator=gen)
    with torch.inference_mode():
        model(x)  # warm-up: cuBLAS handles and workspaces
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        y_kernel = model(x)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        per_forward = dict(kernels.launches)
        sht.set_coeff_engine("stacked")
        t0 = time.perf_counter()
        y_plain = model(x)
        torch.cuda.synchronize()
        fwd_plain_ms = (time.perf_counter() - t0) * 1e3
        sht.set_coeff_engine("kernel")
    check(per_forward == launch_counts(kernels, {"legmm": 18, "dhconv_mm": 8}),
          f"launches per forward {per_forward}, expected 18 legmm and 8 dhconv_mm")
    check(tuple(y_kernel.shape) == (1, 73, 721, 1440), f"forward shape {tuple(y_kernel.shape)}")
    fwd_err = rel_err(y_kernel, y_plain.double())
    check(bool(torch.isfinite(y_kernel).all()), "forward output not finite")
    check(fwd_err < FORWARD_TOL, f"forward kernels vs twins: {fwd_err}")
    del y_kernel, y_plain
    small_err = phase_small(torch, dev)
    record.update(forward_ms=fwd_ms, forward_plain_ms=fwd_plain_ms, forward_rel_err=fwd_err,
                  launches_per_forward=per_forward, small_rel_err=small_err)
    print(f"[forward] flagship 73ch 721x1440 edim384 x8: {fwd_ms:.1f} ms with kernels, "
          f"{fwd_plain_ms:.1f} ms with twins; rel err {fwd_err:.3g}; launches {per_forward}; "
          f"small SFNO card vs CPU rel err {small_err:.3g}", flush=True)

    # phase 5: the serving path, an Inferencer lite rollout
    inferencer = Inferencer(params, weights=model.state_dict(), device=dev)
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    preds = inferencer._rollout_lite(x)
    rollout_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    check(preds.shape == (ROLLOUT_STEPS, 1, 73, 721, 1440), f"rollout shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), "rollout output not finite")
    check(launches == launch_counts(kernels, {"legmm": 18 * ROLLOUT_STEPS,
                                              "dhconv_mm": 8 * ROLLOUT_STEPS}),
          f"rollout launches {launches}")
    step_ms = rollout_s * 1e3 / ROLLOUT_STEPS
    record.update(rollout_steps=ROLLOUT_STEPS, step_ms=step_ms, peak_bytes=peak,
                  rollout_launches=launches)
    print(f"[rollout] {ROLLOUT_STEPS} steps at batch 1: {step_ms:.1f} ms per step (host clock, "
          f"prediction copied to the host each step); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)

    del inferencer, preds, x
    torch.cuda.empty_cache()

    # phase 6: the training path
    train = phase_train(torch, sht, kernels, dev)
    record.update(train)
    print(f"[train] flagship {train['n_params']} parameters in {train['n_leaves']} leaves, "
          f"{TRAIN_STEPS} steps at batch 1, losses {train['train_losses']}; train step "
          f"{train['train_step_ms']:.1f} ms (median of {train['train_step_ms_all']}); peak "
          f"device memory {train['train_peak_bytes'] / 2**30:.2f} GiB; launches per step "
          f"{train['train_launches_per_step']}; gradients kernels vs twins rel err "
          f"{train['grad_rel_err_max']:.3g} ({train['grad_rel_err_leaf']}); small SFNO "
          f"gradients card vs CPU {train['small_grad_rel_err_max']:.3g} "
          f"({train['small_grad_rel_err_leaf']})", flush=True)

    # phase 7: the complex coefficient engine with the complex dhconv kernel
    settings = (sht.get_coeff_engine(), sht.get_transform_precision(),
                complex_ops.get_contraction_precision(), complex_ops._USE_PALLAS_DHCONV)
    sht.set_coeff_engine("xla")
    sht.set_transform_precision("high")
    complex_ops.set_contraction_precision("high")
    complex_ops.enable_pallas_kernels(True)
    try:
        cplx = phase_complex(torch, np, sht, complex_ops, kernels, dev, gen)
    finally:
        sht.set_coeff_engine(settings[0])
        sht.set_transform_precision(settings[1])
        complex_ops.set_contraction_precision(settings[2])
        complex_ops.enable_pallas_kernels(settings[3])
    record["complex"] = cplx
    print("[complex kernel] name | shape | passes | rel err vs twin | vs f64 | ms (weight "
          "permute ms inside) | plain ms | library ms | bound ms (by)")
    for r in cplx["kernels"]:
        print(f"  {r['name']} | {r['shape']} | p{r['passes']} | {r['rel_err_twin']:.3g} | "
              f"{r['rel_err_f64']:.3g} | {r['ms']:.4f} ({r['permute_ms']:.4f}) | "
              f"{r['plain_ms']:.4f} | {r['library_ms']:.4f} | {r['bound_ms']:.4f} "
              f"({r['bound_by']})", flush=True)
    print(f"[complex forward] flagship on the 'xla' engine with the kernel: "
          f"{cplx['forward_ms']:.1f} ms (kernel engine, phase 4: {fwd_ms:.1f} ms); rel err "
          f"vs 'xla' without the kernel {cplx['forward_rel_err_einsum']:.3g}, vs the kernel "
          f"engine {cplx['forward_rel_err_kernel_engine']:.3g}; launches "
          f"{cplx['launches_per_forward']}", flush=True)
    print(f"[complex rollout] {ROLLOUT_STEPS} steps at batch 1: {cplx['step_ms']:.1f} ms per "
          f"step; peak device memory {cplx['peak_bytes'] / 2**30:.2f} GiB; launches "
          f"{cplx['rollout_launches']}", flush=True)
    print(f"[complex train] losses {cplx['train_losses']}; train step "
          f"{cplx['train_step_ms']:.1f} ms (median of {cplx['train_step_ms_all']}; kernel "
          f"engine, phase 6: {train['train_step_ms']:.1f} ms); peak device memory "
          f"{cplx['train_peak_bytes'] / 2**30:.2f} GiB; launches per step "
          f"{cplx['train_launches_per_step']}; gradients vs the kernel engine rel err "
          f"{cplx['grad_rel_err_max']:.3g} ({cplx['grad_rel_err_leaf']})", flush=True)

    # results
    if args.record is not None:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(record, indent=1))
    # launches: counted over the training epoch (TRAIN_STEPS steps), the path
    # that runs all four kernels; launches_per_train_step is that count over
    # the steps, launches_rollout the count of the serving rollout
    main_rows = {"legmm": ("full analysis", 3), "dhconv_mm": ("forward", 3),
                 "dhconv_dw": (None, 3), "fused_adam": (None, None)}
    sources = {"legmm": ("makani_tpu_torch/csrc/legmm.cu", "makani_tpu/ops/pallas_mm.py:130"),
               "dhconv_mm": ("makani_tpu_torch/csrc/dhconv_mm.cu",
                             "makani_tpu/ops/pallas_mm.py:195"),
               "dhconv_dw": ("makani_tpu_torch/csrc/dhconv_dw.cu",
                             "makani_tpu/ops/pallas_mm.py:322"),
               "fused_adam": ("makani_tpu_torch/csrc/fused_adam.cu",
                              "makani_tpu/ops/pallas_adam.py:124")}
    kernels = []
    for name, (label, passes) in main_rows.items():
        r = next(r for r in rows if r["name"] == name and r["passes"] == passes
                 and (label is None or r["shape"].startswith(label)))
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
            launches=train["train_launches"][name],
            launches_per_train_step=train["train_launches_per_step"][name],
            launches_rollout=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"], passes=passes))
    # the complex dhconv kernel: launches over phase 7's training epoch, the
    # path that runs it forward and backward
    r = next(r for r in cplx["kernels"] if r["shape"].startswith("forward") and r["passes"] == 3)
    kernels.append(dict(
        name="dhconv_complex", route="cuda", source="makani_tpu_torch/csrc/dhconv_complex.cu",
        replaces="makani_tpu/ops/pallas_kernels.py:101",
        launches=cplx["train_launches"]["dhconv_complex"],
        launches_per_train_step=cplx["train_launches_per_step"]["dhconv_complex"],
        launches_rollout=cplx["rollout_launches"]["dhconv_complex"],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        shape=r["shape"], passes=3))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
