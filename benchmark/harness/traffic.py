"""The general generator: it reads a traffic mix (traffic/<name>.json) and
drives the program with it. A mix's "kind" names the loop, and the rest of
the file its parameters:

- "train": one trainer in a closed loop. `Trainer.train_step` back to back
  on resident batches of `batch` fields drawn in turn from a pool of `pool`
  (input field i, target field i + 1), no synchronisation between steps.
  The first `check_steps` steps are set-up: they warm every shape up, and
  the output check follows them with the reference.
- "forecast": one forecaster in a closed loop. `Inferencer._rollout_lite`
  back to back, each forecast from the next initial condition of the pool,
  each step's prediction copied to page-locked host memory, as makani's
  lite inference does; one warm forecast in set-up. The output check
  compares one forecast drawn from the seed among the first
  `sample_within` and the window's last with the reference, step by step.

The fields are smooth random fields made on the device from the seed:
standard normal noise on a `coarse` grid, upsampled bilinearly, plus
`white` times white noise, each channel brought to zero mean and unit
variance. The weights are the reference's parameters, drawn on the device
from the seed in one call and loaded into the program by name.

With `trace`, the first `trace_units` units of the window run under
torch.profiler; the rest of the window runs untraced and gives the time a
unit takes for the whole-step share of the peak.
"""

import gc
import math
import random
import statistics
import time

import torch

from benchmark.reference.common import make_leaves, strict_fp32

# a reference leaf whose first gradient is under this share of the median
# leaf's moves under Adam by round-off alone: left out of the change check
STILL_LEAF = 1e-3


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generator(device, seed):
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def data_seed(seed):
    """The data's stream, apart from the weights' (which take the seed)."""
    return (int(seed) * 1000003 + 17) % (2 ** 63)


def fields(gen, count, shape, coarse, white, device):
    """`count` smooth random fields of `shape` (B, C, H, W), float32."""
    B, C, H, W = shape
    out = []
    for _ in range(count):
        low = torch.randn((B, C, *coarse), generator=gen, device=device)
        f = torch.nn.functional.interpolate(low, size=(H, W), mode="bilinear",
                                            align_corners=True)
        f = f + white * torch.randn((B, C, H, W), generator=gen, device=device)
        f = (f - f.mean(dim=(-2, -1), keepdim=True)) / f.std(dim=(-2, -1), keepdim=True)
        out.append(f.contiguous())
    return out


def field_pool(params, mix, seed, device):
    """The mix's pool of fields at the configuration's grid, from the seed."""
    shape = (mix["batch"], len(params["in_channels"]), params["img_shape_x"], params["img_shape_y"])
    return fields(generator(device, data_seed(seed)), mix["pool"], shape, mix["coarse"],
                  mix["white"], device)


def adam_settings(params):
    """(lr, beta1, beta2, eps) of the configuration's Adam."""
    return (float(params["lr"]), float(params["optimizer_beta1"]),
            float(params["optimizer_beta2"]),
            1e-8 * 10.0 ** float(params.get("epsilon_factor", 0) or 0))


def free_program(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Window:
    """Runs call(n), n = 0, 1, ..., back to back until `seconds` have
    passed and at least `least` calls are done; the first `trace_units`
    under the profiler, inside the host range "bench.traced"."""

    def __init__(self, call, seconds, device, trace_units=0, least=1):
        self.prof = None
        sync(device)
        t0 = time.perf_counter()
        n = 0
        t_rest, n_rest = t0, 0
        if trace_units:
            from torch.profiler import ProfilerActivity, profile, record_function
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                with record_function("bench.traced"):
                    for _ in range(trace_units):
                        call(n)
                        n += 1
                    sync(device)
            self.prof = prof
            t_rest, n_rest = time.perf_counter(), n
        deadline = t0 + seconds
        while n < max(least, n_rest + 1) or time.perf_counter() < deadline:
            call(n)
            n += 1
        sync(device)
        t1 = time.perf_counter()
        self.start, self.calls, self.wall_s = t0, n, t1 - t0
        self.traced_calls = n_rest
        # the untraced part: what a call takes without the profiler
        self.rest_s, self.rest_calls = t1 - t_rest, n - n_rest


def gap(a, b, scale):
    return abs(a - b) / scale


def train_gaps(prog, ref):
    """The three numbers the train check compares: the worst step's loss
    against the reference's; the worst leaf's first-gradient norm; the
    worst leaf's change over the checked steps (leaves that the reference
    moves by more than round-off), each against the reference's norm of
    the leaf or of the median leaf, whichever is larger."""
    (lp, gp, cp), (lr, gr, cr) = prog, ref
    loss = max(gap(a, b, abs(b)) for a, b in zip(lp, lr))
    med = statistics.median(gr.values())
    grad = {k: gap(gp[k], gr[k], max(gr[k], med)) for k in gr}
    moved = [k for k in gr if gr[k] >= STILL_LEAF * med]
    medc = statistics.median(cr[k] for k in moved)
    change = {k: gap(cp[k], cr[k], max(cr[k], medc)) for k in moved}
    worst = {"grad_norm_gap": max(grad, key=grad.get), "change_norm_gap": max(change, key=change.get),
             "still_leaves": sorted(set(gr) - set(moved))}
    return ({"loss_gap": loss, "grad_norm_gap": max(grad.values()),
             "change_norm_gap": max(change.values())}, worst)


def run_train(ctx):
    """The "train" kind: returns the measured dict (harness/run.py)."""
    from makani_tpu_torch.utils.trainer import Trainer

    dev, params, mix, ref = ctx.device, ctx.params, ctx.mix, ctx.reference
    lr, b1, b2, eps = adam_settings(params)
    spec = ref.parameters(params)
    trainer = Trainer(dict(params), device=dev)
    w0 = make_leaves(spec, generator(dev, ctx.seed), dev)
    trainer.model.load_state_dict(w0)
    pool = field_pool(params, mix, ctx.seed, dev)
    P = len(pool)
    losses = []

    def step(i):
        losses.append(trainer.train_step(pool[i % P], pool[(i + 1) % P], None, None, lr))

    # set-up: the checked steps, which warm up every shape of the window
    n_check = mix["check_steps"]
    step(0)
    g1 = {k: float(m.float().norm()) / (1.0 - b1) for k, m in trainer.adam_state().mu.items()}
    for i in range(1, n_check):
        step(i)
    change = {k: float((p.detach() - w0[k]).norm()) for k, p in trainer.model_params.items()}
    prog = ([float(v) for v in losses], g1, change)
    del w0
    losses.clear()
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t0
    win = Window(lambda n: step(n_check + n), ctx.seconds, dev, ctx.trace_units(mix), least=1)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    del trainer, losses
    free_program(dev)

    strict_fp32()
    model = ref.Model(params, dev)
    w = make_leaves(spec, generator(dev, ctx.seed), dev)
    batches = [(pool[i % P], pool[(i + 1) % P]) for i in range(n_check)]
    checks, worst = train_gaps(prog, model.train_steps(w, batches, lr, b1, b2, eps))
    finite = all(math.isfinite(v) for v in prog[0])
    return dict(setup_s=setup_s, window=win, peak_bytes=peak, attempted=win.calls,
                failed=failed, traced_units=win.traced_calls,
                rest_units=win.rest_calls, checks=checks, worst=worst, finite=finite,
                e2e={"train_step_ms": 1e3 * win.wall_s / win.calls})


def run_forecast(ctx):
    """The "forecast" kind: returns the measured dict (harness/run.py)."""
    from makani_tpu_torch.utils.inferencer import Inferencer

    dev, params, mix, ref = ctx.device, ctx.params, ctx.mix, ctx.reference
    spec = ref.parameters(params)
    inferencer = Inferencer(dict(params), weights=make_leaves(spec, generator(dev, ctx.seed), dev),
                            device=dev)
    S = inferencer._S
    pool = field_pool(params, mix, ctx.seed, dev)
    P = len(pool)
    # set-up: one forecast warms every shape up and takes its page-locked
    # buffer; a second of its size stays in PyTorch's host cache for the
    # forecast the check keeps
    preds = inferencer._rollout_lite(pool[0])
    spare = torch.empty(preds.shape, dtype=torch.float32, pin_memory=dev.type == "cuda")
    del preds, spare
    sampled = random.Random(int(ctx.seed)).randrange(mix["sample_within"])
    kept = {}

    def forecast(n):
        kept.pop("last", None)
        out = inferencer._rollout_lite(pool[n % P])
        if n == sampled:
            kept[n] = out
        kept["last"] = (n, out)

    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t0
    win = Window(forecast, ctx.seconds, dev, ctx.trace_units(mix), least=sampled + 1)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n_last, last = kept.pop("last")
    kept[n_last] = last
    del inferencer, last
    free_program(dev)

    strict_fp32()
    model = ref.Model(params, dev)
    w = make_leaves(spec, generator(dev, ctx.seed), dev)
    gaps, failed, at = [], 0, []
    with torch.no_grad():
        for n, preds in sorted(kept.items()):
            x = pool[n % P]
            for t in range(S):
                r = model.forward(w, x)
                p = torch.from_numpy(preds[t]).to(dev)
                if not bool(torch.isfinite(p).all()):
                    failed += 1
                gaps.append(float((p - r).norm() / r.norm()))
                at.append((n, t))
                x = p
    units = win.calls * S
    return dict(setup_s=setup_s, window=win, peak_bytes=peak, attempted=units, failed=failed,
                traced_units=win.traced_calls * S, rest_units=win.rest_calls * S,
                checks={"step_gap": max(gaps)}, finite=failed == 0,
                worst={"step_gap": at[gaps.index(max(gaps))], "forecasts": sorted(kept)},
                e2e={"rollout_step_ms": 1e3 * win.wall_s / units})


KINDS = {"train": run_train, "forecast": run_forecast}
