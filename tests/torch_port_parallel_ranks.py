"""The ranks of the port's parallel tests (tests/test_torch_port_parallel*.py).

`run_ranks(fn, sizes, world, *args)` spawns `world` processes on the CPU,
each one rank of a gloo process group (parallel/comm, the model-parallel
`sizes` [h, w, fin, fout], the data axis the ranks left over), one thread
each, runs `fn(*args)` on every rank and returns the ranks' results in rank
order; a rank that raises fails the call with its traceback. This module and
the functions it runs import torch and the port only, never JAX: the test
files that compare against makani_tpu keep JAX in the pytest process.
"""

import os
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 240


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank, world, port, sizes, name, args, queue):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from makani_tpu_torch.parallel import comm
    try:
        comm.init(sizes, device_type="cpu")
        queue.put((rank, True, globals()[name](*args)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        comm.reset()


def run_ranks(fn, sizes, world, *args, timeout=RANK_TIMEOUT_S):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, list(sizes), fn.__name__,
                                                  args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, ok, value = queue.get(timeout=timeout)
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


def _numpy(tensors):
    return {k: v.detach().float().numpy().copy() for k, v in tensors.items()}


# --------------------------------------------------------------------------
# what the ranks run
# --------------------------------------------------------------------------

def sht_pairs(cases):
    """For each (engine, nlat, nlon, grid, seed): the rank's coefficients of
    the seeded field's patch, its round trip and the gradient of the round
    trip's sum of squares, with the rank's (lat, lon, l, m) windows."""
    from makani_tpu_torch.ops import sht
    from makani_tpu_torch.parallel import spmd
    out = {}
    for engine, nlat, nlon, grid, seed in cases:
        sht.set_coeff_engine(engine)
        x = torch.from_numpy(np.random.RandomState(seed).randn(2, 3, nlat, nlon)
                             .astype(np.float32))
        fwd, inv = sht.RealSHT(nlat, nlon, grid=grid), sht.InverseRealSHT(nlat, nlon, grid=grid)
        xl = spmd.local_patch(x, (nlat, nlon)).clone().requires_grad_(True)
        coeffs = fwd(xl)
        back = inv(coeffs)
        spmd.all_reduce_sum(back.square().sum(), "spatial").backward()
        out[(engine, nlat)] = dict(
            coeffs=coeffs.detach().numpy(), back=back.detach().numpy(), grad=xl.grad.numpy(),
            lat=spmd.patch(nlat, "h"), lon=spmd.patch(nlon, "w"),
            l=spmd.patch(fwd.lmax, "h"), m=spmd.patch(fwd.mmax, "w"))
    sht.set_coeff_engine("kernel")
    return out


def sht_pairs_at(precision, cases):
    """sht_pairs at the transform `precision` ("high" again after it)."""
    from makani_tpu_torch.ops import sht
    sht.set_transform_precision(precision)
    try:
        return sht_pairs(cases)
    finally:
        sht.set_transform_precision("high")


def fft_pairs(cases):
    """For each (kind "fft2" or "fft3", input shape, transform kwargs, seed):
    the rank's coefficient block of the seeded field's patch, its round trip
    and the gradient of the round trip's sum of squares, with the rank's
    (lat, lon) and (l, m) windows."""
    from makani_tpu_torch.ops.fft import InverseRealFFT2, RealFFT2
    from makani_tpu_torch.ops.fft3d import InverseRealFFT3, RealFFT3
    from makani_tpu_torch.parallel import spmd
    out = []
    for kind, shape, kw, seed in cases:
        x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))
        pair = (RealFFT2, InverseRealFFT2) if kind == "fft2" else (RealFFT3, InverseRealFFT3)
        fwd, inv = (cls(*shape[2:], **kw) for cls in pair)
        xl = spmd.local_patch(x, shape[-2:]).clone().requires_grad_(True)
        coeffs = fwd(xl)
        back = inv(coeffs)
        spmd.all_reduce_sum(back.square().sum(), "spatial").backward()
        lmax, mmax = (fwd.lmax, fwd.mmax) if kind == "fft2" else (fwd.lhmax, fwd.lwmax)
        out.append(dict(coeffs=coeffs.detach().numpy(), back=back.detach().numpy(),
                        grad=xl.grad.numpy(), lat=spmd.patch(shape[-2], "h"),
                        lon=spmd.patch(shape[-1], "w"), l=spmd.patch(lmax, "h"),
                        m=spmd.patch(mmax, "w")))
    return out


def _sfno(kwargs, state):
    from makani_tpu_torch.models.networks.sfnonet import SphericalFourierNeuralOperatorNet
    from makani_tpu_torch.parallel import partitioning
    net = SphericalFourierNeuralOperatorNet(**kwargs)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return net, partitioning.shard_module(net)


def sfno_forward_and_grads(kwargs, state, x, engine, precision):
    """The network of `kwargs` with the whole `state`, cut to the rank's
    shards, on the coefficient `engine` at `precision`: its output on the
    rank's patch of `x`, and the gradients of mean(y**2) over the whole
    output, reduced as the Trainer reduces them."""
    from makani_tpu_torch.ops import complex_ops, sht
    from makani_tpu_torch.parallel import partitioning, spmd
    sht.set_coeff_engine(engine)
    sht.set_transform_precision(precision)
    complex_ops.set_contraction_precision(precision)
    net, shards = _sfno(kwargs, state)
    hw = x.shape[-2:]
    y = net(spmd.local_patch(torch.from_numpy(x), hw))
    loss = spmd.all_reduce_sum(y.square().sum(), "spatial") / float(np.prod(x.shape))
    loss.backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    partitioning.reduce_gradients(grads, shards)
    sht.set_coeff_engine("kernel")
    return dict(y=y.detach().numpy(), grads=_numpy(grads), shards=dict(shards),
                lat=spmd.patch(hw[0], "h"), lon=spmd.patch(hw[1], "w"))


def sfno_in_training(kwargs, state, x, seed):
    """The network of `kwargs` on the "xla" engine at "highest", in training
    under DropoutKey(seed, 1, 0): the rank's output patch and the gradients
    of mean(y**2), reduced as the Trainer reduces them."""
    from makani_tpu_torch.models.common.layers import DropoutKey, use_dropout_key
    from makani_tpu_torch.ops import complex_ops, sht
    from makani_tpu_torch.parallel import partitioning, spmd
    sht.set_coeff_engine("xla")
    sht.set_transform_precision("highest")
    complex_ops.set_contraction_precision("highest")
    net, shards = _sfno(kwargs, state)
    hw = x.shape[-2:]
    with use_dropout_key(DropoutKey(seed, 1, 0)):
        y = net(spmd.local_patch(torch.from_numpy(x), hw), deterministic=False)
    loss = spmd.all_reduce_sum(y.square().sum(), "spatial") / float(np.prod(y.shape[:2]) *
                                                                   np.prod(hw))
    loss.backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    partitioning.reduce_gradients(grads, shards)
    return dict(y=y.detach().numpy(), grads=_numpy(grads), shards=dict(shards),
                lat=spmd.patch(hw[0], "h"), lon=spmd.patch(hw[1], "w"))


def checkpoint_round_trip(kwargs, state, serial_dir, out_dir):
    """Restores the serial checkpoint at `serial_dir` onto the rank's shards
    (model and an Adam state), then saves it from the shards as the Trainer
    does (every split leaf gathered, rank 0 writing) at `out_dir`."""
    from makani_tpu_torch.parallel import comm, partitioning
    from makani_tpu_torch.utils import checkpoint
    from makani_tpu_torch.utils.optimizers import AdamState
    net, shards = _sfno(kwargs, state)
    params = dict(net.named_parameters())
    template = AdamState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                         {k: torch.zeros_like(p, dtype=torch.bfloat16)
                          for k, p in params.items()})
    restored, opt, counters = checkpoint.restore_checkpoint(
        serial_dir, net.state_dict(), (template,), shards=shards)
    whole = {k: partitioning.gather_full(k, v, shards) for k, v in restored.items()}
    opt = opt[0]
    whole_opt = AdamState(opt.count,
                          {k: partitioning.gather_full(k, v, shards) for k, v in opt.mu.items()},
                          {k: partitioning.gather_full(k, v, shards) for k, v in opt.nu.items()})
    if comm.get_world_rank() == 0:
        checkpoint.save_checkpoint(out_dir, whole, (whole_opt,), counters)
        checkpoint.wait_for_saves()
    comm.barrier()
    return dict(local=_numpy(restored), mu=_numpy(opt.mu), shards=dict(shards))


def _load_whole(model, state, shards):
    from makani_tpu_torch.parallel import partitioning
    model.load_state_dict({k: partitioning.local_slice(k, torch.from_numpy(v), shards)
                           for k, v in state.items()})


def trainer_steps(params_dict, state):
    """The port's Trainer on the rank (its loader's rows and window of each
    global batch) from the whole `state`, through its epoch's steps: the
    losses, and the whole weights after every step (each split leaf
    gathered)."""
    from makani_tpu_torch.parallel import partitioning
    from makani_tpu_torch.utils.trainer import Trainer
    from makani_tpu_torch.utils.yparams import YParams
    trainer = Trainer(YParams.from_dict(params_dict), device="cpu")
    _load_whole(trainer.model, state, trainer.shards)
    losses, weights = [], []
    for step, batch in enumerate(trainer.train_dataloader, start=1):
        trainer.iters = step
        losses.append(float(trainer.train_step(*trainer._device_batch(batch),
                                               trainer.scheduler(step))))
        weights.append(_numpy({k: partitioning.gather_full(k, p.detach(), trainer.shards)
                               for k, p in trainer.model_params.items()}))
    return dict(losses=losses, weights=weights, data=trainer.data_parallel_size,
                shards=dict(trainer.shards))


def validation_loss(params_dict, state):
    """The Inferencer's scored epoch on the rank, from the whole `state`:
    its validation loss."""
    from makani_tpu_torch.utils.inferencer import Inferencer
    from makani_tpu_torch.utils.yparams import YParams
    inferencer = Inferencer(YParams.from_dict(params_dict), device="cpu",
                            weights=None)
    _load_whole(inferencer.model, state, inferencer.model.shards)
    logs = inferencer.inference_epoch(output_channels=list(inferencer.params.out_channels))
    return logs["base"]["validation loss"]


def optimizer_modes(whole_params, whole_grads, splits, modes):
    """Two updates of each optimizer mode on the rank's shards of the whole
    leaves (`splits`: {name: [(dim, axis)]}): the rank's parameters and
    moments after them."""
    from makani_tpu_torch.ops.fused_adam import fused_adam_apply_plain
    from makani_tpu_torch.parallel import comm, partitioning, spmd
    from makani_tpu_torch.utils.optimizers import AdamState, apply_updates, build_optimizer
    from makani_tpu_torch.utils.yparams import ParamsBase
    shards = {}
    for key, dims in splits.items():
        shape = whole_params[key].shape
        shards[key] = partitioning.Shard(shape, tuple(
            partitioning.Split(d, ax, *spmd.patch(shape[d], ax))
            for d, ax in dims if comm.get_size(ax) > 1))
    local = {k: partitioning.local_slice(k, torch.from_numpy(v), shards)
             for k, v in whole_params.items()}
    grads = {k: partitioning.local_slice(k, torch.from_numpy(v), shards)
             for k, v in whole_grads.items()}
    out = {}
    for mode in modes:
        params = {k: v.clone() for k, v in local.items()}
        if mode.startswith("adafactor"):
            cfg = ParamsBase()
            cfg.update_params({"optimizer_type": "Adafactor", "gradient_clip_norm": 0.5})
            tx = build_optimizer(cfg, shards)
            state = tx.init(params)
            for _ in range(2):
                updates, state = tx.update(grads, state, params)
                apply_updates(params, updates, 1e-2)
            out[mode] = (_numpy(params), {})
            continue
        state = AdamState(0, {k: torch.zeros_like(v, dtype=torch.bfloat16)
                              for k, v in params.items()},
                          {k: torch.zeros_like(v, dtype=torch.bfloat16)
                           for k, v in params.items()})
        kw = dict(max_norm=0.5 if "clip" in mode else None, lamb=mode == "lamb",
                  weight_decay=0.1)
        for _ in range(2):
            fused_adam_apply_plain(params, grads, state, 1e-3, shards=shards, **kw)
        out[mode] = (_numpy(params), _numpy(state.mu))
    return dict(out=out, shards=shards)


def augment_and_h1(inp, tar, seed):
    """The Trainer's augmentation (longitude roll and input noise, drawn for
    the global batch) on the rank's patch, and the geometric H1 loss of the
    patches, both as the rank holds them."""
    from makani_tpu_torch.parallel import spmd
    from makani_tpu_torch.utils.losses import GeometricH1Loss
    from makani_tpu_torch.utils.trainer import augment_batch
    hw = inp.shape[-2:]
    gen = torch.Generator().manual_seed(seed)
    x, y = (spmd.local_patch(torch.from_numpy(a), hw) for a in (inp, tar))
    xa, ya, _, _ = augment_batch(x, y, None, None, gen, True, 0.3, tuple(hw))
    loss = GeometricH1Loss(tuple(hw))(x, y)
    return dict(inp=xa.numpy(), tar=ya.numpy(), h1=loss.numpy(),
                lat=spmd.patch(hw[0], "h"), lon=spmd.patch(hw[1], "w"))


def network_forward_and_grads(module, name, kwargs, state, x, engine="xla", precision="highest",
                              dropout_seed=None):
    """The network `module`.`name`(**kwargs) with the whole `state`, cut to
    the rank's shards, on the coefficient `engine` at `precision`: its output
    on the rank's patch of `x` (deterministic, or in training under
    DropoutKey(dropout_seed, 1, 0)) and the gradients of mean(y**2) over the
    whole output, reduced as the Trainer reduces them."""
    import contextlib
    import importlib
    from makani_tpu_torch.models.common.layers import DropoutKey, use_dropout_key
    from makani_tpu_torch.ops import complex_ops, sht
    from makani_tpu_torch.parallel import partitioning, spmd
    sht.set_coeff_engine(engine)
    sht.set_transform_precision(precision)
    complex_ops.set_contraction_precision(precision)
    net = getattr(importlib.import_module(module), name)(**kwargs)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    shards = partitioning.shard_module(net)
    hw = x.shape[-2:]
    train = dropout_seed is not None
    with (use_dropout_key(DropoutKey(dropout_seed, 1, 0)) if train else contextlib.nullcontext()):
        y = net(spmd.local_patch(torch.from_numpy(x), hw), deterministic=not train)
    whole = float(np.prod(y.shape[:2]) * np.prod(hw))
    loss = spmd.all_reduce_sum(y.square().sum(), "spatial") / whole
    loss.backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    partitioning.reduce_gradients(grads, shards)
    sht.set_coeff_engine("kernel")
    return dict(y=y.detach().numpy(), grads=_numpy(grads), shards=dict(shards),
                lat=spmd.patch(hw[0], "h"), lon=spmd.patch(hw[1], "w"))


def precipnet(precip_out_chans=2, **backbone):
    """PrecipNet of `precip_out_chans` over an AFNO v1 of `backbone`'s
    arguments (a constructor for network_forward_and_grads)."""
    from makani_tpu_torch.models.networks.afnonet import (
        AdaptiveFourierNeuralOperatorNetV1,
        PrecipNet,
    )
    return PrecipNet(AdaptiveFourierNeuralOperatorNetV1(**backbone), out_chans=precip_out_chans)


def with_attention_block(block_size, name, args):
    """The rank function `name`(*args) at the attention's key-block size
    `block_size`, the default restored after."""
    from makani_tpu_torch.models.common import attention
    prev = attention._DEFAULT_BLOCK_SIZE
    attention.set_attention_block_size(block_size)
    try:
        return globals()[name](*args)
    finally:
        attention.set_attention_block_size(prev)


def norm_bf16(x, weight, bias, r):
    """InstanceNorm2d at "bf16" statistics on the rank's patch of bf16 `x`:
    its output, and the gradients of the sum over the whole field of y * r
    (the input's on the patch; the affine's summed over the spatial group,
    as the Trainer reduces a shared leaf's)."""
    from makani_tpu_torch.models.common import layers
    from makani_tpu_torch.parallel import partitioning, spmd
    hw = x.shape[-2:]
    m = layers.InstanceNorm2d(x.shape[1])
    m.weight.data, m.bias.data = torch.from_numpy(weight), torch.from_numpy(bias)
    xl = spmd.local_patch(torch.from_numpy(x), hw).to(torch.bfloat16).requires_grad_(True)
    rl = spmd.local_patch(torch.from_numpy(r), hw).to(torch.bfloat16)
    layers.set_norm_stats_mode("bf16")
    try:
        y = m(xl)
    finally:
        layers.set_norm_stats_mode("f32")
    spmd.all_reduce_sum((y * rl).float().sum(), "spatial").backward()
    grads = {"weight": m.weight.grad, "bias": m.bias.grad}
    partitioning.reduce_gradients(grads, {})
    return dict(y=y.detach().float().numpy(), gx=xl.grad.float().numpy(), grads=_numpy(grads),
                lat=spmd.patch(hw[0], "h"), lon=spmd.patch(hw[1], "w"))


def registered_model(params_dict, state, x, unroll=False, control=False, patch_only=False):
    """The stepper get_model builds on the rank for `params_dict` (a network
    registered from a file, which sets no spatially_parallel), with the
    whole `state`: its output on the rank's patch of `x` (with `unroll` the
    MultiStepWrapper's unrolled steps in training), the gradients of
    mean(y**2) over the whole output, reduced as the Trainer reduces them,
    its split leaves and its state dict's keys; with `patch_only` also the
    network's output on the patch alone, nothing gathered (`alone`).
    `control` runs spmd.whole_field without its copy_to, so the gathered
    field's cotangent keeps only the rank's own share."""
    from makani_tpu_torch.models.model_registry import get_model
    from makani_tpu_torch.parallel import partitioning, spmd
    from makani_tpu_torch.utils.yparams import ParamsBase
    model = get_model(ParamsBase.from_dict(params_dict), device="cpu")
    _load_whole(model, state, model.shards)
    hw = x.shape[-2:]
    xl = spmd.local_patch(torch.from_numpy(x), hw)
    copy_to = spmd.copy_to
    if control:
        spmd.copy_to = lambda t, group_name: t
    try:
        y = model(xl, deterministic=not unroll)
        whole = float(np.prod(y.shape[:2]) * np.prod(hw))
        (spmd.all_reduce_sum(y.square().sum(), "spatial") / whole).backward()
    finally:
        spmd.copy_to = copy_to
    grads = {k: p.grad for k, p in model.named_parameters()}
    partitioning.reduce_gradients(grads, model.shards)
    out = dict(y=y.detach().numpy(), grads=_numpy(grads), shards=dict(model.shards),
               keys=list(model.state_dict()), lat=spmd.patch(hw[0], "h"),
               lon=spmd.patch(hw[1], "w"))
    if patch_only:
        with torch.no_grad():
            out["alone"] = model.model(xl).numpy()
    return out


def run_cases(cases):
    """Each (function name, args) of `cases` on the rank, in order: the list
    of their results (one spawn of the ranks for many checks)."""
    return [globals()[name](*args) for name, args in cases]


def dropout_masks(module, name, kwargs, state, x, seed):
    """network_forward_and_grads in training under DropoutKey(seed, 1, 0),
    with every mask the network drew on the rank: (site, the (dim, start,
    stop) of the channels it was cut to or None, the mask)."""
    from makani_tpu_torch.models.common import layers
    from makani_tpu_torch.parallel import spmd
    masks, real = [], layers.rank_mask

    def recording(shape, keep, site, device, global_hw=None, channel=None):
        mask = real(shape, keep, site, device, global_hw, channel)
        cut = None
        if channel is not None and channel[1] is not None:
            d, axis, size = channel
            start, n = spmd.patch(size, axis)
            cut = (d % len(shape), start, start + n)
        masks.append((site, cut, mask.numpy().copy()))
        return mask

    layers.rank_mask = recording
    try:
        out = network_forward_and_grads(module, name, kwargs, state, x, "xla", "highest", seed)
    finally:
        layers.rank_mask = real
    out["masks"] = masks
    return out


def validation_logs(params_dict, state):
    """The Trainer's validation epoch on the rank from the whole `state`:
    its logs, whether its metrics split the channels, and the rank's
    channels [start, stop)."""
    from makani_tpu_torch.utils.trainer import Trainer
    from makani_tpu_torch.utils.yparams import YParams
    trainer = Trainer(YParams.from_dict(params_dict), device="cpu")
    _load_whole(trainer.model, state, trainer.shards)
    _, _, logs = trainer.validate_one_epoch(1)
    n = trainer.metrics.N_out_channels
    return dict(logs=logs, split=trainer.metrics.split_data_channels,
                channels=list(trainer.metrics.channels.indices(n)[:2]))
