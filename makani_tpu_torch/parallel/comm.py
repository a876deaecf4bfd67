"""Named process groups on torch.distributed.

Counterpart of makani_tpu/parallel/comm.py. makani_tpu lays its devices out
as one mesh with the axes ("data", "h", "w", "fin", "fout"); here each rank
is one process, its coordinates on that mesh are
``np.unravel_index(rank, (data, h, w, fin, fout))`` (data outermost, as
makani_tpu orders its mesh), and every set of axes that a collective runs
over is a process group: the ranks that differ only along those axes. The
composite names are makani_tpu's:

    world   = all axes          model  = ("h", "w", "fin", "fout")
    spatial = ("h", "w")        matmul = ("fin", "fout")

The data size is world // (h*w*fin*fout), as in makani_tpu. The rendezvous
comes from the launcher's environment: torchrun's (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or SLURM's (SLURM_PROCID, SLURM_NTASKS,
SLURM_LOCALID, with MASTER_ADDR and MASTER_PORT). Without one the run is
serial: no process group is made, every size is 1 and every rank 0, and no
collective runs.

Backend and device: rank r runs on cuda:{local_rank % device_count}. Where
every local rank has a card of its own the backend is NCCL; where ranks
share a card (NCCL refuses two ranks on one device) and on the CPU it is
gloo, whose collectives the callers stage through host memory. The choice is
a rule of the layout, logged at init, not a retry after a failure.

The channel axes fin and fout take any size: the modules split their
channels over them (parallel/partitioning, parallel/spmd); every model
family runs on the spatial axes h and w (the transforms', the norms' and
the attention's collectives are theirs). Inside `serial_model_axes()` the
model axes read as one rank, so a network without a spatially parallel
path runs on the whole field as it does serially (spmd.whole_field).
"""

import contextlib
import itertools
import logging
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

AXES = ("data", "h", "w", "fin", "fout")
MODEL_AXES = ("h", "w", "fin", "fout")
COMPOSITE = {
    "world": AXES,
    "model": MODEL_AXES,
    "spatial": ("h", "w"),
    "matmul": ("fin", "fout"),
}

# how long a collective waits for the other ranks before it raises
TIMEOUT = timedelta(seconds=600)

# sizes and coordinates by axis, the groups by frozenset of axes, the backend
# and the rank's device; None when serial
_STATE = None
# how deep the calls are nested in serial_model_axes()
_SERIAL_DEPTH = 0


def _launcher_env():
    """(rank, world size, local rank, local world size) from torchrun's or
    SLURM's environment, or None without one."""
    env = os.environ
    if env.get("WORLD_SIZE") and env.get("RANK"):
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", 0))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    elif int(env.get("SLURM_NTASKS", "1") or 1) > 1:
        world, rank = int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"])
        local = int(env.get("SLURM_LOCALID", 0))
        local_world = int(env.get("SLURM_NTASKS_PER_NODE", world).split("(")[0])
    else:
        return None
    return rank, world, local, local_world


def _axis_sizes(model_parallel_sizes, model_parallel_names, world):
    sizes = dict(zip(model_parallel_names, (int(s) for s in model_parallel_sizes)))
    for ax in MODEL_AXES:
        sizes.setdefault(ax, 1)
    model = int(np.prod([sizes[ax] for ax in MODEL_AXES]))
    if world % model != 0:
        raise ValueError(f"Error, the number of ranks {world} must be divisible by the "
                         f"model parallel size {model}")
    sizes["data"] = world // model
    return sizes


def choose_backend(device_type, local_world_size):
    """"nccl" where each local rank has a card of its own, else "gloo"."""
    if device_type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def init(model_parallel_sizes=(1, 1, 1, 1), model_parallel_names=("h", "w", "fin", "fout"),
         device_type="cuda"):
    """Joins the launcher's process group and makes the axis groups; returns
    the world rank. `device_type` "cuda" puts rank r on its card (it raises
    where CUDA is missing), "cpu" keeps the ranks on the host. Serial (no
    launcher environment): makes no group and returns 0, and raises where
    the sizes ask for more than one rank."""
    global _STATE
    reset()
    launch = _launcher_env()
    if launch is None:
        _axis_sizes(model_parallel_sizes, model_parallel_names, 1)
        return 0
    rank, world, local, local_world = launch
    sizes = _axis_sizes(model_parallel_sizes, model_parallel_names, world)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: CUDA is not available; pass device 'cpu' to "
                               "run the ranks on the CPU")
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = choose_backend(device.type, local_world)
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", "29500")
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", world_size=world,
                                rank=rank, timeout=TIMEOUT, **kw)
    shape = tuple(sizes[ax] for ax in AXES)
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, shape))))
    _STATE = {"sizes": sizes, "coords": coords, "rank": rank, "world": world,
              "local_rank": local, "backend": backend, "device": device, "groups": {}}
    _make_groups(shape)
    if rank == 0:
        logger.info("process groups: %s on %s, backend %s (%s)",
                    {ax: sizes[ax] for ax in AXES}, device, backend,
                    "one card a rank" if backend == "nccl" else
                    "ranks share a card, staged through the host" if device.type == "cuda"
                    else "CPU")
    return rank


def _make_groups(shape):
    """Every rank makes every group, in the same order (new_group is a
    collective of the whole world)."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    live = [i for i, n in enumerate(shape) if n > 1]
    for k in range(1, len(live) + 1):
        for subset in itertools.combinations(live, k):
            moved = np.moveaxis(ranks, list(subset), list(range(len(shape) - k, len(shape))))
            blocks = moved.reshape(-1, int(np.prod([shape[i] for i in subset])))
            key = frozenset(AXES[i] for i in subset)
            for block in blocks:
                group = dist.new_group([int(r) for r in block])
                if _STATE["rank"] in block:
                    _STATE["groups"][key] = (group, [int(r) for r in block])


def reset():
    """Forgets the groups and leaves the process group."""
    global _STATE
    if _STATE is not None and dist.is_initialized():
        dist.destroy_process_group()
    _STATE = None


def is_initialized():
    return _STATE is not None


@contextlib.contextmanager
def serial_model_axes():
    """Inside, h, w, fin and fout (and the composites over them) read as one
    rank in get_size, get_rank, get_group and get_group_ranks; the data
    axis keeps its size. It nests, and the layout comes back on exit, an
    exception's too.

    Autograd runs the backward of what was recorded inside after the scope
    has closed, so nothing recorded inside may read the layout in backward:
    no collective of parallel/spmd is recorded (each returns its input on a
    group of one rank); the autograd Functions of the SFNO's path
    (spectral_mm's legdot, dhconv and griddot, complex_kernels'
    contract_dhconv_kernel, gelu's gelu_bf16) read none in backward; and
    layers.remat enters the scope again for the forward it recomputes."""
    global _SERIAL_DEPTH
    _SERIAL_DEPTH += 1
    try:
        yield
    finally:
        _SERIAL_DEPTH -= 1


def in_serial_model_axes():
    """Whether the calls run inside serial_model_axes()."""
    return _SERIAL_DEPTH > 0


def _axes(name):
    if isinstance(name, str):
        return COMPOSITE.get(name, (name,))
    return tuple(name)


def _size(ax):
    return 1 if _SERIAL_DEPTH and ax in MODEL_AXES else _STATE["sizes"][ax]


def _group_key(name):
    return frozenset(ax for ax in _axes(name) if _size(ax) > 1)


def get_size(name):
    """The size of an axis, a composite name or a tuple of axes (1 when
    serial)."""
    if _STATE is None:
        return 1
    return int(np.prod([_size(ax) for ax in _axes(name)]))


def get_rank(name):
    """The rank's coordinate along an axis, or its place in a composite
    group (makani_tpu's order: the first axis outermost)."""
    if _STATE is None:
        return 0
    rank = 0
    for ax in _axes(name):
        if _size(ax) > 1:
            rank = rank * _STATE["sizes"][ax] + _STATE["coords"][ax]
    return rank


def get_group(name):
    """The rank's process group over an axis, a composite name or a tuple
    of axes; None where that group has one rank."""
    if _STATE is None:
        return None
    key = _group_key(name)
    if not key:
        return None
    return _STATE["groups"][key][0]


def get_group_ranks(name):
    """The world ranks of the rank's group over `name`, in group order."""
    if _STATE is None:
        return [0]
    key = _group_key(name)
    return _STATE["groups"][key][1] if key else [_STATE["rank"]]


def is_distributed(name):
    return get_size(name) > 1


def get_world_size():
    return 1 if _STATE is None else _STATE["world"]


def get_world_rank():
    return 0 if _STATE is None else _STATE["rank"]


def get_local_rank():
    """The node-local rank (torchrun's LOCAL_RANK, SLURM's SLURM_LOCALID)."""
    if _STATE is not None:
        return _STATE["local_rank"]
    for var in ("LOCAL_RANK", "SLURM_LOCALID"):
        if os.environ.get(var):
            return int(os.environ[var])
    return 0


def get_backend():
    return None if _STATE is None else _STATE["backend"]


def get_device():
    """The rank's device (None when serial)."""
    return None if _STATE is None else _STATE["device"]


def barrier():
    if _STATE is not None:
        dist.barrier()
