"""Checkpoint save and restore in the port's own format.

Counterpart of makani_tpu/utils/checkpoint.py. makani_tpu writes orbax
checkpoints, and orbax imports JAX, so the port can neither read nor write
them: it writes `torch.save` files that load with
``torch.load(..., weights_only=True)``. A makani_tpu checkpoint crosses over
outside the port: restore it with orbax, flatten the trees with
``flax.traverse_util.flatten_dict(..., sep="/")``, load them with
tools/convert_jax_params (`load_jax_params`, `load_jax_opt_state`), then
`save_checkpoint` here.

The two layouts of makani_tpu:
- single-dir (the best checkpoint, model packages):
  <path>/model.pt, <path>/opt_state.pt, <path>/counters.json
- versioned (per-epoch checkpoints, `TrainingCheckpointer`): step dirs
  <root>/<step>/{model.pt, opt_state.pt} with <root>/counters-<step>.json,
  keep-N retention.
`restore_checkpoint` and `checkpoint_exists` take either (a versioned root
resolves to its latest step).

The model is a dict of tensors (a state dict, or `named_parameters()`), saved
under its keys. The optimizer state is the tuple of utils/optimizers' chain:
each `AdamState` in it is stored flattened as ``<i>/count``,
``<i>/mu/<parameter>`` and ``<i>/nu/<parameter>`` (i its place in the tuple;
the moments in their own dtype, bf16 included) and rebuilt on restore onto a
template of the same structure. Restoring onto a template whose keys, shapes
or dtypes differ raises, naming the path and the keys.

Every directory is written under a temporary name beside its target and
renamed into place, so a process that dies mid-save leaves the previous
checkpoint as it was (orbax's guarantee); an existing single-dir checkpoint
is renamed aside, the new one renamed in, and the old one removed.

Writes are asynchronous, as orbax's are in makani_tpu: `save_checkpoint` and
`TrainingCheckpointer.save` copy every tensor to the host before they return
(the caller may then change its tensors in place), and the files are written
by one background thread, in the order of the saves; a versioned save writes
its step dir, then its counters, then prunes the steps past keep-N.
`wait_for_saves` (and `TrainingCheckpointer.wait` / `close`) blocks until
every write is on disk, and `restore_checkpoint` waits first. A write that
failed raises its exception at the next `wait_for_saves` or save; the
previous checkpoint stays as it was.

A file always holds whole leaves, as a serial run saves them: on several
ranks the Trainer gathers every split leaf and rank 0 writes, and
`restore_checkpoint(..., shards=...)` gives each rank its slice of the
saved leaves, so checkpoints cross between serial runs and any data or
spatial decomposition (makani_tpu's orbax restores across meshes).
"""

import concurrent.futures
import json
import os
import re
import shutil
import tempfile
import threading
import time

import torch

from makani_tpu_torch.parallel import partitioning
from makani_tpu_torch.utils.optimizers import AdamState

MODEL_FILE = "model.pt"
OPT_FILE = "opt_state.pt"


def _counters_path(path):
    return os.path.join(path, "counters.json")


class _Writer:
    """One background thread that runs the writes in submission order and
    keeps their futures until a wait collects them; `times` holds each
    finished write's (path, seconds)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._executor = None
        self._pending = []
        self.times = []

    def submit(self, path, fn):
        self.raise_failed()

        def timed():
            t0 = time.perf_counter()
            fn()
            self.times.append((path, time.perf_counter() - t0))
        with self._lock:
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="checkpoint-writer")
            self._pending.append(self._executor.submit(timed))

    def _collect(self, done_only):
        # the writes run in order on one thread: when the oldest is not
        # done, none is; a failure leaves the later writes pending
        while True:
            with self._lock:
                if not self._pending or (done_only and not self._pending[0].done()):
                    return
                future = self._pending.pop(0)
            future.result()

    def raise_failed(self):
        self._collect(done_only=True)

    def wait(self):
        self._collect(done_only=False)


_WRITER = _Writer()


def wait_for_saves():
    """Block until every save is on disk; raises the exception of a write
    that failed."""
    _WRITER.wait()


def write_times():
    """(path, seconds) of every background write finished so far."""
    return list(_WRITER.times)


def flatten_opt_state(opt_state):
    """{name: tensor} of a chain's state tuple (None for a stateless stage)."""
    flat = {}
    for i, stage in enumerate(opt_state):
        if stage is None:
            continue
        if not isinstance(stage, AdamState):
            raise TypeError(f"optimizer state stage {i} is a {type(stage).__name__}; "
                            "checkpoints hold AdamState stages")
        flat[f"{i}/count"] = torch.tensor(int(stage.count), dtype=torch.int64)
        for name in ("mu", "nu"):
            for key, value in getattr(stage, name).items():
                flat[f"{i}/{name}/{key}"] = value
    return flat


def _host_copy(tensors):
    """A copy of every tensor on the host, taken now."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _save_tensors(tensors, path):
    torch.save(tensors, path)


def _write_dir(path, write):
    """Run write(tmp_dir), then rename tmp_dir to `path`."""
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{name}.tmp-", dir=parent)
    try:
        write(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    old = None
    if os.path.exists(path):
        old = tempfile.mkdtemp(prefix=f".{name}.old-", dir=parent)
        os.rename(path, os.path.join(old, name))
    os.rename(tmp, path)
    if old is not None:
        shutil.rmtree(old)


def _json_copy(counters):
    """A copy of the counters taken now; raises here if they are not JSON."""
    return None if counters is None else json.loads(json.dumps(counters))


def _write_json(obj, path):
    """`obj` as JSON at `path`, written under a temporary name and renamed."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _single_dir_writer(path, params, opt_state, counters):
    """Copy the tensors to the host now; returns the function that writes
    them as a single-dir checkpoint at `path`."""
    path = os.path.abspath(path)
    model = _host_copy(params)
    opt = None if opt_state is None else _host_copy(flatten_opt_state(opt_state))
    counters = _json_copy(counters)

    def write(tmp):
        _save_tensors(model, os.path.join(tmp, MODEL_FILE))
        if opt is not None:
            _save_tensors(opt, os.path.join(tmp, OPT_FILE))
        if counters is not None:
            with open(_counters_path(tmp), "w") as f:
                json.dump(counters, f)
    return lambda: _write_dir(path, write)


def save_checkpoint(path, params, opt_state=None, counters=None):
    """Save a single-dir checkpoint: `params` (dict of tensors), the
    optimizer state and the counters (a JSON-able dict). Returns once the
    tensors are copied to the host; the files are written in the
    background (`wait_for_saves`)."""
    _WRITER.submit(os.path.abspath(path), _single_dir_writer(path, params, opt_state, counters))


def _steps(root):
    if not os.path.isdir(root):
        return []
    return sorted(int(n) for n in os.listdir(root)
                  if re.fullmatch(r"\d+", n) and os.path.isfile(os.path.join(root, n, MODEL_FILE)))


def _resolve(path):
    """A single-dir checkpoint passes through; a versioned root resolves to
    its latest step dir."""
    path = os.path.abspath(path)
    if os.path.isfile(os.path.join(path, MODEL_FILE)):
        return path
    steps = _steps(path)
    if steps:
        return os.path.join(path, str(steps[-1]))
    return path


def _load_onto(file, template, path, shards=None):
    """The tensors of `file` on the template's devices; raises on a key,
    shape or dtype that differs from the template's. A template tensor that
    is a rank's shard of a leaf (`shards`, {key: parallel/partitioning.Shard})
    takes its slice of the saved whole leaf."""
    shards = shards or {}
    state = torch.load(file, map_location="cpu", weights_only=True, mmap=True)
    missing = sorted(set(template) - set(state))
    unexpected = sorted(set(state) - set(template))

    def shape(k):
        return torch.Size(shards[k].global_shape) if k in shards else template[k].shape

    differ = {k: (tuple(state[k].shape), state[k].dtype, tuple(shape(k)), template[k].dtype)
              for k in sorted(set(state) & set(template))
              if state[k].shape != shape(k) or state[k].dtype != template[k].dtype}
    if missing or unexpected or differ:
        raise RuntimeError(
            f"checkpoint {path} does not fit its template ({os.path.basename(file)}): "
            f"missing {missing}; unexpected {unexpected}; "
            f"shape/dtype (saved, template) {differ}")
    # a copy, so no restored tensor is backed by the file's mapping
    return {k: partitioning.local_slice(k, state[k], shards).to(template[k].device, copy=True)
            for k in template}


def _unflatten_opt_state(flat, template):
    out = []
    for i, stage in enumerate(template):
        if stage is None:
            out.append(None)
            continue
        out.append(AdamState(
            count=int(flat[f"{i}/count"]),
            mu={k: flat[f"{i}/mu/{k}"] for k in stage.mu},
            nu={k: flat[f"{i}/nu/{k}"] for k in stage.nu}))
    return tuple(out)


def opt_state_shards(opt_state, shards):
    """The shards of a chain's flattened state, named as flatten_opt_state
    names them, from the parameters' shards."""
    out = {}
    for key in flatten_opt_state(opt_state):
        param = key.split("/", 2)[-1]
        if key.count("/") == 2 and param in shards:
            out[key] = shards[param]
    return out


def restore_checkpoint(path, params_template, opt_state_template=None, shards=None):
    """Restore onto the templates (a dict of tensors, a chain's state tuple),
    each tensor on its template's device. Returns (params, opt_state or
    None, counters). Waits for the saves in flight first. `shards` names the
    template's leaves that are a rank's shard: they take their slice of the
    whole leaf the file holds, so a checkpoint saved serially or on any
    decomposition restores on any other."""
    wait_for_saves()
    path = _resolve(path)
    model_file = os.path.join(path, MODEL_FILE)
    if not os.path.isfile(model_file):
        raise FileNotFoundError(f"no checkpoint at {path} (no {MODEL_FILE})")
    params = _load_onto(model_file, params_template, path, shards)

    opt_state = None
    opt_file = os.path.join(path, OPT_FILE)
    if opt_state_template is not None and os.path.isfile(opt_file):
        template = flatten_opt_state(opt_state_template)
        opt_state = _unflatten_opt_state(
            _load_onto(opt_file, template, path, opt_state_shards(opt_state_template,
                                                                  shards or {})),
            opt_state_template)

    counters = {}
    # single-dir checkpoints keep their counters inside; versioned steps
    # keep them under the root as counters-<step>.json
    candidates = [_counters_path(path)]
    root, leaf = os.path.split(path)
    if re.fullmatch(r"\d+", leaf or ""):
        candidates.append(os.path.join(root, f"counters-{leaf}.json"))
    for cpath in candidates:
        if os.path.exists(cpath):
            with open(cpath) as f:
                counters = json.load(f)
            break
    return params, opt_state, counters


def checkpoint_exists(path):
    wait_for_saves()
    return os.path.isfile(os.path.join(_resolve(path), MODEL_FILE))


class TrainingCheckpointer:
    """Versioned per-epoch checkpoints with keep-N retention. Step dirs use
    the single-dir layout, so restore_checkpoint reads them directly."""

    def __init__(self, directory, max_to_keep=3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def save(self, step, params, opt_state=None, counters=None):
        """Copy the tensors to the host; in the background, write the step
        dir, then counters-<step>.json, then prune past keep-N."""
        step = int(step)
        path = os.path.join(self.directory, str(step))
        write_step = _single_dir_writer(path, params, opt_state, None)
        counters = _json_copy(counters)

        def write():
            write_step()
            if counters is not None:
                _write_json(counters, os.path.join(self.directory, f"counters-{step}.json"))
            for old in _steps(self.directory)[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
                cpath = os.path.join(self.directory, f"counters-{old}.json")
                if os.path.exists(cpath):
                    os.remove(cpath)
        _WRITER.submit(path, write)

    def wait(self):
        wait_for_saves()

    def close(self):
        wait_for_saves()

    def latest_step(self):
        wait_for_saves()
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, params_template, opt_state_template=None, step=None):
        """Returns (params, opt_state or None, counters)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return restore_checkpoint(os.path.join(self.directory, str(step)),
                                  params_template, opt_state_template)
