"""Experiment log (counterpart of makani_tpu/utils/wandb_compat.py).

makani_tpu logs epochs, metrics and the rollouts table to Weights & Biases
where the wandb package imports, else to JSON lines in the run's directory
with the same call surface; so does the port. The module's `init`, `log`,
`watch`, `login`, `finish`, `log_artifact`, `Table` and `Artifact` are
wandb's where it imports, else those of a module-wide `JsonlRun`, the file
backend: wandb_run_id.txt and wandb_log.jsonl as makani_tpu's file backend
writes them, a `Table` as {"_type": "table", "columns": ..., "data": ...},
`watch` as one snapshot of parameter histograms (`tree_histograms`) and
`log_artifact` as a copy of the artifact's files under
<run dir>/artifacts/<name>/ with a logged manifest. The Trainer creates its
log with `experiment_log()` where the config sets `log_to_wandb`, as
makani_tpu gates it.

`tree_histograms` takes a `named_parameters()`-style mapping of names to
tensors (or arrays), each copied to float64 on the host; `watch` also takes
a module, whose named_parameters() it reads. makani_tpu's takes a JAX tree
and names a leaf by its path.
"""

import json
import logging
import os
import shutil
import time
import uuid

import numpy as np

try:
    import wandb as _real_wandb
except ImportError:
    _real_wandb = None


class Table:
    def __init__(self, data=None, columns=None):
        self.data = data or []
        self.columns = columns or []

    def to_json(self):
        return {"_type": "table", "columns": self.columns, "data": self.data}


class _Run:
    def __init__(self, dir, name, id):
        self.dir = dir
        self.name = name
        self.id = id


class Artifact:
    """Files and directories to keep with the run (the wandb.Artifact
    surface); the file backend copies them at log time."""

    def __init__(self, name, type="dataset", description=None, metadata=None):
        self.name = name
        self.type = type
        self.description = description
        self.metadata = metadata or {}
        self._entries = []

    def add_file(self, local_path, name=None):
        self._entries.append(("file", local_path, name or os.path.basename(local_path)))

    def add_dir(self, local_path, name=None):
        self._entries.append(("dir", local_path, name or os.path.basename(local_path)))


def _host_float64(leaf):
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().double().numpy()
    return np.asarray(leaf, dtype=np.float64)


def tree_histograms(params, bins=64, prefix=""):
    """Summary statistics and a histogram of each tensor of a
    named_parameters()-style mapping (a single tensor is named "leaf")."""
    items = params.items() if hasattr(params, "items") else [("leaf", params)]
    out = {}
    for name, leaf in items:
        a = _host_float64(leaf).ravel()
        if a.size == 0:
            continue
        counts, edges = np.histogram(a, bins=bins)
        out[f"{prefix}{name}"] = {
            "_type": "histogram",
            "min": float(a.min()), "max": float(a.max()),
            "mean": float(a.mean()), "std": float(a.std()),
            "l2": float(np.sqrt((a * a).sum())),
            "counts": counts.tolist(),
            "edges": [float(edges[0]), float(edges[-1])],
        }
    return out


class JsonlRun:
    """makani_tpu's file backend: init / log / watch / log_artifact / login /
    finish."""

    def __init__(self):
        self.run = None
        self._fh = None
        self._step = 0

    def init(self, dir=".", config=None, name=None, group=None, project=None,
             entity=None, resume=False, id=None, **kwargs):
        os.makedirs(dir, exist_ok=True)
        run_id_path = os.path.join(dir, "wandb_run_id.txt")
        if resume and os.path.exists(run_id_path):
            with open(run_id_path) as f:
                run_id = f.read().strip()
        else:
            run_id = id or uuid.uuid4().hex[:8]
            with open(run_id_path, "w") as f:
                f.write(run_id)
        self.run = _Run(dir, name or run_id, run_id)
        self._fh = open(os.path.join(dir, "wandb_log.jsonl"), "a" if resume else "w")
        header = {"event": "init", "time": time.time(), "name": name,
                  "group": group, "project": project, "run_id": run_id}
        if config is not None:
            items = config.to_dict() if hasattr(config, "to_dict") else config
            header["config"] = {k: str(v) for k, v in dict(items).items()}
        self._fh.write(json.dumps(header) + "\n")
        self._fh.flush()
        return self.run

    def log(self, data, step=None, **kwargs):
        if self._fh is None:
            return
        payload = {}
        for k, v in data.items():
            if isinstance(v, Table):
                payload[k] = v.to_json()
            elif hasattr(v, "item"):
                payload[k] = float(v)
            else:
                try:
                    json.dumps(v)
                    payload[k] = v
                except TypeError:
                    payload[k] = str(v)
        self._fh.write(json.dumps({"event": "log",
                                   "step": step if step is not None else self._step,
                                   "time": time.time(), "data": payload}) + "\n")
        self._fh.flush()
        self._step += 1

    def watch(self, models=None, log="gradients", log_freq=100, **kwargs):
        """Logs one snapshot of parameter histograms of `models` (a module or
        a named_parameters()-style mapping) now: without wandb's hooks there
        is no periodic tracking, so call it again for another snapshot."""
        if log == "gradients" or ("log_freq" in kwargs or log_freq != 100):
            logging.getLogger(__name__).warning(
                "wandb fallback watch(): periodic %r tracking (log_freq=%s) is "
                "not supported without module hooks; logging a one-shot "
                "parameter-histogram snapshot instead — re-call watch() on "
                "your own cadence for periodic snapshots", log, log_freq)
        if models is not None:
            if hasattr(models, "named_parameters"):
                models = dict(models.named_parameters())
            self.log({"watch": tree_histograms(models, prefix="param/")})

    def log_artifact(self, artifact, **kwargs):
        if self.run is None or not isinstance(artifact, Artifact):
            return
        dest = os.path.join(self.run.dir, "artifacts", artifact.name)
        os.makedirs(dest, exist_ok=True)
        manifest = []
        for kind, src, name in artifact._entries:
            target = os.path.join(dest, name)
            try:
                if kind == "dir":
                    shutil.copytree(src, target, dirs_exist_ok=True)
                else:
                    shutil.copy2(src, target)
                manifest.append(name)
            except OSError:
                pass
        self.log({"artifact": {"_type": "artifact", "name": artifact.name,
                               "artifact_type": artifact.type,
                               "metadata": artifact.metadata,
                               "files": manifest}})

    def login(self, *args, **kwargs):
        pass

    def finish(self):
        if self._fh is not None:
            self._fh.write(json.dumps({"event": "finish", "time": time.time()}) + "\n")
            self._fh.close()
            self._fh = None


def experiment_log():
    """The Trainer's log: the wandb module where it imports, else a new
    JsonlRun."""
    return _real_wandb if _real_wandb is not None else JsonlRun()


if _real_wandb is not None:
    init = _real_wandb.init
    log = _real_wandb.log
    watch = _real_wandb.watch
    login = _real_wandb.login
    finish = _real_wandb.finish
    log_artifact = _real_wandb.log_artifact
    Table = _real_wandb.Table  # noqa: F811
    Artifact = _real_wandb.Artifact  # noqa: F811
else:
    _backend = JsonlRun()
    init = _backend.init
    log = _backend.log
    watch = _backend.watch
    login = _backend.login
    finish = _backend.finish
    log_artifact = _backend.log_artifact
