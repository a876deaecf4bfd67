"""Experiment log in JSON lines (counterpart of makani_tpu/utils/wandb_compat.py).

makani_tpu logs epochs, metrics and the rollouts table to Weights & Biases
where the wandb package is importable, else to JSON lines in the run's
directory with the same call surface. wandb is not installed where the port
runs, so the port keeps the JSON-lines backend only: `JsonlRun` writes
wandb_run_id.txt and wandb_log.jsonl as makani_tpu's file backend does, a
`Table` as {"_type": "table", "columns": ..., "data": ...}. The Trainer
creates one where the config sets `log_to_wandb`, as makani_tpu gates it.
makani_tpu's `watch` (parameter histograms of a JAX tree) and artifacts are
not ported.
"""

import json
import os
import time
import uuid


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


class JsonlRun:
    """init / log / finish of makani_tpu's file backend."""

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

    def finish(self):
        if self._fh is not None:
            self._fh.write(json.dumps({"event": "finish", "time": time.time()}) + "\n")
            self._fh.close()
            self._fh = None
