"""Everything the benchmark runs is found by name from BENCHMARK.json: a cell
names its configuration and its traffic mix; a configuration is
`configs/<name>.json` (the program's parameters as run, and the reference
module that models it); a traffic mix is `traffic/<name>.json`, read by the
general generator (harness/traffic.py); the limits of a cell's output
check are `checks/<cell>.json`; a per-layer metric's reader is the first of
`metrics/<name>.py`, `metrics/<stem>.py` (the name before its first dot)
and `metrics/<family>.py` (the stem's last `_` part, as `roofline` for
`legmm_roofline.train`)."""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def load_json(path):
    return json.loads(Path(path).read_text())


class Spec:
    """BENCHMARK.json and the files its names lead to."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        self.configs = {c["name"]: c for c in self.bench["configs"]}
        self.cells = {w["name"]: w for w in self.bench["workloads"]}

    def cell(self, name):
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(self.cells)}")
        return self.cells[name]

    def config(self, name):
        """The configuration file of config `name`: params, reference, ..."""
        entry = self.configs[name]
        return load_json(self.root / entry["file"])

    def traffic(self, name):
        return load_json(HERE / "traffic" / f"{name}.json")

    def limits(self, cell):
        return load_json(HERE / "checks" / f"{cell}.json")

    def _reports(self, metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell):
        return [m for m in self.bench["end_to_end"] if self._reports(m, cell)]

    def per_layer(self, cell):
        """The per-layer metrics of `cell`: those that list it, and those
        without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def reader_path(name):
    stem = name.split(".")[0]
    for candidate in (name, stem, stem.rsplit("_", 1)[-1]):
        path = HERE / "metrics" / f"{candidate}.py"
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} under {HERE / 'metrics'}")


def load_reader(name):
    """The `read(ctx, name)` of metric `name`'s reader."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_reference(name):
    """The reference module `benchmark.reference.<name>`."""
    return importlib.import_module(f"benchmark.reference.{name}")
