"""``BENCHMARK.json`` and the files of one cell, found by name.

The harness holds no table of cells, configurations, traffic mixes,
generators, kernels, wrappers or metrics: a cell names its configuration
and its traffic, they name their generators, members, wrapper and kernels,
and each is a file (or a class of the port) whose path follows from its
name. A later cell adds files and entries and edits none.
"""
import importlib.util
import json
import pathlib
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    root: pathlib.Path
    bench_dir: pathlib.Path
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, Callable[[Dict[str, Any]], Optional[float]]] = field(default_factory=dict)

    @property
    def config_name(self) -> str:
        return self.config["name"]

    @property
    def traffic_name(self) -> str:
        return self.traffic["name"]

    def reference(self) -> Any:
        """The plain reference: the cell's own, ``reference/<workload>.py``,
        where there is one, else the configuration's,
        ``reference/<config>.py``."""
        for name in (self.name, self.config_name):
            path = self.bench_dir / "reference" / f"{name}.py"
            if path.exists():
                return load_module(path, "bench_reference_" + name.replace(".", "_"))
        raise FileNotFoundError(f"no reference/{self.name}.py or reference/{self.config_name}.py")


def load_module(path: pathlib.Path, name: str) -> Any:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_benchmark(root: pathlib.Path) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _cells_metrics(metrics: List[Dict[str, Any]], workload: str) -> List[Dict[str, Any]]:
    return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]


def load_cell(workload: str, root: pathlib.Path, bench_dir: Optional[pathlib.Path] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``: its configuration
    (the file the entry names), its traffic (``traffic/<traffic>.json``), its
    limits (``limits/<workload>.json``), and the reader of each of its
    metrics (``metrics/<metric>.py``: ``read(record)``, a number or None)."""
    bench_dir = bench_dir or BENCH_DIR
    doc = load_benchmark(root)
    cells = {w["name"]: w for w in doc["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in doc["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    if config.get("name") != entry["config"]:
        raise ValueError(f"{configs[entry['config']]['file']} names {config.get('name')!r}, not {entry['config']!r}")
    traffic = json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())
    if traffic.get("name") != entry["traffic"]:
        raise ValueError(f"traffic/{entry['traffic']}.json names {traffic.get('name')!r}")
    limits = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())["limits"]
    per_layer = _cells_metrics(doc["per_layer"], workload)
    end_to_end = _cells_metrics(doc["end_to_end"], workload)
    readers = {}
    for metric in end_to_end + per_layer:
        module = load_module(bench_dir / "metrics" / f"{metric['name']}.py", "bench_metric_" + metric["name"].replace(".", "_"))
        readers[metric["name"]] = module.read
    return Cell(
        name=workload, root=root, bench_dir=bench_dir, chips=int(entry["chips"]), config=config, traffic=traffic,
        limits={k: float(v) for k, v in limits.items()}, end_to_end=end_to_end,
        per_layer=per_layer, readers=readers,
    )


def problems(doc: Dict[str, Any]) -> List[str]:
    """What in ``doc`` (a parsed ``BENCHMARK.json``) breaks the naming rules:
    names, units, sources, ``better`` and the one-line texts."""
    found = []

    def name(value: Any, what: str) -> None:
        if not isinstance(value, str) or not NAME_RE.match(value):
            found.append(f"{what}: {value!r} is not a name")

    def line(value: Any, what: str) -> None:
        if not isinstance(value, str) or not 1 <= len(value) <= 200 or "\n" in value or "\t" in value:
            found.append(f"{what}: {value!r} is not one line of 1-200 characters")

    for c in doc.get("configs", []):
        name(c.get("name"), "config")
        line(c.get("source"), f"config {c.get('name')} source")
        for key in c.get("reduced", []):
            name(key, f"config {c.get('name')} reduced")
    for w in doc.get("workloads", []):
        for key in ("name", "config", "traffic"):
            name(w.get(key), f"workload {key}")
        line(w.get("why"), f"workload {w.get('name')} why")
        if w.get("chips") not in (1, 4):
            found.append(f"workload {w.get('name')}: chips {w.get('chips')!r}")
    for kind in ("end_to_end", "per_layer"):
        for m in doc.get(kind, []):
            name(m.get("name"), kind)
            if not isinstance(m.get("unit"), str) or not UNIT_RE.match(m["unit"]):
                found.append(f"{m.get('name')}: unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                found.append(f"{m.get('name')}: better {m.get('better')!r}")
            if m.get("source") not in SOURCES:
                found.append(f"{m.get('name')}: source {m.get('source')!r}")
            if kind == "per_layer":
                line(m.get("layer"), f"{m.get('name')} layer")
    for word in doc.get("command", []):
        line(word, "command")
    for path in doc.get("paths", []):
        if not re.match(r"^[A-Za-z0-9_./\-]{1,200}$", path) or path.startswith("/") or ".." in path.split("/"):
            found.append(f"path {path!r}")
    return found
