"""Finding a cell's parts by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each
configuration, traffic mix, comparison limit and metric reader is a file
of its own under this directory.  The functions take the directory to
look in, so a part added in another directory is found the same way.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict | None  # None until readings have set them


def load_benchmark(root: Path = REPO) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_json(base: Path, kind: str, name: str) -> dict:
    """``<base>/<kind>/<name>.json``."""
    return json.loads((Path(base) / kind / f"{name}.json").read_text())


def load_cell(bench: dict, name: str, root: Path = REPO, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench``: its configuration from the file
    ``BENCHMARK.json`` gives it (relative to ``root``), its traffic mix
    from ``<base>/traffic/`` and its limits from ``<base>/limits/``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((Path(root) / configs[w["config"]]["file"]).read_text())
    limits_file = Path(base) / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else None
    return Cell(
        name=name,
        config_name=w["config"],
        traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=config,
        traffic=load_json(base, "traffic", w["traffic"]),
        limits=limits,
    )


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with a ``workloads`` list only in
    the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def metric_reader(name: str, base: Path = HERE) -> ModuleType:
    """The reader ``<base>/metrics/<name>.py``: a module with ``read(rec)``
    returning the metric's value, or None where the run holds nothing for
    it to read."""
    path = Path(base) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def program(resizer: str) -> ModuleType:
    """``programs/<resizer>.py``: builds the port's device function."""
    return importlib.import_module(f"portbench.programs.{resizer}")


def reference(resizer: str) -> ModuleType:
    """``reference/<resizer>.py``: the plain float64 reference."""
    return importlib.import_module(f"portbench.reference.{resizer}")
