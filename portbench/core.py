"""What every cell shares: finding a cell, its configuration and its metrics by
name, the run's environment, the device checks and the result line.

Layout, all found by name:

* ``workloads/<cell>.json``: the cell's configuration, its entry (a module
  ``entries/<entry>.py``), its traffic, its run parameters and the limits of
  its correctness numbers;
* ``configs/<config>.json``: the configuration as the program reads it, with
  its ``source``, ``reduced`` and ``assumed`` notes and the name of its plain
  reference (``reference/<reference>.py``);
* ``metrics/<metric>.py``: one reader for each per-layer metric;
* ``BENCHMARK.json`` (the checkout's root): which metrics each cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
# top-level module names that must not be loaded in a run's process: the JAX
# package the port was made from, and JAX itself
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "optax", "p2igan_tpu"})
PEAKS_FILE = "peaks.json"


@dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]          # the program's configuration (no notes)
    config_meta: Dict[str, Any]     # source, reduced, assumed, reference
    root: Path

    @property
    def entry(self) -> str:
        return self.workload["entry"]


def load_json(path: Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    path = root / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no workload file {path}")
    workload = load_json(path)
    raw = load_json(root / "configs" / f"{workload['config']}.json")
    meta = {k: raw[k] for k in ("source", "reduced", "assumed", "reference") if k in raw}
    config = {k: v for k, v in raw.items() if k not in meta}
    return Cell(name, workload, config, meta, root)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(cell: Cell) -> ModuleType:
    import importlib

    return importlib.import_module(f"portbench.reference.{cell.config_meta['reference']}")


def entry_module(cell: Cell) -> ModuleType:
    return load_module(cell.root / "entries" / f"{cell.entry}.py", f"portbench_entry_{cell.entry}")


def benchmark_spec(root: Path = ROOT) -> Dict[str, Any]:
    """``BENCHMARK.json`` of the checkout (the directory above the harness)."""
    return load_json(root.parent / "BENCHMARK.json")


def metrics_for(cell: str, produced: Dict[str, Any], spec: Dict[str, Any]):
    """(end-to-end entries, per-layer entries) that ``cell`` reports: an
    end-to-end metric the entry produced and ``BENCHMARK.json`` gives this
    cell; a per-layer metric whose ``workloads`` list the cell."""
    e2e = [m for m in spec["end_to_end"] if m["name"] in produced
           and cell in m.get("workloads", [cell])]
    layer = [m for m in spec["per_layer"] if cell in m["workloads"]]
    return e2e, layer


def peaks(kind: str, root: Path = ROOT) -> Dict[str, float]:
    """The published float32 peaks of the card named ``kind``."""
    table = load_json(root / PEAKS_FILE)
    for entry in table["cards"]:
        if entry["match"] in kind:
            return entry
    raise SystemExit(f"no peaks for a card named {kind!r} in {PEAKS_FILE}")


@dataclass
class RunContext:
    """What an entry needs and what it hands back."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    tmp: Path
    t_process: float
    produced: Dict[str, float] = field(default_factory=dict)   # end-to-end values
    layer: Dict[str, Any] = field(default_factory=dict)       # inputs of the readers
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)
    window: Dict[str, Any] = field(default_factory=dict)       # what the window held
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace_summary: Optional[Dict[str, Any]] = None


def phase(ctx: RunContext, what: str, at: Optional[float] = None) -> None:
    """Log a set-up milestone's seconds since the process started."""
    t = time.perf_counter() if at is None else at
    print(f"setup: {t - ctx.t_process:.3f} s {what}", file=sys.stderr, flush=True)


def check(ctx: RunContext, name: str, value: float) -> None:
    """Record a compared number beside its limit from the workload file."""
    limit = ctx.cell.workload["limits"][name]
    ctx.checks[name] = {"value": float(value), "limit": float(limit)}


def all_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                for c in checks.values())


def environment(tmp: Path, checkout: Path) -> None:
    """Caches at fixed paths inside the checkout (the port builds its own
    kernels into ``build/p2igan_tpu_torch/``; these catch any PyTorch
    extension or Triton cache a later change brings); what a run writes
    under its own temporary directory. Set before the program is imported."""
    build = checkout / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["P2IGAN_TRACKING_DIR"] = str(tmp / "tracking")
    os.environ["P2IGAN_FORCE_FILE_TRACKER"] = "1"
    os.environ["MPLCONFIGDIR"] = str(tmp / "matplotlib")


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN_MODULES)


def result_line(ctx: RunContext, kind: str, count: int) -> Dict[str, Any]:
    spec = benchmark_spec(ctx.cell.root)
    e2e, layer = metrics_for(ctx.cell.name, ctx.produced, spec)
    metrics: Dict[str, Dict[str, Any]] = {}
    if ctx.trace:
        for m in layer:
            reader = load_module(ctx.cell.root / "metrics" / f"{m['name']}.py",
                                 f"portbench_metric_{m['name'].replace('.', '_')}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": float(ctx.produced[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.startswith("cuda") else "cpu", "kind": kind,
              "count": count, "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    line: Dict[str, Any] = {"correct": all_correct(ctx.checks) and ctx.failed == 0,
                            "attempted": int(ctx.attempted), "failed": int(ctx.failed),
                            "metrics": metrics, "device": device}
    if ctx.trace and ctx.trace_summary is not None:
        device["busy_s"] = ctx.trace_summary["busy_s"]
        device["window_s"] = ctx.trace_summary["window_s"]
        line["breakdown"] = ctx.trace_summary["breakdown"]
    line["window"] = ctx.window
    line["checks"] = ctx.checks
    return line

