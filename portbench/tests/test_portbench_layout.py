"""The harness finds each cell, configuration and metric by name, and a new
cell needs new files only."""

from __future__ import annotations

import json
import re

import pytest

from conftest import CHECKOUT, HARNESS, run_tiny
from portbench import core

SPEC = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    c = core.load_cell(cell)
    row = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert c.workload["config"] == row["config"]
    assert c.workload["why"] == row["why"]
    assert c.workload.get("chips", 1) == row["chips"] == 1
    assert (HARNESS / "entries" / f"{c.entry}.py").exists()
    assert c.config_meta["reference"] in ("p2igan", "dk")
    assert set(c.workload["limits"]) >= {"max_gap"} if c.entry == "serve" else \
        set(c.workload["limits"]) == {"loss_gap", "grad_gap", "change_gap"}


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_every_config_file_matches_its_entry(config):
    row = next(c for c in SPEC["configs"] if c["name"] == config)
    raw = json.loads((CHECKOUT / row["file"]).read_text())
    assert raw["source"] == row["source"] and raw["reduced"] == row["reduced"]
    assert row["file"].startswith("portbench/configs/")
    assert any(w["config"] == config for w in SPEC["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    mod = core.load_module(HARNESS / "metrics" / f"{metric}.py", "reader")
    assert callable(mod.read)


def test_benchmark_file_keeps_its_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"][1] == "portbench/run.py"
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]] + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        e2e_here = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e_here) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in SPEC["per_layer"])


def test_a_new_cell_needs_only_new_files(tmp_path, tiny_root):
    """A cell, a configuration and a per-layer metric added as files (and
    entries in BENCHMARK.json) run with no file of the harness edited."""
    before = {p: p.read_bytes() for p in tiny_root.rglob("*") if p.is_file()}
    wl = json.loads((tiny_root / "workloads" / "tiny_dk_stis.train_b12.json").read_text())
    cfg = json.loads((tiny_root / "configs" / "tiny_dk_stis.json").read_text())
    cfg["train"]["batch_size"] = 2
    (tiny_root / "configs" / "tiny_dk_stis_b2.json").write_text(json.dumps(cfg))
    wl["config"] = "tiny_dk_stis_b2"
    wl["train"]["log_step"], wl["warmup_steps"] = 22, 44  # epochs of 22 steps of 2
    (tiny_root / "workloads" / "tiny_dk_stis.train_b2.json").write_text(json.dumps(wl))
    (tiny_root / "metrics" / "steps.train.py").write_text(
        "def read(ctx):\n    return ctx.layer.get('steps')\n")
    spec_path = tiny_root.parent / "BENCHMARK.json"
    spec_before = spec_path.read_text()
    spec = json.loads(spec_before)
    for m in spec["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("tiny_dk_stis.train_b2")
    spec["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "Orchestration",
                              "moves": "train_samples_per_s",
                              "workloads": ["tiny_dk_stis.train_b2"]})
    spec_path.write_text(json.dumps(spec))
    try:
        line = run_tiny(tiny_root, "tiny_dk_stis.train_b2")
        assert line["correct"] and set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
        traced = run_tiny(tiny_root, "tiny_dk_stis.train_b2", trace=1)
        assert traced["metrics"]["steps.train"]["value"] > 0
        for p, data in before.items():
            assert p.read_bytes() == data, p
    finally:
        spec_path.write_text(spec_before)
        for name in ("configs/tiny_dk_stis_b2.json", "workloads/tiny_dk_stis.train_b2.json",
                     "metrics/steps.train.py"):
            (tiny_root / name).unlink()
