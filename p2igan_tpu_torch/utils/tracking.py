"""MLflow-compatible experiment tracking.

The reference logs params/metrics/artifacts to MLflow (reference
``scripts/train.py:185-220,343-359``). This module exposes the same surface
(``set_experiment``, ``start_run``, ``log_params``, ``log_metric``,
``log_artifact``) and routes to the real ``mlflow`` package when importable,
otherwise to a file-based tracker writing
``<root>/<experiment>/<run>/{params.json, metrics.jsonl, artifacts/}`` so runs
remain inspectable and diffable without any external service.

The port's own copy of ``p2igan_tpu/utils/tracking.py``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

try:  # pragma: no cover - environment dependent
    import mlflow as _mlflow  # type: ignore
except Exception:  # pragma: no cover
    _mlflow = None


class FileTracker:
    """Minimal file-based drop-in for the mlflow module-level API."""

    def __init__(self, root: str | Path = "mlruns-lite"):
        self.root = Path(root)
        self.experiment = "default"
        self.run_dir: Optional[Path] = None
        self._metrics_f = None

    # -- mlflow-compatible surface ------------------------------------
    def set_tracking_uri(self, uri: str) -> None:
        uri = str(uri)
        if uri.startswith("file:"):
            uri = uri[len("file:"):]
        self.root = Path(uri)

    def set_experiment(self, name: str) -> None:
        self.experiment = name

    def start_run(self, run_name: Optional[str] = None):
        run_name = run_name or f"run-{uuid.uuid4().hex[:8]}"
        # mlflow creates a NEW run per start_run even under a repeated
        # run_name; mirror that by suffixing instead of appending a second
        # run's metrics into the first one's metrics.jsonl
        run_dir = self.root / self.experiment / run_name
        n = 1
        while run_dir.exists():
            n += 1
            run_dir = self.root / self.experiment / f"{run_name}-{n}"
        self.run_dir = run_dir
        (self.run_dir / "artifacts").mkdir(parents=True, exist_ok=True)
        run_id = uuid.uuid4().hex
        (self.run_dir / "meta.json").write_text(
            json.dumps({"run_name": run_name, "run_id": run_id,
                        "start_time": time.time()})
        )
        if self._metrics_f is not None:
            self.end_run()  # mlflow errors on nested runs; we roll over
        self._metrics_f = (self.run_dir / "metrics.jsonl").open("a")
        tracker = self

        class _Info:
            def __init__(self_inner):
                self_inner.run_id = run_id
                self_inner.run_name = run_name
                self_inner.artifact_uri = str(run_dir / "artifacts")

        class _Ctx:
            # mlflow ActiveRun-shaped handle: usable both as a context
            # manager and directly (`run.info.run_id`)
            info = _Info()

            def __enter__(self_inner):
                return self_inner

            def __exit__(self_inner, *exc):
                tracker.end_run()
                return False

        return _Ctx()

    def end_run(self) -> None:
        if self._metrics_f is not None:
            self._metrics_f.close()
            self._metrics_f = None

    def log_params(self, params: Dict[str, Any]) -> None:
        if self.run_dir is None:
            return
        path = self.run_dir / "params.json"
        existing = json.loads(path.read_text()) if path.exists() else {}
        existing.update({k: _jsonable(v) for k, v in params.items()})
        path.write_text(json.dumps(existing, indent=2, sort_keys=True))

    def log_param(self, key: str, value: Any) -> None:
        self.log_params({key: value})

    def log_metric(self, key: str, value: float, step: Optional[int] = None) -> None:
        if self._metrics_f is None:
            return
        value = float(value)
        rec = {"key": key, "value": value, "step": step, "t": time.time()}
        if value != value or value in (float("inf"), float("-inf")):
            # strict-JSON lines: a bare NaN/Infinity token would make the
            # whole metrics file unparseable to non-Python tooling exactly
            # when a diverging run needs debugging. Keep ``value``
            # single-typed (null) and carry the token in ``raw`` (ADVICE r2:
            # a string value changed the field's type mid-file).
            rec["value"], rec["raw"] = None, repr(value)
        self._metrics_f.write(json.dumps(rec) + "\n")
        self._metrics_f.flush()

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        for k, v in metrics.items():
            self.log_metric(k, v, step=step)

    def log_artifact(self, local_path: str) -> None:
        if self.run_dir is None:
            return
        src = Path(local_path)
        if src.exists():
            shutil.copy2(src, self.run_dir / "artifacts" / src.name)


class NullTracker:
    """The tracker of a data-parallel rank other than 0: it records nothing
    (rank 0 logs the global values)."""

    run_dir: Optional[Path] = None

    def set_tracking_uri(self, uri: str) -> None:
        pass

    def set_experiment(self, name: str) -> None:
        pass

    def start_run(self, run_name: Optional[str] = None):
        return contextlib.nullcontext()

    def log_params(self, params: Dict[str, Any]) -> None:
        pass

    def log_metric(self, key: str, value: float, step: Optional[int] = None) -> None:
        pass

    def log_artifact(self, local_path: str) -> None:
        pass


_FILE_TRACKER = FileTracker(os.environ.get("P2IGAN_TRACKING_DIR", "mlruns-lite"))


def get_tracker():
    """Return the active tracker: real mlflow when available, else files."""
    if _mlflow is not None and os.environ.get("P2IGAN_FORCE_FILE_TRACKER") != "1":
        return _mlflow
    return _FILE_TRACKER


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


def setup_logging(level: str = "INFO") -> None:
    """Uniform log format (reference train.py:512-515 / infer.py:119-122)."""
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s | %(levelname)s | %(message)s",
        force=True,
    )
