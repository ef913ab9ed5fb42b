"""Experiment tracking: ``p2igan_tpu/utils/tracking.py``, reused as it is.

That module is jax-free (mlflow when importable, else a file tracker under
``$P2IGAN_TRACKING_DIR``, default ``mlruns-lite``), but its package's
``__init__`` imports jax, so it is loaded here from its file.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_NAME = "p2igan_tpu_torch.utils._tracking_impl"
_PATH = Path(__file__).resolve().parents[2] / "p2igan_tpu" / "utils" / "tracking.py"

_impl = sys.modules.get(_NAME)
if _impl is None:
    _spec = importlib.util.spec_from_file_location(_NAME, _PATH)
    _impl = importlib.util.module_from_spec(_spec)
    sys.modules[_NAME] = _impl
    _spec.loader.exec_module(_impl)

FileTracker = _impl.FileTracker
get_tracker = _impl.get_tracker
setup_logging = _impl.setup_logging

__all__ = ["FileTracker", "get_tracker", "setup_logging"]
