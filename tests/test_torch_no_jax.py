"""The PyTorch port must run where jax, flax and optax are not installed."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
blocked = ("jax", "jaxlib", "flax", "optax")
for name in list(sys.modules):
    if name.split(".")[0] in blocked:
        del sys.modules[name]
for name in blocked:
    sys.modules[name] = None  # any import of them now raises ImportError
import p2igan_tpu_torch
mods = [info.name for info in pkgutil.walk_packages(p2igan_tpu_torch.__path__,
                                                    "p2igan_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
for script in ("scripts/infer_torch.py", "scripts/train_torch.py", "chip_smoke.py"):
    spec = importlib.util.spec_from_file_location("probe_" + script.split("/")[-1][:-3],
                                                  script)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted({m.split(".")[0] for m, v in sys.modules.items() if v is not None}
                & set(blocked))
print("MODULES", len(mods), "LOADED", loaded)
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    n_modules = int(proc.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= 23, proc.stdout
