"""The PyTorch port must run where jax, flax, optax, msgpack, matplotlib, h5py
and the JAX package ``p2igan_tpu`` are absent (it reads JAX checkpoints with
its own decoder): it imports none of them and loads no
file of ``p2igan_tpu/`` by path; its config JSONs are its own copies. Only
the named functions that open an ``.h5`` file import h5py, and only the named
functions that draw a figure of the offline suite import matplotlib."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "p2igan_tpu", "matplotlib",
           "h5py")
PORT_FILES = sorted([*(REPO / "p2igan_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py",
                     *(REPO / "scripts").glob("*_torch.py")])

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
blocked = ("jax", "jaxlib", "flax", "optax", "msgpack", "p2igan_tpu", "matplotlib",
           "h5py")
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
for script in ("scripts/infer_torch.py", "scripts/train_torch.py",
               "scripts/make_fake_data_torch.py", "scripts/convergence_smoke_torch.py",
               "scripts/quality_torch.py", "scripts/profile_infer_torch.py",
               "scripts/profile_train_torch.py", "scripts/roofline_train_torch.py",
               "scripts/sweep_torch.py", "scripts/tozarr_torch.py",
               "scripts/preprocess_torch.py", "scripts/visualize_torch.py", "chip_smoke.py"):
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
    assert n_modules >= 40, proc.stdout


@pytest.mark.parametrize("name", ["models/simple.py", "ops/enc0_conv.py",
                                  "ops/dec2_stencil.py", "ops/convs.py"])
def test_the_simple_family_is_among_the_scanned_files(name):
    assert REPO / "p2igan_tpu_torch" / name in PORT_FILES


@pytest.mark.parametrize("name", ["ops/idw.py", "ops/idw_factored_kernel.py",
                                  "ops/layers.py", "data/masks.py"])
def test_the_factored_idw_is_among_the_scanned_files(name):
    assert REPO / "p2igan_tpu_torch" / name in PORT_FILES


@pytest.mark.parametrize("name", ["metrics/metric.py", "metrics/plots.py",
                                  "metrics/viridis.py", "losses.py"])
def test_the_evaluation_path_is_among_the_scanned_files(name):
    assert REPO / "p2igan_tpu_torch" / name in PORT_FILES


@pytest.mark.parametrize("name", ["parallel/__init__.py", "parallel/mesh.py"])
def test_the_parallel_package_is_among_the_scanned_files(name):
    assert REPO / "p2igan_tpu_torch" / name in PORT_FILES


@pytest.mark.parametrize("name", ["utils/flax_msgpack.py", "utils/rng.py",
                                  "training/checkpoint.py", "models/convert.py"])
def test_the_jax_checkpoint_path_is_among_the_scanned_files(name):
    assert REPO / "p2igan_tpu_torch" / name in PORT_FILES


@pytest.mark.parametrize("name", ["make_fake_data_torch.py", "convergence_smoke_torch.py",
                                  "profile_infer_torch.py", "profile_train_torch.py",
                                  "roofline_train_torch.py", "sweep_torch.py",
                                  "tozarr_torch.py", "preprocess_torch.py",
                                  "visualize_torch.py"])
def test_the_new_scripts_are_among_the_scanned_files(name):
    assert REPO / "scripts" / name in PORT_FILES


@pytest.mark.parametrize("name", ["__init__.py", "config.py", "io.py", "exp1.py", "exp2.py",
                                  "exp3.py", "main.py", "test.py", "compare.py"])
def test_the_offline_suite_is_among_the_scanned_files(name):
    assert REPO / "p2igan_tpu_torch" / "experiments" / name in PORT_FILES


def test_the_quality_script_is_among_the_scanned_files():
    assert REPO / "scripts" / "quality_torch.py" in PORT_FILES


# The two readers and writers of ``.h5`` event files, and the readers of the
# two converter scripts, import h5py inside the function that opens such a
# file (the format needs it, and nothing else does); the offline suite's
# functions that draw a figure, and nothing else,
# import matplotlib inside them (a GPU machine may lack it: those stages then
# raise). Everywhere else, and at any module's top level, both are blocked.
FORMAT_IMPORTS = {("data/stores.py", "_read_hdf5"): "h5py",
                  ("data/fake.py", "write_h5_events"): "h5py",
                  ("scripts/tozarr_torch.py", "read_h5_frames"): "h5py",
                  ("scripts/preprocess_torch.py", "read_h5_frames"): "h5py",
                  ("experiments/exp2.py", "build_paper_cmap"): "matplotlib",
                  ("experiments/exp2.py", "save_combo_gif"): "matplotlib",
                  ("experiments/exp2.py", "_paper_figure"): "matplotlib",
                  ("experiments/exp3.py", "scatter_panels"): "matplotlib",
                  ("experiments/exp3.py", "logfreq_plot"): "matplotlib",
                  ("experiments/exp3.py", "nse_boxplot"): "matplotlib",
                  ("experiments/test.py", "plot_hist"): "matplotlib"}


def _rel(path: Path) -> str:
    """A file's key in ``FORMAT_IMPORTS``: relative to the package, or
    ``scripts/<name>`` for a script."""
    try:
        return path.relative_to(REPO / "p2igan_tpu_torch").as_posix()
    except ValueError:
        return path.relative_to(REPO).as_posix()


def _path(rel: str) -> Path:
    return REPO / rel if rel.startswith("scripts/") else REPO / "p2igan_tpu_torch" / rel


def _format_import_ok(path: Path, func, name: str) -> bool:
    try:
        rel = _rel(path)
    except ValueError:
        return False
    return func is not None and FORMAT_IMPORTS.get((rel, func)) == name.split(".")[0]


def _violations(path: Path):
    """Imports of a blocked package, and string constants that name a ``.py``
    file under ``p2igan_tpu/`` or build such a path (``"p2igan_tpu"`` as a
    path component), outside docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    owner = {}  # import node -> the name of the function whose body holds it
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for child in ast.walk(node):
                owner.setdefault(id(child), node.name)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
                docstrings.add(id(body[0].value))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            names = []
        for name in names:
            if name.split(".")[0] in BLOCKED and not _format_import_ok(
                    path, owner.get(id(node)), name):
                found.append(f"{path.name}:{node.lineno} imports {name}")
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            text = node.value
            if text == "p2igan_tpu" or (text.startswith("p2igan_tpu/")
                                        and text.endswith(".py")
                                        and "/ops/pallas/" not in text):
                found.append(f"{path.name}:{node.lineno} names {text!r}")
    return found


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_and_loads_nothing_of_the_jax_package(path):
    """``replaces`` entries of chip_smoke.py name a TPU kernel's file:line
    under ``p2igan_tpu/ops/pallas/``; they are labels, never opened."""
    assert _violations(path) == []


def test_the_scan_finds_what_it_should(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text('"""p2igan_tpu/config.py in a docstring is fine."""\n'
                   "import os\nfrom p2igan_tpu.config import load_config\n"
                   "import flax.linen as nn\n"
                   "P = os.path.join('x', 'p2igan_tpu', 'utils')\n"
                   "Q = 'p2igan_tpu/utils/tracking.py'\n")
    got = _violations(bad)
    assert len(got) == 4, got
    plots = tmp_path / "plots.py"
    plots.write_text("def colorize():\n    import matplotlib\n"
                     "import h5py\n"
                     "def _read_hdf5(path):\n    import h5py\n")
    got = _violations(plots)
    assert len(got) == 3, got  # _read_hdf5 here is not data/stores.py's


def _functions_importing(rel: str, package: str) -> list:
    tree = ast.parse(_path(rel).read_text())
    names = lambda n: ([a.name for a in n.names] if isinstance(n, ast.Import)  # noqa: E731
                       else [n.module or ""] if isinstance(n, ast.ImportFrom) else [])
    return [f.name for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
            and any(m.split(".")[0] == package for n in ast.walk(f) for m in names(n))]


def test_the_scan_lets_only_the_h5_readers_import_h5py():
    found = {rel: _functions_importing(rel, "h5py")
             for (rel, _), name in FORMAT_IMPORTS.items() if name == "h5py"}
    assert found == {"data/stores.py": ["_read_hdf5"], "data/fake.py": ["write_h5_events"],
                     "scripts/tozarr_torch.py": ["read_h5_frames"],
                     "scripts/preprocess_torch.py": ["read_h5_frames"]}


def test_the_scan_lets_only_the_figure_functions_import_matplotlib():
    found = {rel: sorted(_functions_importing(rel, "matplotlib"))
             for rel in ("experiments/exp2.py", "experiments/exp3.py", "experiments/test.py")}
    assert found == {
        "experiments/exp2.py": ["_paper_figure", "build_paper_cmap", "save_combo_gif"],
        "experiments/exp3.py": ["logfreq_plot", "nse_boxplot", "scatter_panels"],
        "experiments/test.py": ["plot_hist"]}
    assert found == {rel: sorted(f for (r, f), name in FORMAT_IMPORTS.items()
                                 if r == rel and name == "matplotlib") for rel in found}


CONFIG_DIR = REPO / "p2igan_tpu_torch" / "config"


@pytest.mark.parametrize("name", sorted(p.name for p in CONFIG_DIR.glob("*.json")))
def test_port_config_equals_its_original(name):
    """The port ships its own copies of the configs it runs; they must not
    drift from the JAX package's."""
    ours = json.loads((CONFIG_DIR / name).read_text())
    theirs = json.loads((REPO / "p2igan_tpu" / "config" / name).read_text())
    assert ours == theirs


def test_port_ships_the_configs_it_runs():
    names = {p.name for p in CONFIG_DIR.glob("*.json")}
    assert {"p2igan_baseline_eval.json", "p2igan_gan_baseline_gauge.json",
            "dk_gauge.json", "stdk_gauge.json"} <= names
