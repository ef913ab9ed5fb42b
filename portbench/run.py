"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Prints the profiler's summary (traced runs) and the compared numbers
beside their limits on standard error, and one JSON line as the last line
of standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, ``window`` (what the window
held: steps, epoch ends, calls, events) and last ``checks``. Exits
with an error and prints no result without enough CUDA devices, or when
the process has loaded JAX or the JAX package by the end.

Every file a run writes goes under a directory of its own in ``TMPDIR``,
removed at the end; the kernel builds stay in the checkout's ``build/``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import core  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: Path = core.ROOT, device: str = "cuda",
         t_process: float = T_PROCESS) -> dict:
    """One run; returns the result line. ``device`` "cpu" skips the look for
    a card: the tests drive the rest of a run that way at a small size."""
    args = parse(argv)
    cell = core.load_cell(args.workload, root)
    chips = int(cell.workload.get("chips", 1))
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"{cell.name} needs {chips} CUDA device(s); "
                             f"found {torch.cuda.device_count()}")
        kind = torch.cuda.get_device_name(0)
        device = "cuda:0"
    else:
        kind = "cpu"
    tmp = Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))
    core.environment(tmp, CHECKOUT)
    ctx = core.RunContext(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device, tmp=tmp, t_process=t_process)
    ctx.layer["peaks"] = core.peaks(kind, root) if device != "cpu" else None
    try:
        core.entry_module(cell).run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = core.forbidden_loaded()
    if bad:
        raise SystemExit(f"the run loaded {', '.join(bad)}")
    line = core.result_line(ctx, kind, chips)
    for name, c in ctx.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return line


if __name__ == "__main__":
    result = main()
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
