"""The traced run's device trace: a ``torch.profiler`` segment opened and
closed by the entries' hooks, reduced to the device's busy time, the time of
each kernel, the longest idle gaps and what the host did in each.

Busy time is the union of the intervals of device kernels, copies and
memsets alone: the ranges that ``record_function`` draws on the device's
timeline are not device work and are left out. The family of a kernel
follows the port's classifier (``utils/profiling.py`` ``kernel_family``), a
frozen copy, so the yardstick does not move with the program.
"""

from __future__ import annotations

import re
import sys
import time
from bisect import bisect_right
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch

# the port's own kernels (``p2igan_tpu_torch/csrc``), by ``__global__`` name
OWN_KERNELS = ("gauge_topk_kernel", "combine_table_multi_kernel",
               "combine_table_multi_bwd_kernel", "pool_dup_kernel", "combine_table_kernel",
               "combine_table_bwd_kernel", "combine_dense_kernel", "cell_init_kernel",
               "cell_count_kernel", "cell_scan_kernel", "cell_scatter_kernel",
               "cell_decode_kernel", "knn_cells_kernel", "idw_scatter_kernel",
               "row_absmax_kernel", "fixed_finish_kernel", "decode1_kernel", "decode4_kernel",
               "dk_mlp_tail_kernel", "dk_mlp_tail_bwd_kernel", "sum_block_partials_kernel",
               "enc0_kernel", "dec2_kernel")
_OWN_RE = re.compile(r"(?:^|[\s:*&])(" + "|".join(sorted(OWN_KERNELS, key=len, reverse=True))
                     + r")\s*[<(]|^(" + "|".join(OWN_KERNELS) + r")$")
ANNOTATION_PREFIXES = ("portbench::", "module::", "Optimizer.step#", "ProfilerStep")


def kernel_family(name: str) -> str:
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "copies, memcpy/memset"
    if _OWN_RE.search(name):
        return "ours"
    if any(s in low for s in ("nchwtonhwc", "nhwctonchw", "transpose", "copy")):
        return "copies, memcpy/memset"
    if "dgrad" in low:
        return "cuDNN conv data gradient"
    if "wgrad" in low:
        return "cuDNN conv weight gradient"
    if any(s in low for s in ("conv", "fprop", "cudnn", "winograd", "fft")):
        return "cuDNN conv"
    if any(s in low for s in ("gemm", "gemv", "cublas", "cutlass", "splitk", "dot_kernel")):
        return "cuBLAS products"
    return "elementwise, reduction, other"


def _is_device(e) -> bool:
    return (getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not bool(getattr(e, "is_user_annotation", False))
            and not e.name.startswith(ANNOTATION_PREFIXES))


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Segment:
    """A profiled stretch of the run, from :meth:`start` to :meth:`stop`,
    each behind a device synchronize so the wall holds whole work."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.units = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        if self.cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.prof is not None and not self.t1

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self) -> Dict[str, Any]:
        """busy_s, window_s, kernels {name: [launches, seconds]}, families,
        and the breakdown the result line carries."""
        events = list(self.prof.events())
        dev = [e for e in events if _is_device(e)]
        spans = [(e.time_range.start, e.time_range.end) for e in dev]
        merged = _union(spans)
        busy_us = sum(e - s for s, e in merged)
        kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
        families: Dict[str, float] = defaultdict(float)
        for e in dev:
            us = e.time_range.end - e.time_range.start
            kernels[e.name][0] += 1
            kernels[e.name][1] += us * 1e-6
            families[kernel_family(e.name)] += us * 1e-6
        gaps = _idle_gaps(merged, [e for e in events
                                   if getattr(e, "device_type", None)
                                   == torch.autograd.DeviceType.CPU])
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
        return {"busy_s": busy_us * 1e-6, "window_s": self.t1 - self.t0,
                "units": self.units, "kernels": {k: v for k, v in kernels.items()},
                "families": dict(sorted(families.items(), key=lambda kv: -kv[1])),
                "breakdown": {"device_ops": [[name[:200], v[1]] for name, v in top],
                              "idle_gaps": gaps}}


def _idle_gaps(merged: List[Tuple[float, float]], host: list) -> List[List[Any]]:
    """The ten longest gaps between device work, each named by what the
    busiest host thread had open at the gap's middle: the innermost
    ``portbench::`` range where one is open, else the innermost operator,
    in seconds."""
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:10]
    by_thread: Dict[int, list] = defaultdict(list)
    for e in host:
        by_thread[e.thread].append((e.time_range.start, e.time_range.end, e.name))
    main = max(by_thread, key=lambda t: len(by_thread[t])) if by_thread else None
    spans = sorted(by_thread.get(main, []))
    starts = [s for s, _, _ in spans]
    out = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = [(s, e, n) for s, e, n in spans[:bisect_right(starts, mid)] if e >= mid]
        ours = [n for _, _, n in open_ if n.startswith("portbench::")]
        name = ours[-1] if ours else (open_[-1][2] if open_ else "host between operators")
        out.append([name[:200], length * 1e-6])
    return out


def print_summary(summary: Dict[str, Any], out=sys.stderr) -> None:
    print(f"trace: window {summary['window_s']:.6f} s, device busy "
          f"{summary['busy_s']:.6f} s, {summary['units']} units", file=out)
    for fam, s in summary["families"].items():
        print(f"trace: family {fam}: {s:.6f} s", file=out)
    for name, s in summary["breakdown"]["device_ops"]:
        print(f"trace: kernel {s:.6f} s {name[:160]}", file=out)
    for name, s in summary["breakdown"]["idle_gaps"]:
        print(f"trace: idle gap {s:.6f} s during {name[:160]}", file=out)
