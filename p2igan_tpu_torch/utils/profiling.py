"""Timing, tracing and counting helpers of the port's measurement scripts.

The counterpart of what ``scripts/profile_infer.py``, ``profile_train.py``,
``roofline_train.py`` and ``sweep.py`` share in the JAX package, for
``scripts/profile_infer_torch.py``, ``profile_train_torch.py``,
``roofline_train_torch.py`` and ``sweep_torch.py``. Nothing on the serving or
training path imports this module.

* :func:`timeit`: seconds a call, by CUDA events on the card (the timed region
  ends in ``torch.cuda.synchronize()``), by the host clock on the CPU.
* :func:`capture_trace` and :func:`device_time_by_family`: a ``torch.profiler``
  window and its device time summed into families (cuDNN convolution
  forward, data gradient and weight gradient; cuBLAS products; each of the
  port's own kernels by its ``csrc`` source; elementwise and reduction;
  copies, transposes and memcpy/memset; the optimizer's kernels; other),
  with the window's device-busy share.
* :func:`count_ops_bytes`: operations (``FlopCounterMode``: convolutions and
  products) and bytes (every aten op's operands and results, once each) of
  one call, the port's own kernels counted by the formulas of their bounds;
  :func:`bound_ms` turns them into the least time the card could take for
  that traffic. The bytes leave out what a library moves besides the
  operands (cuDNN's workspace, an FFT algorithm's spectra, re-reads that miss
  L2), so for such algorithms they are a low estimate and a share of the
  bound reads low with them.
* What the scripts share to set up a run: the gauge mask, the flagship
  generator, the GAN step of ``p2igan_gan_baseline_gauge.json``, events.
"""

from __future__ import annotations

import copy
import re
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

# H100 SXM data sheet: the float32 rate outside the tensor cores (the port's
# precision policy keeps TF32 off) and the HBM3 rate, as in chip_smoke.py
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

CONFIG_DIR = Path(__file__).resolve().parents[1] / "config"
# the seed of every mask, event and weight the scripts make
SEED = 0
GAN_CONFIG = CONFIG_DIR / "p2igan_gan_baseline_gauge.json"

# the port's kernels (``csrc`` entry, ``__global__`` names) by source file
CSRC_KERNELS = {
    "gauge_topk.cu": ("gauge_topk_kernel",),
    "combine_table_multi.cu": ("combine_table_multi_kernel",),
    "combine_table_multi_bwd.cu": ("combine_table_multi_bwd_kernel",),
    "pool_dup.cu": ("pool_dup_kernel",),
    "combine_table.cu": ("combine_table_kernel",),
    "combine_table_bwd.cu": ("combine_table_bwd_kernel",),
    "combine_dense.cu": ("combine_dense_kernel",),
    "idw_knn_cells.cu": ("cell_init_kernel", "cell_count_kernel", "cell_scan_kernel",
                         "cell_scatter_kernel", "cell_decode_kernel", "knn_cells_kernel"),
    "idw_scatter.cu": ("idw_scatter_kernel",),
    "fixed_sum.cuh": ("row_absmax_kernel", "fixed_finish_kernel"),
    "decode_mask.cu": ("decode1_kernel", "decode4_kernel"),
    "dk_mlp_tail.cu": ("dk_mlp_tail_kernel",),
    "dk_mlp_tail_bwd.cu": ("dk_mlp_tail_bwd_kernel", "sum_block_partials_kernel"),
    "enc0_conv.cu": ("enc0_kernel",),
    "dec2_stencil.cu": ("dec2_kernel",),
}
_OWN = {name: src for src, names in CSRC_KERNELS.items() for name in names}
_OWN_RE = re.compile(r"(?:^|[\s:*&])(" + "|".join(sorted(_OWN, key=len, reverse=True))
                     + r")\s*[<(]")

CONV_FWD, CONV_DGRAD, CONV_WGRAD = ("cuDNN conv forward", "cuDNN conv data gradient",
                                    "cuDNN conv weight gradient")
GEMM, ELEMENTWISE, COPIES = ("cuBLAS products", "elementwise and reduction",
                             "copies, transposes, memcpy/memset")
OPTIMIZER, OTHER = "optimizer", "other"
# a range the optimizer's step runs in (torch.optim wraps every step in one)
OPTIMIZER_RANGE = "Optimizer.step#"
# the ranges :func:`module_ranges` opens around each module's forward
MODULE_RANGE = "module::"


def own_family(src: str) -> str:
    return f"ours: {src}"


def kernel_family(name: str, in_optimizer: bool = False, backward: bool = False) -> str:
    """The family of a device kernel (or memcpy/memset) by its name. A
    kernel launched inside the optimizer's step is the optimizer's; a cuDNN
    kernel launched by a convolution's backward that is not named for the
    weight gradient is taken for the data gradient."""
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return COPIES
    m = _OWN_RE.search(name)
    if m:
        return own_family(_OWN[m.group(1)])
    if in_optimizer:
        return OPTIMIZER
    if any(s in low for s in ("nchwtonhwc", "nhwctonchw", "transpose", "copy")):
        return COPIES
    if "dgrad" in low:
        return CONV_DGRAD
    if "wgrad" in low:
        return CONV_WGRAD
    # cuDNN's FFT algorithm: transforms and the spectra's pointwise products
    if any(s in low for s in ("conv", "fprop", "cudnn", "winograd", "fft",
                              "pointwise_mult_and_sum")):
        return CONV_DGRAD if backward else CONV_FWD
    if any(s in low for s in ("gemm", "gemv", "cublas", "cutlass", "splitk", "dot_kernel")):
        return GEMM
    if any(s in low for s in ("elementwise", "reduce", "index", "gather", "scatter",
                              "pool", "upsample", "softmax", "norm", "fill", "where",
                              "distribution", "sort", "topk", "cumsum", "scan",
                              "unrolled", "vectorized", "kernel_impl")):
        return ELEMENTWISE
    return OTHER


# -- timing ---------------------------------------------------------------------

def _on_cuda(objs) -> bool:
    for a in objs:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return True
        if isinstance(a, (list, tuple)) and _on_cuda(a):
            return True
        if isinstance(a, dict) and _on_cuda(a.values()):
            return True
    return False


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, reps: int = 20, warmup: int = 1,
           device: Optional[torch.device | str] = None) -> float:
    """Seconds a call of ``fn(*args)``: ``warmup`` calls, then ``reps`` calls
    between two CUDA events, the region ending in ``torch.cuda.synchronize()``
    (``device`` CUDA, or any tensor argument on the card); on the CPU the host
    clock around the calls."""
    cuda = (torch.device(device).type == "cuda") if device is not None else _on_cuda(args)
    for _ in range(warmup):
        fn(*args)
    _sync(cuda)
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps


# -- tracing --------------------------------------------------------------------

class Trace:
    """A ``torch.profiler`` window: the profile and its wall time (us)."""

    def __init__(self, prof, wall_us: float, reps: int):
        self.prof, self.wall_us, self.reps = prof, wall_us, reps


def capture_trace(fn: Callable, *args, reps: int = 5, warmup: int = 1,
                  device: Optional[torch.device | str] = None) -> Trace:
    """``reps`` calls of ``fn(*args)`` in one profiler window (CPU, and CUDA
    where the call runs on the card), after ``warmup`` calls; the window ends
    after a synchronize, so every launch of the calls is in it."""
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.device(device).type == "cuda") if device is not None else _on_cuda(args)
    for _ in range(warmup):
        fn(*args)
    _sync(cuda)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        _sync(cuda)
        wall_us = (time.perf_counter() - t0) * 1e6
    return Trace(prof, wall_us, reps)


def _is_annotation(e) -> bool:
    """A ``record_function`` range, which the profiler also draws on the
    device's timeline: not device work."""
    return bool(getattr(e, "is_user_annotation", False)) or \
        getattr(e, "key", getattr(e, "name", "")).startswith(
            (MODULE_RANGE, OPTIMIZER_RANGE, "ProfilerStep"))


def _is_host(e) -> bool:
    return getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU


def _is_device(e) -> bool:
    """A kernel, memcpy or memset on the card (not an annotation's span)."""
    return (getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not _is_annotation(e))


def _launches(events) -> Dict[int, Tuple[int, float]]:
    """For each device event (by position in ``events``): the thread and host
    time of its launch, from the runtime call of the same correlation id (the
    port's ctypes kernels included), else from the op it is linked to."""
    cpu = [e for e in events if _is_host(e)]
    runtime = {e.id: e for e in cpu if e.name.startswith("cu")}
    ops = {}
    for e in cpu:
        if not e.name.startswith("cu"):
            ops.setdefault(e.id, e)
    out = {}
    for i, e in enumerate(events):
        if not _is_device(e):
            continue
        host = runtime.get(e.id)
        if host is None:
            host = ops.get(getattr(e, "linked_correlation_id", 0) or -1)
        if host is not None:
            out[i] = (host.thread, host.time_range.start)
    return out


class _Ranges:
    """Host intervals by thread (properly nested, as call stacks are): the
    ones that hold a time, innermost first, by a bisection and a walk up
    the nesting."""

    def __init__(self, events):
        by_thread: Dict[int, list] = defaultdict(list)
        for e in events:
            if not getattr(e, "is_async", False):
                by_thread[e.thread].append((e.time_range.start, -e.time_range.end, e))
        self.threads = {}
        for thread, spans in by_thread.items():
            spans.sort(key=lambda s: (s[0], s[1]))
            starts = [s[0] for s in spans]
            ends = [-s[1] for s in spans]
            parent, stack = [], []
            for i, (s0, _, _) in enumerate(spans):
                while stack and ends[stack[-1]] < s0:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.threads[thread] = (starts, ends, parent, [s[2] for s in spans])

    def enclosing(self, thread: int, t: float) -> List[Any]:
        """The events on ``thread`` whose interval holds ``t``, innermost first."""
        from bisect import bisect_right

        if thread not in self.threads:
            return []
        starts, ends, parent, evs = self.threads[thread]
        node = bisect_right(starts, t) - 1
        while node >= 0 and ends[node] < t:
            node = parent[node]
        out = []
        while node >= 0:
            out.append(evs[node])
            node = parent[node]
        return out


def device_events(prof) -> list:
    return [e for e in prof.events() if _is_device(e)]


def device_total_us(prof) -> float:
    """The window's device time: the key averages' self device time of every
    device row (kernels, memcpy, memset; not the ranges' spans)."""
    return sum(r.self_device_time_total for r in prof.key_averages() if _is_device(r))


class _DeviceWork:
    """A profile's device work alone, for ``training.trainer.device_busy_us``
    (whose union would otherwise take in the spans that ``record_function``
    ranges draw on the device's timeline)."""

    def __init__(self, prof):
        self._events = device_events(prof)

    def events(self):
        return self._events


def attribute_kernels(prof, with_modules: bool = False) -> List[Dict[str, Any]]:
    """One record per device event of the window: name, us, family, and (with
    ``with_modules``) the innermost :func:`module_ranges` range its launch
    falls in; a backward kernel takes the range of the forward op of the
    same autograd sequence number, marked "(backward)"."""
    events = list(prof.events())
    launches = _launches(events)
    cpu = [e for e in events if _is_host(e)]
    opt_ranges = _Ranges([e for e in cpu if e.name.startswith(OPTIMIZER_RANGE)])
    ops = _Ranges([e for e in cpu if e.name.startswith(("aten::", "autograd::"))
                   or getattr(e, "sequence_nr", -1) >= 0])
    mods = _Ranges([e for e in cpu if e.name.startswith(MODULE_RANGE)]) if with_modules else None
    fwd_by_seq: Dict[int, Any] = {}
    if with_modules:
        for e in cpu:
            seq = getattr(e, "sequence_nr", -1)
            if seq >= 0 and e.name.startswith("aten::") and seq not in fwd_by_seq:
                fwd_by_seq[seq] = e
    out = []
    for i, e in enumerate(events):
        if not _is_device(e):
            continue
        us = e.time_range.end - e.time_range.start
        rec = {"name": e.name, "us": us, "module": None}
        thread, t = launches.get(i, (None, None))
        in_opt = backward = False
        enclosing = []
        if thread is not None:
            in_opt = bool(opt_ranges.enclosing(thread, t))
            enclosing = ops.enclosing(thread, t)
            backward = any("backward" in o.name.lower() for o in enclosing)
        rec["family"] = kernel_family(e.name, in_optimizer=in_opt, backward=backward)
        if with_modules and thread is not None:
            hit = mods.enclosing(thread, t)
            if hit:
                rec["module"] = hit[0].name[len(MODULE_RANGE):]
            else:
                seqs = [o.sequence_nr for o in enclosing if getattr(o, "sequence_nr", -1) >= 0]
                fwd = fwd_by_seq.get(seqs[0]) if seqs else None
                if fwd is not None:
                    hit = mods.enclosing(fwd.thread, fwd.time_range.start)
                    if hit:
                        rec["module"] = hit[0].name[len(MODULE_RANGE):] + " (backward)"
        out.append(rec)
    return out


def device_time_by_family(trace: Trace, with_modules: bool = False) -> Dict[str, Any]:
    """The window's device time by family (us), sorted by time, beside the
    window's device total from the key averages (the families must add up to
    it), the device-busy time (the union of the device intervals,
    ``training.trainer.device_busy_us``) and its share of the wall time."""
    from ..training.trainer import device_busy_us

    records = attribute_kernels(trace.prof, with_modules=with_modules)
    fam: Dict[str, float] = defaultdict(float)
    for r in records:
        fam[r["family"]] += r["us"]
    busy = device_busy_us(_DeviceWork(trace.prof))
    return {"families": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
            "family_sum_us": sum(fam.values()),
            "device_total_us": device_total_us(trace.prof),
            "busy_us": busy, "busy_with_ranges_us": device_busy_us(trace.prof),
            "wall_us": trace.wall_us,
            "busy_share": busy / trace.wall_us if trace.wall_us else 0.0,
            "reps": trace.reps, "records": records}


def family_table(fams: Dict[str, Any], what: str) -> List[str]:
    """Markdown rows of :func:`device_time_by_family`'s result."""
    total = fams["device_total_us"]
    lines = [f"| family | ms ({what}) | share of device time |", "| --- | --- | --- |"]
    for name, us in fams["families"].items():
        lines.append(f"| {name} | {us / 1e3:.4f} | {us / total if total else 0.0:.4f} |")
    lines.append(f"| **sum of the families** | {fams['family_sum_us'] / 1e3:.4f} | "
                 f"{fams['family_sum_us'] / total if total else 0.0:.4f} |")
    lines.append("")
    other: Dict[str, float] = defaultdict(float)
    for r in fams["records"]:
        if r["family"] == OTHER:
            other[r["name"]] += r["us"]
    if other:
        lines.append("In other: " + "; ".join(
            f"`{name[:80]}` {us / 1e3:.4f} ms"
            for name, us in sorted(other.items(), key=lambda kv: -kv[1])[:5]) + ".")
    if total:
        lines.append(f"Device total {total / 1e3:.4f} ms (key averages); device busy "
                     f"{fams['busy_us'] / 1e3:.4f} ms of {fams['wall_us'] / 1e3:.4f} ms wall: "
                     f"busy share {fams['busy_share']:.4f} (with the ranges' device spans, "
                     f"as the trainer's profile window counts: "
                     f"{fams['busy_with_ranges_us'] / fams['wall_us']:.4f}).")
    else:
        lines.append(f"No device events in the window (a CPU run): "
                     f"{fams['wall_us'] / 1e3:.4f} ms wall.")
    return lines


class module_ranges:
    """A context that opens a ``record_function`` range ``module::<name>``
    around the forward of every module of ``modules`` (name prefix -> module),
    so a trace can say which module launched a kernel."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.modules = modules
        self.handles: list = []
        self.stack: list = []

    def __enter__(self):
        from torch.autograd.profiler import record_function

        def pre(name):
            def hook(module, args):
                rf = record_function(MODULE_RANGE + name)
                rf.__enter__()
                self.stack.append(rf)
            return hook

        def post(module, args, out):
            if self.stack:
                self.stack.pop().__exit__(None, None, None)

        for prefix, root in self.modules.items():
            for name, m in root.named_modules():
                full = f"{prefix}.{name}" if name else prefix
                self.handles.append(m.register_forward_pre_hook(pre(full)))
                self.handles.append(m.register_forward_hook(post))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        while self.stack:
            self.stack.pop().__exit__(None, None, None)
        return False


# -- counting -------------------------------------------------------------------

def bound_ms(ops: float, nbytes: float) -> float:
    """The least time the card could take: the operations at the float32 rate
    or the bytes at the memory rate, whichever is longer (ms)."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3


def _kf(D: int, k: int) -> int:
    from ..ops.idw_factored_kernel import pruned_frame_table

    return int(pruned_frame_table(D, k)[0].shape[1])


def topk_count(hw: int, batch: int, slots: int, k: int) -> Tuple[float, float]:
    """(operations, bytes) of #1 for ``batch`` masks of ``slots`` slots over
    ``hw`` pixels: two coordinates a pixel and three numbers a slot in, k
    distances and k slot ids a pixel out; 7 operations a (pixel, slot): the
    distance and its compare with the k-th place (the one pass; its rare
    entries are not counted). ``chip_smoke.py``'s bound of #1."""
    return (batch * hw * slots * 7.0,
            4.0 * (2 * hw + 3 * batch * slots + 2 * k * batch * hw))


def gauge_topk_count(qx, qy, gx, gy, penalty, k: int = 4) -> Tuple[float, float]:
    """:func:`topk_count` of a ``gauge_topk`` call's arguments."""
    return topk_count(qx.numel(), gx.shape[0] if gx.dim() == 2 else 1, gx.shape[-1], k)


def combine_count(n: int, D: int, G: int, hw: int, k: int) -> Tuple[float, float]:
    """(operations, bytes) of #2 and #4, which move the same bytes: the (k, HW)
    distances and slots, the (N, D, G) tables and the (N, D, HW) field; per
    (z, pixel) kf*k candidate distances (8 operations with the sqrt and the
    weight), k selection rounds over them and 2 k operations a window.
    ``chip_smoke.py``'s bound of #2 and #4."""
    cand = _kf(D, k) * k
    return (float(D * hw * (cand * 8 + k * cand + 2 * k * n)),
            4.0 * (2 * k * hw + n * D * G + n * D * hw))


def combine_table_multi_count(gd2_t, gsel_t, tables, k: int = 4, *a, **kw):
    n, D, G = tables.shape
    return combine_count(n, D, G, gd2_t.shape[1], k)


def combine_table_multi_bwd_count(gd2_t, gsel_t, g, G: int, k: int = 4, *a, **kw):
    n, D, hw = g.shape
    return combine_count(n, D, G, hw, k)


def maxpool2_duplicate_count(x) -> Tuple[float, float]:
    """#3: the input once and the output (half as many elements) once; three
    comparisons a 2x2 window."""
    return 0.75 * x.numel(), 1.5 * x.numel() * x.element_size()


def mlp_tail_count(phi_part, offsets, *weights) -> Tuple[float, float]:
    """#12: per (j, pixel) two (h, h) layers and the fc4 dot; phi, the
    offsets and the weights in, the (J, HW) field out. ``chip_smoke.py``'s
    bound of #12."""
    (hw, h), J = phi_part.shape, offsets.shape[0]
    return (float(J * hw * (4 * h * h + 4 * h)),
            4.0 * (hw * h + J * h + 2 * h * h + 3 * h + 1 + J * hw))


def mlp_tail_bwd_count(phi_part, offsets, g, *weights) -> Tuple[float, float]:
    """#13: six (h, h) products a (j, pixel) (two recomputed, two transposed,
    two weight gradients); phi, g and the weights in, the gradients out.
    ``chip_smoke.py``'s bound of #13."""
    (hw, h), J = phi_part.shape, offsets.shape[0]
    return (float(J * hw * (12 * h * h + 10 * h)),
            4.0 * (2 * hw * h + 2 * J * h + J * hw + 4 * h * h + 6 * h))


def fused_conv_count(x, weight, bias, *a) -> Tuple[float, float]:
    """#14 and #15: a 3x3x3 SAME convolution of channels-last x (..., Cin)
    with the bias and the activation; x, the weights and the output once.
    ``chip_smoke.py``'s bound of both."""
    cin, cout = x.shape[-1], weight.shape[-1]
    voxels = x.numel() // cin
    return (float(voxels * cout * (2 * 27 * cin + 3)),
            4.0 * (x.numel() + voxels * cout + weight.numel() + bias.numel()))


# (module, attribute, count) of each kernel wrapper the p2igan stis, dk, stdk
# and simple paths call; the module attribute is where the callers look the
# wrapper up
COUNTED_KERNELS = (
    ("p2igan_tpu_torch.ops.idw_factored_kernel", "gauge_topk", gauge_topk_count),
    ("p2igan_tpu_torch.ops.idw_factored_kernel", "combine_table_multi",
     combine_table_multi_count),
    ("p2igan_tpu_torch.ops.idw_factored_kernel", "combine_table_multi_bwd",
     combine_table_multi_bwd_count),
    ("p2igan_tpu_torch.ops.layers", "maxpool2_duplicate", maxpool2_duplicate_count),
    ("p2igan_tpu_torch.models.dk", "mlp_tail_fused", mlp_tail_count),
    ("p2igan_tpu_torch.ops.dk_mlp_kernel", "mlp_tail_bwd", mlp_tail_bwd_count),
    ("p2igan_tpu_torch.models.simple", "enc0_conv3d_leaky", fused_conv_count),
    ("p2igan_tpu_torch.models.simple", "conv3d_cout1_sigmoid", fused_conv_count),
)


class _CountedKernel:
    """Stands in for a kernel wrapper while :func:`count_ops_bytes` runs: adds
    its formula's operations and bytes, then calls the wrapper with the
    dispatch modes off (on the CPU the wrapper runs its plain version, which
    must not be counted as aten ops). ``launches`` reads and writes the
    wrapper's own counter."""

    def __init__(self, name: str, fn: Callable, count: Callable, sink: Dict[str, list]):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_count", count)
        object.__setattr__(self, "_sink", sink)

    def __call__(self, *args, **kwargs):
        from torch.utils._python_dispatch import _disable_current_modes

        ops, nbytes = self._count(*args, **kwargs)
        entry = self._sink.setdefault(self._name, [0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += ops
        entry[2] += nbytes
        with _disable_current_modes():
            return self._fn(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._fn, item)

    def __setattr__(self, item, value):
        setattr(self._fn, item, value)


# aten ops that move no data: views, aliases and allocations
_NO_TRAFFIC = {
    "view", "_unsafe_view", "_reshape_alias", "reshape", "expand", "permute", "transpose",
    "t", "as_strided", "slice", "select", "unsqueeze", "squeeze", "detach", "alias", "split",
    "split_with_sizes", "chunk", "unbind", "narrow", "unfold", "diagonal", "empty",
    "empty_strided", "empty_like", "new_empty", "new_empty_strided", "lift_fresh",
}


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(o) for o in obj.values())
    return 0


def count_ops_bytes(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Operations and bytes of one call ``fn(*args, **kwargs)``:

    * ``ops``: ``FlopCounterMode``'s count (convolutions and products, forward
      and backward), plus the port's kernels' operations;
    * ``bytes``: every aten op's operands and results, once each (views and
      allocations move nothing), plus the port's kernels' bytes: the
      operands' and results' traffic, which leaves out a library's workspace
      and intermediates (cuDNN's FFT spectra), a low estimate for such
      algorithms;
    * ``kernels``: {wrapper: [calls, ops, bytes]} of the port's kernels, which
      are ctypes calls that neither mode sees (on the CPU their plain
      versions, which are not counted: the count is the kernel's formula;
      the dk tail's plain version has no #13 call, so on the CPU its
      backward is counted as aten ops);
    * ``bound_ms``: :func:`bound_ms` of the two;
    * ``result``: what ``fn`` returned."""
    import importlib

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.overloadpacket.__name__ not in _NO_TRAFFIC:
                self.nbytes += _tensor_bytes(args) + _tensor_bytes(kwargs) + _tensor_bytes(out)
            return out

    sink: Dict[str, list] = {}
    saved = []
    try:
        for mod_name, attr, count in COUNTED_KERNELS:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            saved.append((mod, attr, orig))
            setattr(mod, attr, _CountedKernel(attr, orig, count, sink))
        flops = FlopCounterMode(display=False)
        nb = _Bytes()
        with flops, nb:
            result = fn(*args, **kwargs)
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)
    k_ops = sum(v[1] for v in sink.values())
    k_bytes = sum(v[2] for v in sink.values())
    ops = float(flops.get_total_flops()) + k_ops
    nbytes = float(nb.nbytes) + k_bytes
    return {"ops": ops, "bytes": nbytes, "kernels": sink,
            "bound_ms": bound_ms(ops, nbytes), "result": result}


# -- what the scripts set up -----------------------------------------------------

def gauge_mask(H: int, W: int, n_gauges: int = 79) -> np.ndarray:
    """(H*W,) float32 0/1 mask of ``n_gauges`` gauges drawn without
    replacement (the JAX scripts' ``gauge_mask``)."""
    rng = np.random.default_rng(SEED)
    mask_flat = np.zeros((H * W,), np.float32)
    mask_flat[rng.choice(H * W, n_gauges, replace=False)] = 1.0
    return mask_flat


def default_gauges(H: int, W: int) -> int:
    """The shipped 79 gauges, fewer on a small grid (one a 16 pixels)."""
    return min(79, H * W // 16)


def flagship_generator(H: int, W: int, T: int, base: int, n_gauges: int, device):
    """The p2igan stis generator (factored IDW, one shared mask, the budget
    ``P2IGenerator.from_config`` gives for ``n_gauges``) with seeded weights."""
    from ..models import P2IGenerator

    return P2IGenerator(H=H, W=W, length=T, base_channels=base,
                        idw_max_points=-(-T * n_gauges // 128) * 128,
                        idw_factored=True, idw_shared_batch_mask=True,
                        generator=torch.Generator().manual_seed(SEED), device=device)


def build_events(mask_flat: np.ndarray, n_events: int, event_t: int, H: int,
                 W: int) -> Tuple[np.ndarray, np.ndarray]:
    """(masked, masks) (E, event_t, H, W, 1) float32 events under the fixed
    mask (the JAX scripts' ``build_events``)."""
    rng = np.random.default_rng(SEED)
    event_mask = np.broadcast_to(mask_flat.reshape(1, H, W, 1),
                                 (event_t, H, W, 1)).astype(np.float32)
    masked = rng.random((n_events, event_t, H, W, 1), dtype=np.float32) * event_mask[None]
    masks = np.ascontiguousarray(np.broadcast_to(event_mask[None], masked.shape))
    return masked, masks


def gan_config(tmp: Path, H: int, W: int, T: int, base: int, n_gauges: int,
               d3d_dtype: str = "float32") -> Dict[str, Any]:
    """``p2igan_gan_baseline_gauge.json`` at H x W, T frames and ``base``
    channels, its stis mask a file of ``n_gauges`` gauges written under
    ``tmp``."""
    from ..config import load_config

    cfg = copy.deepcopy(load_config(GAN_CONFIG))
    from ..data.fake import write_gauge_mask

    mask_file = write_gauge_mask(Path(tmp) / "gauge_mask.txt", H=H, W=W,
                                 n_gauges=n_gauges, seed=SEED + 1)
    cfg["model"]["base_channels"] = base
    cfg["model"]["disc_branch3d_dtype"] = d3d_dtype
    cfg["data"]["train"].update({"h": H, "w": W, "sample_length": T})
    cfg["data"]["train"]["mask"]["file"] = str(mask_file)
    cfg["data"].pop("test", None)
    return cfg


class GanStep:
    """The hinge-GAN step of a config (``training/steps.py``
    ``build_train_step``), with the models, optimizers and a batch on
    ``device``: generator seeded from ``SEED`` and critic from ``SEED + 1``,
    as the trainer seeds them; the stis gauge selection hoisted as the
    trainer hoists it (``hoist_idw``), else inside every forward."""

    def __init__(self, cfg: Dict[str, Any], batch: int, device, hoist_idw: bool = True):
        from ..data.masks import load_gauge_mask
        from ..models import build_discriminator, build_generator
        from ..training.steps import build_train_step, make_optimizer

        self.cfg, self.batch, self.device = cfg, batch, torch.device(device)
        train = cfg["data"]["train"]
        H, W, T = train["h"], train["w"], train["sample_length"]
        self.gen = build_generator(cfg, device=device,
                                   generator=torch.Generator().manual_seed(SEED))
        self.disc = build_discriminator(cfg, device=device,
                                        generator=torch.Generator().manual_seed(SEED + 1))
        opt_cfg = cfg["train"]["optimizer"]
        self.opt_g = make_optimizer(opt_cfg, self.gen.parameters())
        self.opt_d = make_optimizer(opt_cfg, self.disc.parameters())
        loss = cfg["loss"]
        self.k1_alpha = loss.get("k1_weight", 0.0)
        self.adversarial_weight = loss.get("adversarial_weight", 0.01)
        self.gan_loss_type = loss.get("gan_loss", "hinge")
        mask = torch.from_numpy(np.asarray(load_gauge_mask(train["mask"]["file"]),
                                           np.float32)).reshape(H, W)
        gen = torch.Generator().manual_seed(SEED + 2)
        self.frames = torch.rand((batch, T, H, W, 1), generator=gen).to(device)
        self.masks = mask.reshape(1, 1, H, W, 1).expand(batch, T, H, W, 1).contiguous().to(device)
        self.masked = self.frames * self.masks
        self.prep = self.gen.prepare_idw(self.masks[0, 0, :, :, 0]) if hoist_idw else None
        self.step = build_train_step(
            self.gen, self.disc, self.opt_g, self.opt_d, use_gan=True,
            gan_loss_type=self.gan_loss_type, adversarial_weight=self.adversarial_weight,
            k1_alpha=self.k1_alpha, gan_real_label=loss.get("target_real_label", 1.0),
            gan_fake_label=loss.get("target_fake_label", 0.0),
            fused_disc_forward=bool(cfg["train"].get("fused_disc_forward", True)),
            idw_prepared=self.prep)

    def __call__(self):
        return self.step(self.frames, self.masked, self.masks)

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"G": self.gen, "D": self.disc}


def card_line() -> str:
    """``name, power limit`` of the first card as nvidia-smi gives them, or
    the reason there is none."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def describe_device(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} ({card_line()})"
    return "cpu"


def write_out(path: Optional[Path], lines: Iterable[str]) -> None:
    """Print the lines and, where ``--out`` names a file, write them there."""
    text = "\n".join(lines)
    print(text, flush=True)
    if path is not None:
        Path(path).write_text(text + "\n")
