"""Each per-layer reader returns the right number from a synthetic trace and
run, and nothing where it finds nothing to read."""

from __future__ import annotations

import types

import pytest
import torch

from conftest import HARNESS
from portbench import core, tracing

PEAKS = {"flops": 67e12, "bytes_per_s": 3.35e12}


def reader(name):
    return core.load_module(HARNESS / "metrics" / f"{name}.py", f"r_{name.replace('.', '_')}").read


def ctx(entry, **layer):
    summary = layer.pop("summary", None)
    return types.SimpleNamespace(layer={"entry": entry, "peaks": PEAKS, **layer},
                                 trace_summary=summary)


def summary(busy, wall, kernels=None):
    return {"busy_s": busy, "window_s": wall, "kernels": kernels or {}, "units": 1}


def test_idle_shares():
    assert reader("idle_share.train")(ctx("train", summary=summary(0.75, 1.0))) == 25.0
    assert reader("idle_share.serve")(ctx("serve", summary=summary(0.4, 2.0))) == 80.0
    assert reader("idle_share.train")(ctx("serve", summary=summary(0.4, 2.0))) is None
    assert reader("idle_share.serve")(ctx("serve")) is None


def test_host_clock_readers():
    assert reader("loader_wait_ms.train")(ctx("train", loader_wait_s=[0.001, 0.003])) == \
        pytest.approx(2.0)
    assert reader("write_ms.serve")(ctx("serve", write_s=[0.04, 0.05, 0.06])) == \
        pytest.approx(50.0)
    assert reader("loader_wait_ms.train")(ctx("train", loader_wait_s=[])) is None
    latency = [i / 1000 for i in range(1, 101)]
    assert reader("event_p95_ms.serve")(ctx("serve", latency_s=latency)) == pytest.approx(95.05)
    assert reader("event_p95_ms.serve")(ctx("train", latency_s=latency)) is None


def test_mfu():
    c = ctx("train", flops_per_step=2.0e12, steps=67, window_s=10.0)
    assert reader("mfu.train")(c) == pytest.approx(100.0 * 2.0e12 * 67 / (10.0 * 67e12))
    c = ctx("serve", flops_per_event=6.7e11, events=100, window_s=10.0)
    assert reader("mfu.serve")(c) == pytest.approx(10.0)
    assert reader("mfu.serve")(ctx("serve", events=1, window_s=1.0)) is None
    cpu = ctx("train", flops_per_step=1.0, steps=1, window_s=1.0)
    cpu.layer["peaks"] = None
    assert reader("mfu.train")(cpu) is None


def test_mlp_tail_rooflines():
    sizes = {"T": 16, "H": 128, "W": 128}
    J, hw, h = 12 * 16, 128 * 128, 100
    bwd_bound = J * hw * (8.0 * h * h + 10.0 * h) / 67e12
    fwd_bound = J * hw * (4.0 * h * h + 4.0 * h) / 67e12
    kernels = {"void dk_mlp_tail_bwd_kernel<8>(float const*)": [4, 4 * 2 * bwd_bound],
               "sum_block_partials_kernel": [4, 0.0],
               "dk_mlp_tail_kernel": [5, 5 * fwd_bound / 0.5],
               "ampere_sgemm_128x64_nn": [9, 1.0]}
    c = ctx("train", summary=summary(1.0, 1.0, kernels), sizes=sizes, batch=12)
    assert reader("mlp_tail_bwd_roofline")(c) == pytest.approx(50.0)
    assert reader("mlp_tail_fused_roofline")(c) == pytest.approx(50.0)
    c = ctx("train", summary=summary(1.0, 1.0, {"gemm": [1, 1.0]}), sizes=sizes, batch=12)
    assert reader("mlp_tail_bwd_roofline")(c) is None
    assert reader("mlp_tail_fused_roofline")(c) is None


class _Ev:
    def __init__(self, name, start, end, device, thread=1, annotation=False):
        self.name, self.thread = name, thread
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = annotation


def test_trace_reduction():
    """Busy is the union of device work without annotations; idle gaps are
    named by what the host had open."""
    evs = [_Ev("k1", 0, 10, True), _Ev("k2", 5, 20, True), _Ev("memcpy HtoD", 50, 60, True),
           _Ev("portbench::loader_wait", 0, 100, True, annotation=True),
           _Ev("aten::copy_", 22, 49, False), _Ev("portbench::loader_wait", 21, 48, False)]
    seg = tracing.Segment(cuda=False)
    seg.prof = types.SimpleNamespace(events=lambda: evs)
    seg.t0, seg.t1 = 1.0, 1.0001
    s = seg.summary()
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["window_s"] == pytest.approx(1e-4)
    assert s["kernels"]["k2"] == [1, pytest.approx(15e-6)]
    assert s["breakdown"]["idle_gaps"] == [["portbench::loader_wait", pytest.approx(30e-6)]]
    assert tracing.kernel_family("void dk_mlp_tail_bwd_kernel<4>(float*)") == "ours"
    assert tracing.kernel_family("sm90_xmma_wgrad_implicit_gemm") == "cuDNN conv weight gradient"
