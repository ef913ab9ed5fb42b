"""The port's measurement helpers (``p2igan_tpu_torch/utils/profiling.py``)
and the four measurement scripts on the CPU, at a tiny size (16x16, T=4,
base 16: the generator needs base = 4 T).

* ``count_ops_bytes`` of one ``Conv3d`` and one ``Linear`` equals the
  analytic count exactly;
* the GAN step's operations equal the sum of its blocks' (roofline script);
* ``kernel_family`` sorts real kernel names into their families, and the
  attribution of a trace's kernels to the optimizer and to modules follows
  the launches (a synthetic trace);
* ``--device cpu`` runs of profile_infer_torch, profile_train_torch,
  roofline_train_torch and sweep_torch scan print their tables; without a
  GPU and without ``--device cpu`` a script fails (no fallback)."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from p2igan_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--size", "16", "--frames", "4", "--base", "16"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the test run has a worker a core, and more
    threads oversubscribe them (small CPU ops then wait on each other far
    longer than they compute; the counts and tables do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"prof_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_count_of_a_conv3d_is_analytic():
    conv = torch.nn.Conv3d(3, 5, (3, 2, 3), padding=1, groups=1)
    x = torch.randn(2, 3, 4, 6, 5)
    c = profiling.count_ops_bytes(conv, x)
    out = c["result"]
    assert c["ops"] == 2 * out.numel() * 3 * 3 * 2 * 3
    assert c["bytes"] == 4 * (x.numel() + conv.weight.numel() + conv.bias.numel() + out.numel())
    assert c["bound_ms"] == profiling.bound_ms(c["ops"], c["bytes"])
    assert c["kernels"] == {}


def test_count_of_a_linear_is_analytic():
    lin = torch.nn.Linear(7, 9)
    x = torch.randn(4, 7)
    c = profiling.count_ops_bytes(lin, x)
    assert c["ops"] == 2 * 4 * 7 * 9
    assert c["bytes"] == 4 * (x.numel() + 7 * 9 + 9 + 4 * 9)


def test_the_steps_operations_are_the_sum_of_its_blocks():
    roof = load_script("roofline_train_torch")
    res = roof.main(TINY + ["--batch", "2", "--reps", "1"])
    rows, step = res["rows"], res["step"]
    assert step[1] > 0
    assert step[1] == sum(rows[name][1] for name in roof.BLOCKS)
    assert rows["g_fwd"][1] + rows["g_bwd"][1] == res["fwdbwd"][1]
    # the port's kernels of the step, counted by their formulas
    assert {k: v[0] for k, v in res["kernels"].items()} == {
        "combine_table_multi": 1, "combine_table_multi_bwd": 1, "maxpool2_duplicate": 3}
    assert any("Share of the float32 peak" in line for line in res["lines"])


KERNEL_NAMES = [
    ("void cudnn::detail::dgrad_alg1_nd_float_engine<float, 3, 0, false>(int, int, int)",
     profiling.CONV_DGRAD),
    ("void cudnn::detail::wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>(int)",
     profiling.CONV_WGRAD),
    ("void implicit_convolveNd_sgemm<float, 3, 1024, 5, 5, 3, 3, 3, 1, false>(int)",
     profiling.CONV_FWD),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize128x128x16",
     profiling.CONV_FWD),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*, float2*, int)",
     profiling.CONV_FWD),
    ("void cudnn::ops::nchwToNhwcKernel<float, float, float, false, true>(int)",
     profiling.COPIES),
    ("ampere_sgemm_128x64_nn", profiling.GEMM),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32_warpgroupsize1x1x1",
     profiling.GEMM),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>(Params)",
     profiling.GEMM),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>)",
     profiling.ELEMENTWISE),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, 4> >(int)",
     profiling.ELEMENTWISE),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::direct_copy_kernel_cuda"
     "(at::TensorIteratorBase&)::{lambda()#3}>(int)", profiling.COPIES),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 4>(int)",
     profiling.COPIES),
    ("Memcpy HtoD (Pageable -> Device)", profiling.COPIES),
    ("Memset (Device)", profiling.COPIES),
    ("gauge_topk_kernel(float const*, float const*, int, int)",
     profiling.own_family("gauge_topk.cu")),
    ("combine_table_multi_kernel(float const*, int const*, int)",
     profiling.own_family("combine_table_multi.cu")),
    ("combine_table_multi_bwd_kernel(float const*, int const*, int)",
     profiling.own_family("combine_table_multi_bwd.cu")),
    ("combine_table_kernel(float const*, int const*, int)",
     profiling.own_family("combine_table.cu")),
    ("void pool_dup_kernel<float>(float const*, float*, int, int, int, int)",
     profiling.own_family("pool_dup.cu")),
    ("row_absmax_kernel(float const*, float const*, int)", profiling.own_family("fixed_sum.cuh")),
    ("void some_vendor::unknown_thing<7>(int)", profiling.OTHER),
]


NAMED = {key: next(n for n, _ in KERNEL_NAMES if key in n)
         for key in ("wgrad_alg0", "implicit_convolveNd", "CUDAFunctor_add", "gauge_topk")}


@pytest.mark.parametrize("name,family", KERNEL_NAMES, ids=[n[:40] for n, _ in KERNEL_NAMES])
def test_kernel_family_sorts_real_names(name, family):
    assert profiling.kernel_family(name) == family


def test_kernel_family_takes_the_launch_context():
    add = NAMED["CUDAFunctor_add"]
    assert profiling.kernel_family(add, in_optimizer=True) == profiling.OPTIMIZER
    # a cuDNN kernel of a convolution's backward that is not named for the
    # weight gradient is the data gradient's
    assert profiling.kernel_family(NAMED["implicit_convolveNd"], backward=True) == \
        profiling.CONV_DGRAD
    assert profiling.kernel_family(NAMED["wgrad_alg0"], backward=True) == profiling.CONV_WGRAD
    # the port's kernels keep their family in any context
    assert profiling.kernel_family(NAMED["gauge_topk"], in_optimizer=True) == \
        profiling.own_family("gauge_topk.cu")


def _ev(name, start, end, thread=1, id=0, device=False, seq=-1, linked=0, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, id=id, thread=thread, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end),
                           sequence_nr=seq, linked_correlation_id=linked, is_async=False,
                           is_user_annotation=annotation)


def test_attribution_follows_the_launches():
    """A forward convolution in module G.conv (thread 1), its backward on the
    engine's thread 2 (same sequence number), an Adam update in the
    optimizer's range, and a kernel whose launch is linked only to its op;
    the ranges' spans on the device's timeline are not device work."""
    events = [
        _ev("module::G", 0, 100), _ev("module::G.conv", 10, 50),
        _ev("aten::convolution", 12, 40, id=101, seq=7),
        _ev("cudaLaunchKernel", 20, 22, id=9001),
        _ev("autograd::engine::evaluate_function: ConvolutionBackward0", 200, 300, thread=2),
        _ev("ConvolutionBackward0", 201, 299, thread=2, seq=7),
        _ev("aten::convolution_backward", 205, 290, thread=2, id=102),
        _ev("cudaLaunchKernel", 210, 212, thread=2, id=9002),
        _ev("cudaLaunchKernel", 220, 222, thread=2, id=9003),
        _ev("Optimizer.step#AdamNoMu.step", 400, 500, id=103),
        _ev("aten::mul", 410, 420, id=104),
        _ev("cudaLaunchKernel", 412, 414, id=9004),
        _ev("aten::add", 600, 610, id=105),
        _ev("module::G.conv", 30, 60, device=True, annotation=True),
        _ev("Optimizer.step#AdamNoMu.step", 500, 510, device=True),
        _ev(NAMED["implicit_convolveNd"], 30, 60, id=9001, device=True, linked=101),
        _ev(NAMED["implicit_convolveNd"], 300, 340, id=9002, device=True, linked=102),
        _ev(NAMED["wgrad_alg0"], 340, 400, id=9003, device=True, linked=102),
        _ev(NAMED["CUDAFunctor_add"], 500, 510, id=9004, device=True, linked=104),
        _ev(NAMED["CUDAFunctor_add"], 610, 615, id=9999, device=True, linked=105),
    ]
    prof = SimpleNamespace(events=lambda: events)
    recs = profiling.attribute_kernels(prof, with_modules=True)
    assert [(r["family"], r["module"], r["us"]) for r in recs] == [
        (profiling.CONV_FWD, "G.conv", 30),
        (profiling.CONV_DGRAD, "G.conv (backward)", 40),
        (profiling.CONV_WGRAD, "G.conv (backward)", 60),
        (profiling.OPTIMIZER, None, 10),
        (profiling.ELEMENTWISE, None, 5)]


def test_profile_infer_prints_its_tables(capsys):
    res = load_script("profile_infer_torch").main(TINY + [
        "--event-frames", "4", "--store-events", "1", "--window-batch", "4",
        "--reps", "1", "--trace-reps", "1"])
    out = capsys.readouterr().out
    for head in ("## Stage times", "## The event's device time by family",
                 "## run_inference over 1 events"):
        assert head in out
    assert "#1 gauge_topk" in out and "#2 combine_table_multi" in out and "#7" in out
    assert len(res["stages"]) == 7 and all(sec > 0 for *_, sec in res["stages"])
    assert "compress and write" in out and "busy share" in out
    serving = res["serving"]
    assert list(serving["runs"]) == ["warm-up", "plain 1", "staged (loop wrapped, synchronized)",
                                     "plain 2", "profiled (torch.profiler)"]
    # every run times its setup apart from its event loop
    assert all(0 < setup < wall for wall, setup in serving["runs"].values())
    assert all(serving["seconds"][key] > 0 for key in ("config", "data", "build", "checkpoint",
                                                       "fold", "reconstruct", "write"))
    assert "**setup, run start to the event loop**" in out and "model build" in out


def test_profile_train_prints_its_tables(capsys):
    res = load_script("profile_train_torch").main(TINY + [
        "--batch", "2", "--reps", "1", "--trace-steps", "1", "--deterministic", "off"])
    out = capsys.readouterr().out
    for head in ("## Device time by family", "## The top cuDNN kernels",
                 "## The convolutions' data gradient by module"):
        assert head in out
    assert "cuDNN deterministic off" in out and res["step_s"] > 0
    assert torch.backends.cudnn.deterministic is False
    torch.backends.cudnn.deterministic = True


def test_sweep_scan_prints_its_table(capsys):
    res = load_script("sweep_torch").main(["scan"] + TINY + [
        "--event-frames", "4", "--events", "2", "--reps", "1", "--configs", "2:1,4:2"])
    out = capsys.readouterr().out
    assert "window_batch= 2 batch_events=1" in out and "window_batch= 4 batch_events=2" in out
    assert res["lines"][-1].startswith("BEST: window_batch=")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only refusal")
@pytest.mark.parametrize("argv", [["profile_infer_torch"], ["profile_train_torch"],
                                  ["roofline_train_torch"], ["sweep_torch", "scan"],
                                  ["sweep_torch", "train"]])
def test_a_script_without_a_gpu_fails_unless_told_cpu(argv):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        load_script(argv[0]).main(argv[1:])
