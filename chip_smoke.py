"""Bring-up check of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs one GPU

1. Prints the card (nvidia-smi name and power limit) and versions, then
   builds the CUDA kernels from ``p2igan_tpu_torch/csrc`` (one nvcc per source,
   in parallel).
2. Holds each kernel against its plain PyTorch version on the card and times
   both (median of CUDA-event timings):
   - at the shapes of the stis serving path (p2igan_baseline_eval.json:
     128x128, T=16, window batch 8, G=128 gauge slots, k=4):
     gauge_topk (gsel equal, gd2 bitwise, on a random 79-gauge mask and a
     tie-heavy regular grid), combine_table_multi (max abs error <= 1e-5 and
     the top gauge slot of every (z, pixel) identical), maxpool2_duplicate
     (bitwise at the three pyramid shapes);
   - at the shapes of the GAN training step (p2igan_gan_baseline_gauge.json:
     batch 12): combine_table_multi_bwd (N=12, D=16, HW=16384, G=128, k=4, on
     both masks; max abs error <= 1e-5 x max|plain|, since its sums run in
     another order) and decode_normalize_mask ((12, 16, 128, 128, 1) uint8
     with a (12, 1, 128, 128, 1) mask; bitwise against the numpy decode).
3. Serves two 64-frame 128x128 fake events through ``scripts/infer_torch.py``
   (seeded full-width generator saved as a reference-layout .pt, stride 16,
   overlap 12, window batch 8) and checks the output store, that every
   serving kernel was launched by that run, and that the card's
   reconstruction agrees with the port's plain CPU path on a 16-frame event
   (atol 1e-4 x 255).
4. Gradients: one full-width generator forward and backward at batch 12 on
   the card. Every parameter gets a finite gradient, ``input.*`` and
   ``Convsin.*`` a non-zero one, and the ``input.*`` gradients match the same
   computation with the plain versions on the card (1e-4 x max|grad|).
5. Trains the full-width stis hinge GAN (p2igan_gan_baseline_gauge.json:
   base 64, T=16, 128x128, batch 12) through ``scripts/train_torch.py`` on a
   fake train store, once with ``device_decode`` off and once on: 5 warm-up
   steps, then 10 timed steps; checks finite losses, ``latest.ckpt``, a
   resume that continues, and that the run launched every kernel of the
   training path. Prints GAN steps/s with the card's name and power limit.
6. p2igan on per-sample ``sti`` masks (the shipped eval and GAN configs with
   ``mask.type`` set to ``sti``; their ``block_sizes: [10]`` gives 169 gauges a
   mask in 256 gauge slots), where nothing is hoisted and every sample selects
   from its own gauges:
   - the per-sample combine (combine_table), its backward (combine_table_bwd)
     and the dense-field combine (combine_dense) against their plain versions
     at the training shape (B=12, D=16, G=256, HW=16384), the serving shape
     (B=8) and the reference default block size 4 (1024 gauges, G=1152): the
     two forwards bitwise, the backward within 1e-5 x max|plain|;
   - the batched gauge top-k (12 or 8 masks a launch) against single-mask
     launches, its plain version and the CPU path, bitwise, with the slot
     geometry on the device against the host's numpy, bitwise and timed;
   - ``idw_3d_factored`` on one full-size window, forward and backward,
     against the CPU path;
   - the two events served through ``scripts/infer_torch.py`` under the masks
     the loader draws (launch counts asserted: gauge_topk and combine_table
     twice an event, combine_table_multi never), and 2 x 16 frames under two
     masks as one mixed window stream against the CPU path (1e-4 x 255);
   - the generator's gradients at batch 12 under 12 masks, ``input.*``
     against the plain versions;
   - 15 hinge-GAN steps at batch 12 through ``scripts/train_torch.py`` with
     ``device_decode`` off and on (launch counts asserted: #1, #5, #6 once a
     step), and a 6-step resume whose last 4 steps are profiled (idle share,
     the share of #1 + #5 + #6 in the device time).
7. The dk and stdk families at full width (128x128, T=16, hidden 100,
   K_s=139, K_t=44, the 79-gauge stis mask, seeded weights):
   - the fused MLP tail (mlp_tail_fused, J=128 and J=192) and its backward
     (mlp_tail_bwd, J=192) against their plain versions on the card and a
     float64 plain version: forward within 1e-5 x max|plain|, dphi and doff
     within 1e-4 x max|plain|, the weight and bias gradients (sums of
     J*HW = 3.1e6 terms in another order) within 1e-3 x max|plain|; the
     forward's plain version is the chain of three ``torch.matmul`` products,
     so its time is also printed as ``cublas_chain_ms``;
   - times the host input pipeline alone on the training store (windows/s);
   - serves the two fake events through ``scripts/infer_torch.py`` with
     ``dk_gauge.json`` and ``stdk_gauge.json``, checks the stores, the launch
     count and a 16-frame event against the port's plain CPU path;
   - trains both configs through ``scripts/train_torch.py`` (batch 12, 15
     steps cut from 200000 iterations, rec-loss only): launch counts of both
     kernels equal to the steps (plus the validation forwards), every
     parameter's last gradient finite and non-zero, and a 6-step resume whose
     last 4 steps run under ``torch.profiler`` (idle share, time by kernel).
8. The simple family at full width (base 64, T=16, 128x128, seeded weights,
   BatchNorm statistics away from identity; the shipped p2igan configs with
   ``model`` set to ``{"name": "simple", "in_channels": 1, "base_channels":
   64}``):
   - the fused enc0 convolution (enc0_conv3d_leaky, Cin 2 -> 64) and the fused
     dec2 convolution (conv3d_cout1_sigmoid, 64 -> 1) against their plain
     versions (``F.conv3d`` + activation) at the serving chunk (B=8) and at an
     odd shape: |kernel - plain| <= 5e-6 + 1e-5 |plain| (summation order over
     1.3e8 outputs; whether 1e-6 held is printed); both sides' distance to a
     float64 plain version; the cuDNN chain timed as ``library_ms``; and the
     neighbouring cuDNN layers timed in both 5-D memory formats;
   - serves the two fake events through ``scripts/infer_torch.py`` with both
     kernels (2 launches of each an event) and once with dec2 through cuDNN
     (``model.dec2_fused`` false), each against the port's plain CPU path;
   - trains 15 rec-loss steps and 15 hinge-GAN steps (against the simple
     BatchNorm critic) at batch 12 through ``scripts/train_torch.py``: every
     parameter's last gradient finite and non-zero, running statistics moved,
     peak device memory, then a 6-step resume whose last 4 steps run under
     ``torch.profiler``.
9. Prints the card, a JSON line of the twelve kernels (time, plain version's
   time, the bound from this run's shapes and what sets it, the library
   chain's time where there is one, launches on the kernel's main path), then
   ``{"ok": true, "device": ...}`` as the last line. Any failed check exits
   non-zero without that line.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from p2igan_tpu_torch.config import load_config
from p2igan_tpu_torch.data import fake, zarrlite
from p2igan_tpu_torch.data.datamodule import P2IDataModule
from p2igan_tpu_torch.data.masks import create_mask_np
from p2igan_tpu_torch.data.stores import store_compressor
from p2igan_tpu_torch.inference.driver import (SlidingWindowReconstructor,
                                               load_generator, set_precision_policy)
from p2igan_tpu_torch.losses import reconstruction_loss
from p2igan_tpu_torch.models import (DKGenerator, P2IGenerator, SimpleGenerator,
                                     STDKGenerator)
from p2igan_tpu_torch.ops import cuda_lib, idw_factored_kernel, layers
from p2igan_tpu_torch.ops.dk_mlp_kernel import (mlp_tail_bwd, mlp_tail_bwd_reference,
                                                mlp_tail_fused, mlp_tail_reference)
from p2igan_tpu_torch.ops.decode_mask import (decode_normalize_mask,
                                              decode_normalize_mask_reference)
from p2igan_tpu_torch.ops.dec2_stencil import (conv3d_cout1_sigmoid,
                                               conv3d_cout1_sigmoid_reference)
from p2igan_tpu_torch.ops.doconv import make_d_diag
from p2igan_tpu_torch.ops.enc0_conv import (enc0_conv3d_leaky,
                                            enc0_conv3d_leaky_reference)
from p2igan_tpu_torch.ops.idw import (factored_prepare, factored_prepare_full,
                                      gauge_geometry, idw_3d_factored)
from p2igan_tpu_torch.ops.idw_factored_kernel import (
    combine_dense, combine_dense_reference, combine_table, combine_table_bwd,
    combine_table_bwd_reference, combine_table_multi, combine_table_multi_bwd,
    combine_table_multi_bwd_reference, combine_table_multi_reference,
    combine_table_reference, gauge_topk, gauge_topk_reference)
from p2igan_tpu_torch.ops.pool_dup import (maxpool2_duplicate,
                                           maxpool2_duplicate_reference)
from p2igan_tpu_torch.ops.wendland import build_phi_space
from p2igan_tpu_torch.training.trainer import device_busy_us

REPO = Path(__file__).resolve().parent
CONFIGS = REPO / "p2igan_tpu_torch" / "config"
CONFIG = CONFIGS / "p2igan_baseline_eval.json"
TRAIN_CONFIG = CONFIGS / "p2igan_gan_baseline_gauge.json"
STI_TRAIN_CONFIG = CONFIGS / "p2igan_gan_baseline.json"
DK_FAMILY = {"dk": (DKGenerator, CONFIGS / "dk_gauge.json"),
             "stdk": (STDKGenerator, CONFIGS / "stdk_gauge.json")}
SEED = 2024
H = W = 128
LENGTH, BASE, NUM_RES, WINDOW_BATCH, G, K = 16, 64, 4, 8, 128, 4
EVENTS, EVENT_FRAMES = 2, 64
TRAIN_BATCH, TRAIN_EVENTS, WARMUP_STEPS, TIMED_STEPS = 12, 5, 5, 10
HIDDEN, VISIBLE_K = 100, 79
# sti: one gauge a block. The shipped block size 10 gives 169 gauges a mask and
# 256 gauge slots; the reference default 4 gives 1024 gauges and 1152 slots
STI_BLOCK, STI_G, STI_DENSE_BLOCK, STI_DENSE_G = 10, 256, 4, 1152
# (label, masks a launch, block size, gauge slots) of the sti kernel checks
STI_SHAPES = (("train", TRAIN_BATCH, STI_BLOCK, STI_G),
              ("serve", WINDOW_BATCH, STI_BLOCK, STI_G),
              ("block 4", TRAIN_BATCH, STI_DENSE_BLOCK, STI_DENSE_G))
# H100 SXM data sheet: device memory rate and the float32 rate outside the
# tensor cores (the precision policy keeps TF32 off)
PEAK_BYTES_PER_S, PEAK_FLOPS = 3.35e12, 67e12
POOL_SHAPES = [(WINDOW_BATCH, BASE, H, W), (WINDOW_BATCH, 2 * BASE, H // 2, W // 2),
               (WINDOW_BATCH, 4 * BASE, H // 4, W // 4)]
KERNELS = {
    "gauge_topk": (gauge_topk, "p2igan_tpu_torch/csrc/gauge_topk.cu",
                   "p2igan_tpu/ops/pallas/idw_factored_kernel.py:678"),
    "combine_table_multi": (combine_table_multi,
                            "p2igan_tpu_torch/csrc/combine_table_multi.cu",
                            "p2igan_tpu/ops/pallas/idw_factored_kernel.py:351"),
    "maxpool2_duplicate": (maxpool2_duplicate, "p2igan_tpu_torch/csrc/pool_dup.cu",
                           "p2igan_tpu/ops/pallas/pool_dup.py:42"),
    "combine_table_multi_bwd": (combine_table_multi_bwd,
                                "p2igan_tpu_torch/csrc/combine_table_multi_bwd.cu",
                                "p2igan_tpu/ops/pallas/idw_factored_kernel.py:539"),
    "combine_table": (combine_table, "p2igan_tpu_torch/csrc/combine_table.cu",
                      "p2igan_tpu/ops/pallas/idw_factored_kernel.py:259"),
    "combine_table_bwd": (combine_table_bwd,
                          "p2igan_tpu_torch/csrc/combine_table_bwd.cu",
                          "p2igan_tpu/ops/pallas/idw_factored_kernel.py:444"),
    "combine_dense": (combine_dense, "p2igan_tpu_torch/csrc/combine_dense.cu",
                      "p2igan_tpu/ops/pallas/idw_factored_kernel.py:185"),
    "decode_normalize_mask": (decode_normalize_mask,
                              "p2igan_tpu_torch/csrc/decode_mask.cu",
                              "p2igan_tpu/ops/pallas/decode_mask.py:53"),
    "mlp_tail_fused": (mlp_tail_fused, "p2igan_tpu_torch/csrc/dk_mlp_tail.cu",
                       "p2igan_tpu/ops/pallas/dk_mlp_kernel.py:89"),
    "mlp_tail_bwd": (mlp_tail_bwd, "p2igan_tpu_torch/csrc/dk_mlp_tail_bwd.cu",
                     "p2igan_tpu/ops/pallas/dk_mlp_kernel.py:225"),
    "enc0_conv3d_leaky": (enc0_conv3d_leaky, "p2igan_tpu_torch/csrc/enc0_conv.cu",
                          "p2igan_tpu/ops/pallas/enc0_conv.py:106"),
    "conv3d_cout1_sigmoid": (conv3d_cout1_sigmoid,
                             "p2igan_tpu_torch/csrc/dec2_stencil.cu",
                             "p2igan_tpu/ops/pallas/dec2_stencil.py:105"),
}
SERVING_KERNELS = ("gauge_topk", "combine_table_multi", "maxpool2_duplicate")
STI_SERVING_KERNELS = ("gauge_topk", "combine_table", "maxpool2_duplicate")
# the path whose launch count each kernel reports in the kernels line
LAUNCH_PATH = {"combine_table": "p2igan sti training",
               "combine_table_bwd": "p2igan sti training",
               "combine_dense": "idw_3d_factored op",
               "mlp_tail_fused": "dk training", "mlp_tail_bwd": "dk training",
               "enc0_conv3d_leaky": "simple serving",
               "conv3d_cout1_sigmoid": "simple serving"}
SIMPLE_MODEL = {"name": "simple", "in_channels": 1, "base_channels": BASE}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    the float32 rate, whichever is larger. No single PyTorch call computes
    the function of a kernel that uses this default, so ``library_ms`` is null
    there; the two fused convolutions set it to their cuDNN chain's time."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}


def reset_launches() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def gauge_masks(dev):
    rng = np.random.default_rng(SEED)
    flat = np.zeros((H * W,), np.float32)
    flat[rng.choice(H * W, 79, replace=False)] = 1.0
    grid = np.zeros((H, W), np.float32)
    grid[8::16, 8::16] = 1.0  # 64 gauges on a regular grid: ties everywhere
    return {"random79": torch.from_numpy(flat.reshape(H, W)).to(dev),
            "grid64": torch.from_numpy(grid).to(dev)}


def check_gauge_topk(masks) -> dict:
    err, ms, plain_ms = 0.0, None, None
    for name, mask in masks.items():
        args = gauge_geometry(mask, G)[:5]
        gd2_k, gsel_k = gauge_topk(*args, k=K)
        gd2_p, gsel_p = gauge_topk_reference(*args, k=K)
        torch.cuda.synchronize()
        if not torch.equal(gsel_k, gsel_p):
            fail(f"gauge_topk gsel differs on {name}: "
                 f"{int((gsel_k != gsel_p).sum())} slots")
        if not bitwise_equal(gd2_k, gd2_p):
            fail(f"gauge_topk gd2 not bitwise equal on {name}")
        err = max(err, float((gd2_k - gd2_p).abs().max()))
        k_ms = cuda_ms(lambda: gauge_topk(*args, k=K))
        p_ms = cuda_ms(lambda: gauge_topk_reference(*args, k=K))
        print(f"gauge_topk[{name}] HW={H * W} G={G} k={K}: equal; "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        if ms is None:
            ms, plain_ms = k_ms, p_ms
    # two coordinates a pixel and three numbers a slot in, k distances and k
    # slot ids a pixel out; 6 flops a (pixel, slot) distance, a k-round scan
    hw = H * W
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound(4 * (2 * hw + 3 * G + 2 * K * hw), hw * G * (6 + K))}


def check_combine(masks, dev) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    tables = torch.randn((WINDOW_BATCH, LENGTH, G), generator=gen).to(dev)
    onehot = torch.eye(G, device=dev)[:, None, :].expand(G, LENGTH, G).contiguous()
    err, ms, plain_ms = 0.0, None, None
    for name, mask in masks.items():
        gd2, gsel, _ = factored_prepare_full(mask, G, k=K)
        gd2_t, gsel_t = gd2.t().contiguous(), gsel.t().contiguous()
        out_k = combine_table_multi(gd2_t, gsel_t, tables, K)
        out_p = combine_table_multi_reference(gd2_t, gsel_t, tables, K)
        e = float((out_k - out_p).abs().max())
        if not e <= 1e-5:
            fail(f"combine_table_multi max abs err {e} > 1e-5 on {name}")
        # window n holds the indicator of gauge slot n, so out[n, z, p] is the
        # total weight slot n got at (z, p); the argmax is the top slot
        arg_k = combine_table_multi(gd2_t, gsel_t, onehot, K).argmax(0)
        arg_p = combine_table_multi_reference(gd2_t, gsel_t, onehot, K).argmax(0)
        if not torch.equal(arg_k, arg_p):
            fail(f"combine_table_multi selected slots differ on {name}: "
                 f"{int((arg_k != arg_p).sum())} of {arg_k.numel()}")
        err = max(err, e)
        k_ms = cuda_ms(lambda: combine_table_multi(gd2_t, gsel_t, tables, K))
        p_ms = cuda_ms(lambda: combine_table_multi_reference(gd2_t, gsel_t, tables, K),
                       reps=5)
        print(f"combine_table_multi[{name}] N={WINDOW_BATCH} D={LENGTH} "
              f"HW={H * W} k={K}: max abs err {e:.3e}, bitwise "
              f"{bitwise_equal(out_k, out_p)}, top slots equal; "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        if ms is None:
            ms, plain_ms = k_ms, p_ms
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **combine_bound(WINDOW_BATCH)}


def combine_bound(n: int) -> dict:
    """Forward and backward of the combine move the same bytes: the (k, HW)
    distances and slots, the (N, D, G) tables and the (N, D, HW) field. Per
    (z, pixel): kf*k = 20 candidate distances (8 flops with the sqrt and the
    weight), k selection rounds over them, and 2 k flops a window."""
    hw, cand = H * W, 5 * K
    return bound(4 * (2 * K * hw + n * LENGTH * G + n * LENGTH * hw),
                 LENGTH * hw * (cand * 8 + K * cand + 2 * K * n))


def check_pool_dup(dev) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    ms = plain_ms = 0.0
    for shape in POOL_SHAPES:
        x = torch.randn(shape, generator=gen).to(dev)
        out_k, out_p = maxpool2_duplicate(x), maxpool2_duplicate_reference(x)
        if not bitwise_equal(out_k, out_p):
            fail(f"maxpool2_duplicate not bitwise equal at {shape}")
        k_ms = cuda_ms(lambda: maxpool2_duplicate(x))
        p_ms = cuda_ms(lambda: maxpool2_duplicate_reference(x))
        gbs = 4 * (x.numel() + out_k.numel()) / (k_ms * 1e-3) / 1e9
        print(f"maxpool2_duplicate{shape}: bitwise equal; kernel {k_ms:.4f} ms "
              f"({gbs:.0f} GB/s), plain {p_ms:.4f} ms")
        ms += k_ms
        plain_ms += p_ms
    # the input once, the output (half as many elements) once; 3 compares
    elems = sum(int(np.prod(shape)) for shape in POOL_SHAPES)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            **bound(4 * elems * 1.5, elems * 0.75)}


def check_combine_bwd(masks) -> dict:
    """Kernel #4 at the training shapes: N=12 windows, D=16, HW=16384."""
    gen = torch.Generator().manual_seed(SEED)
    err, ms, plain_ms = 0.0, None, None
    for name, mask in masks.items():
        gd2, gsel, _ = factored_prepare_full(mask, G, k=K)
        gd2_t, gsel_t = gd2.t().contiguous(), gsel.t().contiguous()
        g = torch.randn((TRAIN_BATCH, LENGTH, H * W), generator=gen).to(mask.device)
        out_k = combine_table_multi_bwd(gd2_t, gsel_t, g, G, K)
        out_p = combine_table_multi_bwd_reference(gd2_t, gsel_t, g, G, K)
        e = float((out_k - out_p).abs().max())
        scale = float(out_p.abs().max())
        if not (scale > 0 and e <= 1e-5 * scale):
            fail(f"combine_table_multi_bwd max abs err {e} > 1e-5 x {scale} on {name}")
        err = max(err, e)
        k_ms = cuda_ms(lambda: combine_table_multi_bwd(gd2_t, gsel_t, g, G, K))
        p_ms = cuda_ms(lambda: combine_table_multi_bwd_reference(gd2_t, gsel_t, g, G, K),
                       reps=5)
        print(f"combine_table_multi_bwd[{name}] N={TRAIN_BATCH} D={LENGTH} "
              f"HW={H * W} G={G} k={K}: max abs err {e:.3e} "
              f"({e / scale:.2e} x max|plain| {scale:.3f}); "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        if ms is None:
            ms, plain_ms = k_ms, p_ms
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **combine_bound(TRAIN_BATCH)}


def check_decode(dev) -> dict:
    """Kernel #11 at the training batch, bitwise against the numpy decode of
    the host pipeline (p2igan_tpu/data/stores.py:246)."""
    rng = np.random.default_rng(SEED)
    u8 = rng.integers(0, 256, (TRAIN_BATCH, LENGTH, H, W, 1), dtype=np.uint8)
    mask = (rng.random((TRAIN_BATCH, 1, H, W, 1)) < 0.3).astype(np.uint8)
    video_np = u8.astype(np.float32) / 255.0
    masked_np = video_np * mask.astype(np.float32)
    u8_d, mask_d = torch.from_numpy(u8).to(dev), torch.from_numpy(mask).to(dev)
    for label, fn in (("kernel", decode_normalize_mask),
                      ("plain", decode_normalize_mask_reference)):
        video, masked = (t.cpu().numpy() for t in fn(u8_d, mask_d))
        if not (np.array_equal(video.view(np.int32), video_np.view(np.int32))
                and np.array_equal(masked.view(np.int32), masked_np.view(np.int32))):
            fail(f"decode_normalize_mask ({label}) is not bitwise equal to the "
                 f"numpy decode")
    k_ms = cuda_ms(lambda: decode_normalize_mask(u8_d, mask_d))
    p_ms = cuda_ms(lambda: decode_normalize_mask_reference(u8_d, mask_d))
    gbs = (u8.size * 9 + mask.size) / (k_ms * 1e-3) / 1e9
    print(f"decode_normalize_mask{u8.shape} mask {mask.shape}: bitwise equal to "
          f"numpy (kernel and plain); kernel {k_ms:.4f} ms ({gbs:.0f} GB/s), "
          f"plain {p_ms:.4f} ms")
    # a byte and (once per plane) a mask byte in, two floats out; 2 flops
    return {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
            **bound(u8.size * 9 + mask.size, u8.size * 2)}


# -- the per-sample (sti) factored IDW ----------------------------------------

def sti_masks(dev, batch: int, block: int, seed: int = SEED) -> torch.Tensor:
    """(batch, H, W) sti masks, one observed pixel a block, as the loaders draw
    them: a jittered grid, full of integer-offset distance ties."""
    rng = np.random.default_rng(seed)
    masks = [create_mask_np((1, H, W, 1), rng, "sti", block_sizes=[block])[0, :, :, 0]
             for _ in range(batch)]
    return torch.from_numpy(np.stack(masks)).to(dev)


def gauge_geometry_host(mask_xy: torch.Tensor, max_gauges: int):
    """The slot geometry of one (H, W) mask in numpy on the host, from a mask
    on the card: a device-to-host copy (a sync), nonzero, idx/(N-1), and the
    upload. What ``gauge_geometry`` computes on the device is held against it
    bit for bit, and timed against it."""
    hw = H * W
    (obs,) = np.nonzero(mask_xy.detach().cpu().numpy().reshape(-1) > 0)
    gidx = np.full((max_gauges,), hw, dtype=np.int64)
    n = min(len(obs), max_gauges)
    gidx[:n] = obs[:n]
    safe = np.minimum(gidx, hw - 1)
    gy = (safe // W).astype(np.float32) / np.float32(H - 1)
    gx = (safe % W).astype(np.float32) / np.float32(W - 1)
    pen = np.where(gidx < hw, np.float32(0), np.float32(1e30)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(mask_xy.device) for a in (gx, gy, pen, safe))


def check_gauge_topk_batched(dev) -> None:
    """Kernel #1 on the sti paths: B masks a launch. The slot geometry on the
    device equals the host's numpy bit for bit; the batched launch equals B
    single-mask launches, the plain version and the CPU path bit for bit; and
    one launch is timed against B launches and against the host geometry."""
    for label, batch, block, slots in STI_SHAPES:
        masks = sti_masks(dev, batch, block)
        geo = gauge_geometry(masks, slots)
        for b in range(batch):
            host = gauge_geometry_host(masks[b], slots)
            if not all(torch.equal(d[b], h) for d, h in zip(geo[2:], host)):
                fail(f"gauge_geometry on the device differs from the host's ({label}, {b})")
        args = geo[:5]
        gd2, gsel = gauge_topk(*args, k=K)
        rd2, rsel = gauge_topk_reference(*args, k=K)
        singles = [gauge_topk(args[0], args[1], *(a[b] for a in args[2:]), k=K)
                   for b in range(batch)]
        torch.cuda.synchronize()
        if not (torch.equal(gsel, rsel) and bitwise_equal(gd2, rd2)):
            fail(f"batched gauge_topk differs from its plain version ({label})")
        if not all(torch.equal(gsel[b], s[1]) and bitwise_equal(gd2[b], s[0])
                   for b, s in enumerate(singles)):
            fail(f"batched gauge_topk differs from single-mask launches ({label})")
        card = factored_prepare_full(masks, slots, k=K)
        cpu = factored_prepare_full(masks.cpu(), slots, k=K)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)):
            fail(f"gd2/gsel on the card differ from the CPU path ({label})")
        n_gauges = int((masks > 0).sum(dim=(1, 2)).max())
        one_ms = cuda_ms(lambda: gauge_topk(*args, k=K))
        loop_ms = cuda_ms(lambda: [gauge_topk(args[0], args[1], *(a[b] for a in args[2:]),
                                              k=K) for b in range(batch)])
        plain_ms = cuda_ms(lambda: gauge_topk_reference(*args, k=K), reps=3, warmup=1)
        geo_ms = cuda_ms(lambda: gauge_geometry(masks, slots))
        t0 = time.perf_counter()
        for _ in range(5):
            for b in range(batch):
                gauge_geometry_host(masks[b], slots)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        hw = H * W
        b_ = bound(4 * (2 * hw + 3 * batch * slots + 2 * K * batch * hw),
                   batch * hw * slots * (6 + K))
        print(f"gauge_topk[sti {label}] B={batch} masks, {n_gauges} gauges in G={slots} "
              f"slots: equal to the plain version, to {batch} single launches and to "
              f"the CPU path (bitwise); one launch {one_ms:.4f} ms, {batch} launches "
              f"{loop_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_['bound_ms']:.5f} ms "
              f"({b_['bound_by']}); slot geometry on the device {geo_ms:.4f} ms, on the "
              f"host (copy, numpy, upload; {batch} masks) {host_ms:.4f} ms")


def sample_combine_bound(batch: int, slots: int) -> dict:
    """Forward and backward of the per-sample combine move the same bytes:
    (B, k, HW) distances and slots, (B, D, G) tables, the (B, D, HW) field.
    Per (sample, z, pixel): kf*k = 20 candidate distances (8 flops with the
    sqrt and the weight), k selection rounds over them, 2 k flops of values."""
    hw, cand = H * W, 5 * K
    return bound(4 * batch * (2 * K * hw + LENGTH * slots + LENGTH * hw),
                 batch * LENGTH * hw * (cand * 8 + K * cand + 2 * K))


def sti_selection(dev, batch, block, slots):
    gd2, gsel, _ = factored_prepare_full(sti_masks(dev, batch, block), slots, k=K)
    return gd2.transpose(1, 2).contiguous(), gsel.transpose(1, 2).contiguous()


def check_combine_table(dev) -> dict:
    """Kernel #5 at the training shape (B=12, G=256), the serving shape (B=8)
    and the reference default block size (G=1152): bitwise equal to its plain
    version (all D frames, no pruning). The kernels line reports the first."""
    gen = torch.Generator().manual_seed(SEED)
    result = {}
    for label, batch, block, slots in STI_SHAPES:
        gd2_t, gsel_t = sti_selection(dev, batch, block, slots)
        tables = torch.randn((batch, LENGTH, slots), generator=gen).to(dev)
        out_k = combine_table(gd2_t, gsel_t, tables, K)
        out_p = combine_table_reference(gd2_t, gsel_t, tables, K)
        torch.cuda.synchronize()
        e = float((out_k - out_p).abs().max())
        if not bitwise_equal(out_k, out_p):
            fail(f"combine_table not bitwise equal to its plain version ({label}): "
                 f"max abs err {e}")
        k_ms = cuda_ms(lambda: combine_table(gd2_t, gsel_t, tables, K))
        p_ms = cuda_ms(lambda: combine_table_reference(gd2_t, gsel_t, tables, K),
                       reps=3, warmup=1)
        b_ = sample_combine_bound(batch, slots)
        print(f"combine_table[{label}] B={batch} D={LENGTH} HW={H * W} G={slots} k={K}: "
              f"bitwise equal; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_['bound_ms']:.5f} ms ({b_['bound_by']})")
        if not result:
            result = {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, **b_}
    return result


def check_combine_table_bwd(dev) -> dict:
    """Kernel #6 at the same three shapes: max abs error <= 1e-5 x max|plain|
    (shared-memory atomics and per-block partials sum in another order than
    autograd of the plain version); whether two runs agree bitwise is printed
    (the atomics take no fixed order)."""
    gen = torch.Generator().manual_seed(SEED + 1)
    result = {}
    for label, batch, block, slots in STI_SHAPES:
        gd2_t, gsel_t = sti_selection(dev, batch, block, slots)
        g = torch.randn((batch, LENGTH, H * W), generator=gen).to(dev)
        out_k = combine_table_bwd(gd2_t, gsel_t, g, slots, K)
        out_p = combine_table_bwd_reference(gd2_t, gsel_t, g, slots, K)
        again = combine_table_bwd(gd2_t, gsel_t, g, slots, K)
        torch.cuda.synchronize()
        e, scale = float((out_k - out_p).abs().max()), float(out_p.abs().max())
        if not (out_k.shape == out_p.shape and scale > 0 and e <= 1e-5 * scale):
            fail(f"combine_table_bwd max abs err {e} > 1e-5 x {scale} ({label})")
        k_ms = cuda_ms(lambda: combine_table_bwd(gd2_t, gsel_t, g, slots, K))
        p_ms = cuda_ms(lambda: combine_table_bwd_reference(gd2_t, gsel_t, g, slots, K),
                       reps=3, warmup=1)
        b_ = sample_combine_bound(batch, slots)
        print(f"combine_table_bwd[{label}] B={batch} D={LENGTH} HW={H * W} G={slots} "
              f"k={K}: max abs err {e:.3e} ({e / scale:.2e} x max|plain| {scale:.3f}), "
              f"repeats bitwise: {bitwise_equal(out_k, again)}; kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_['bound_ms']:.5f} ms ({b_['bound_by']})")
        if not result:
            result = {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, **b_}
    return result


def check_combine_dense(dev) -> dict:
    """Kernel #7: one (16, 128, 128) window, its candidate values gathered from
    the dense field, under a block-10 and a block-4 sti mask: bitwise equal to
    its plain version. Bytes: gd2 (k, HW) and cvals (D*k, HW) in, (D, HW) out."""
    gen = torch.Generator().manual_seed(SEED + 2)
    hw, cand = H * W, 5 * K
    result = {}
    for block, slots in ((STI_BLOCK, STI_G), (STI_DENSE_BLOCK, STI_DENSE_G)):
        mask = sti_masks(dev, 1, block)[0]
        values = torch.randn((LENGTH, hw), generator=gen).to(dev)
        gd2, gpix = factored_prepare(mask, slots, k=K)
        gd2_t = gd2.t().contiguous()
        cvals_t = values[:, gpix.long()].permute(0, 2, 1).reshape(LENGTH * K, hw).contiguous()
        out_k = combine_dense(gd2_t, cvals_t, K)
        out_p = combine_dense_reference(gd2_t, cvals_t, K)
        torch.cuda.synchronize()
        e = float((out_k - out_p).abs().max())
        if not bitwise_equal(out_k, out_p):
            fail(f"combine_dense not bitwise equal to its plain version (block {block}): "
                 f"max abs err {e}")
        k_ms = cuda_ms(lambda: combine_dense(gd2_t, cvals_t, K))
        p_ms = cuda_ms(lambda: combine_dense_reference(gd2_t, cvals_t, K), reps=5)
        b_ = bound(4 * hw * (K + LENGTH * K + LENGTH),
                   LENGTH * hw * (cand * 8 + K * cand + 2 * K))
        print(f"combine_dense[block {block}] D={LENGTH} HW={hw} k={K}: bitwise equal; "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_['bound_ms']:.5f} ms "
              f"({b_['bound_by']})")
        if not result:
            result = {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, **b_}
    return result


def run_idw_3d_factored(dev) -> dict:
    """The path of kernel #7: ``idw_3d_factored`` (no model calls it, in either
    package) on one full-size window under a block-10 sti mask, forward and
    backward. The card's field equals the CPU path's bit for bit, its gradient
    to the values (autograd of the plain version, on the card) within 1e-5 x
    max."""
    mask = sti_masks(dev, 1, STI_BLOCK, seed=SEED + 3)[0]
    gen = torch.Generator().manual_seed(SEED + 3)
    values = torch.randn((LENGTH, H, W), generator=gen)
    cot = torch.randn((LENGTH, H, W), generator=gen)
    outs = {}
    for d in ("cpu", dev):
        field = values.to(d).detach().requires_grad_(True)
        if d == dev:
            reset_launches()
        out = idw_3d_factored(mask.to(d), field, STI_G, k=K)
        if out.grad_fn is None:
            fail("idw_3d_factored's output carries no grad_fn")
        out.backward(cot.to(d))
        outs[str(d)] = (out.detach().cpu(), field.grad.cpu())
    torch.cuda.synchronize()
    launches = read_launches()
    (o_c, g_c), (o_d, g_d) = outs["cpu"], outs[str(dev)]
    e_g, scale = float((g_c - g_d).abs().max()), float(g_c.abs().max())
    if not (bitwise_equal(o_c, o_d) and scale > 0 and e_g <= 1e-5 * scale):
        fail(f"idw_3d_factored on the card differs from the CPU path: field max abs err "
             f"{float((o_c - o_d).abs().max())}, gradient {e_g} vs max {scale}")
    if (launches["gauge_topk"], launches["combine_dense"]) != (1, 1):
        fail(f"idw_3d_factored launched {launches}")
    print(f"idw_3d_factored ({LENGTH}, {H}, {W}), G={STI_G}: field bitwise equal to the "
          f"CPU path, gradient within {e_g / scale:.2e} x max; launches {launches}")
    return launches


def write_serving_tree(tmp: Path) -> Path:
    """Fake test store, gauge mask, seeded full-width .pt and a config."""
    compressor = store_compressor()
    print(f"zarr codec: {compressor['id']}")
    rng = np.random.default_rng(SEED)
    store = zarrlite.open_group(tmp / "test_events.zarr", mode="w")
    for i in range(EVENTS):
        frames = fake.synthesize_event(rng, EVENT_FRAMES, H, W).astype(np.float32)
        store.create_dataset(f"event_{i + 1:02d}", shape=frames.shape,
                             chunks=frames.shape, dtype="float32", data=frames,
                             compressor=compressor)
    mask = fake.write_gauge_mask(tmp / "masks" / "gauge_mask_128.txt", H=H, W=W,
                                 n_gauges=79, seed=SEED)
    gen = P2IGenerator(H=H, W=W, length=LENGTH, num_res=NUM_RES, base_channels=BASE,
                       generator=torch.Generator().manual_seed(SEED))
    state = gen.state_dict()
    for key, val in list(state.items()):  # reference checkpoints carry D_diag
        if key.endswith(".D"):
            state[key[:-1] + "D_diag"] = torch.from_numpy(
                make_d_diag(val.shape[0], 3, 3, val.shape[2]))
    torch.save(state, tmp / "P2IGAN_seeded.pt")
    cfg = load_config(CONFIG)
    cfg["save_dir"] = str(tmp / "weights")
    cfg["data"]["train"]["data_root"] = str(tmp / "nimrod_train.zarr")  # unread
    for split in ("train", "test"):
        cfg["data"][split]["mask"]["file"] = str(mask)
    cfg["data"]["test"]["data_root"] = str(tmp / "test_events.zarr")
    cfg_path = tmp / "eval.json"
    cfg_path.write_text(json.dumps(cfg))
    return cfg_path


def load_script(name: str):
    """A CLI of ``scripts/`` as a module, to call its ``main`` as a user would."""
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def serve(tmp: Path, cfg_path: Path, checkpoint: Path, model: str,
          required=SERVING_KERNELS) -> tuple:
    infer_torch = load_script("infer_torch")

    def argv(out):
        return infer_torch.parse_args([
            "--config", str(cfg_path), "--checkpoint", str(checkpoint),
            "--output", str(tmp / out), "--stride", "16", "--overlap", "12",
            "--window-batch", str(WINDOW_BATCH), "--device", "cuda",
            "--overwrite", "--log-level", "WARNING"])

    t0 = time.perf_counter()
    infer_torch.main(argv(f"warmup_{model}.zarr"))
    torch.cuda.synchronize()
    print(f"{model} serving warm-up run (CUDA context, libraries, kernel load): "
          f"{time.perf_counter() - t0:.3f} s")
    reset_launches()
    t0 = time.perf_counter()
    out = infer_torch.main(argv(f"served_{model}.zarr"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    print(f"{model}: served {EVENTS} events x {EVENT_FRAMES} frames in {seconds:.3f} s: "
          f"{EVENTS / seconds:.3f} events/s end to end (store read, "
          f"reconstruction, zarr write); launches {launches}")
    store = zarrlite.open(out, mode="r")
    if store.array_keys() != [f"event_{i + 1:02d}" for i in range(EVENTS)]:
        fail(f"output events {store.array_keys()}")
    for key in store.array_keys():
        ev = store[key][:]
        if ev.shape != (EVENT_FRAMES, H, W, 1):
            fail(f"{key} has shape {ev.shape}")
        if not np.isfinite(ev).all() or ev.min() < 0.0:
            fail(f"{key} is not finite and >= 0")
    for name in required:
        if launches[name] <= 0:
            fail(f"the {model} serving run launched no {name} kernel")
    return launches, EVENTS / seconds


def check_against_cpu(tmp: Path, cfg_path: Path, checkpoint: Path, model: str,
                      dev) -> None:
    """One 16-frame event: the card's path (kernels) vs the port's plain CPU
    path, same weights, at the reconstruction tolerance 1e-4 x 255."""
    cfg = load_config(cfg_path)
    ev = zarrlite.open(tmp / "test_events.zarr", mode="r")["event_01"][:LENGTH]
    ev = ev[..., None].astype(np.float32) / 255.0
    mask = np.loadtxt(cfg["data"]["test"]["mask"]["file"]).astype(np.float32)
    masks = np.broadcast_to(mask[None, :, :, None], ev.shape).astype(np.float32)
    masked = ev * masks
    outs = {}
    for d in ("cpu", dev):
        gen = load_generator(cfg, checkpoint, torch.device(d))
        recon = SlidingWindowReconstructor(gen, stride=16, overlap=12, window_batch=4)
        outs[str(d)] = recon(masked, masks)
    err = float(np.abs(outs["cpu"] - outs[str(dev)]).max())
    print(f"{model}: 16-frame event, card vs plain CPU path: max abs err {err:.4e} "
          f"(x255 scale), max value {outs['cpu'].max():.3f}")
    if not (np.isfinite(outs[str(dev)]).all() and err <= 1e-4 * 255.0):
        fail(f"{model}: card reconstruction differs from the CPU path by {err}")
    if not outs["cpu"].max() > 1.0:
        fail(f"{model}: the reconstruction is degenerate (max {outs['cpu'].max()})")


@contextlib.contextmanager
def plain_versions():
    """Route the generator through the plain versions of the combines and the
    pool (the modules look them up at call time), e.g. on the card."""
    saved = (idw_factored_kernel.combine_table_multi, idw_factored_kernel.combine_table,
             layers.maxpool2_duplicate)
    idw_factored_kernel.combine_table_multi = combine_table_multi_reference
    idw_factored_kernel.combine_table = combine_table_reference
    layers.maxpool2_duplicate = maxpool2_duplicate_reference
    try:
        yield
    finally:
        (idw_factored_kernel.combine_table_multi, idw_factored_kernel.combine_table,
         layers.maxpool2_duplicate) = saved


def check_gradients(dev, sti: bool = False) -> None:
    """One full-width generator forward and backward at batch 12: the
    autograd Functions must carry the gradient back to ``input.*`` (the
    attention blocks before the combine) and ``Convsin.*`` (reached only
    through the first pool). The ``input.*`` gradients are held against the
    same computation through the plain versions on the card, within 1e-4 x
    max|grad|: cuDNN's backward and the combine backward's reordered sums
    change the last bits. ``sti``: every sample under its own block-10 mask,
    the gauge selection inside the forward (kernels #1, #5, #6); else one
    shared 79-gauge mask with the selection hoisted (#2, #4)."""
    rng = np.random.default_rng(SEED + 5)
    if sti:
        mask_xy = sti_masks("cpu", TRAIN_BATCH, STI_BLOCK, seed=SEED + 5).numpy()
    else:
        flat = np.zeros(H * W, np.float32)
        flat[rng.choice(H * W, 79, replace=False)] = 1.0
        mask_xy = flat.reshape(1, H, W)
    masks = torch.from_numpy(np.broadcast_to(mask_xy[:, None, :, :, None],
                                             (TRAIN_BATCH, LENGTH, H, W, 1)).copy()).to(dev)
    frames = torch.from_numpy(rng.random((TRAIN_BATCH, LENGTH, H, W, 1),
                                         dtype=np.float32)).to(dev)
    budget = {"idw_max_points": LENGTH * STI_G, "idw_shared_batch_mask": False} if sti else {}
    gen = P2IGenerator(H=H, W=W, length=LENGTH, num_res=NUM_RES, base_channels=BASE,
                       generator=torch.Generator().manual_seed(SEED), device=dev, **budget)
    kw = {} if sti else {"idw_prepared": gen.prepare_idw(masks[0, 0, :, :, 0])}

    def grads():
        gen.zero_grad(set_to_none=True)
        preds = gen(frames * masks, masks, **kw)
        loss, _ = reconstruction_loss(preds, frames, 0.05)
        loss.backward()
        torch.cuda.synchronize()
        return {n: (None if p.grad is None else p.grad.detach().clone())
                for n, p in gen.named_parameters()}

    reset_launches()
    got = grads()
    launches = read_launches()
    required = (("gauge_topk", "combine_table", "combine_table_bwd") if sti
                else ("combine_table_multi", "combine_table_multi_bwd"))
    for name in required + ("maxpool2_duplicate",):
        if launches[name] <= 0:
            fail(f"the generator backward launched no {name} kernel")
    for name, g in got.items():
        if g is None or not bool(torch.isfinite(g).all()):
            fail(f"generator parameter {name} has no finite gradient")
    for prefix in ("input.", "Convsin."):
        tensors = [g for n, g in got.items() if n.startswith(prefix)]
        if not tensors or any(float(g.abs().max()) == 0.0 for g in tensors):
            fail(f"a {prefix}* gradient is zero")
    with plain_versions():
        want = grads()
    worst = 0.0
    for name, g in got.items():
        if name.startswith("input."):
            scale = float(want[name].abs().max())
            rel = float((g - want[name]).abs().max()) / scale
            worst = max(worst, rel)
            if not rel <= 1e-4:
                fail(f"{name} gradient differs from the plain path by {rel:.2e} x max")
    print(f"gradients at batch {TRAIN_BATCH} ({'a mask a sample (sti)' if sti else 'shared mask'}): "
          f"all {len(got)} generator parameters finite, input.* and Convsin.* non-zero; "
          f"input.* vs plain versions on the card: max {worst:.2e} x max|grad|; "
          f"launches {launches}")


def time_input_block(dev) -> None:
    """The layer the two mask types differ in, alone, at batch 12: the
    InputBlock forward on a shared mask with the selection hoisted (stis) and on 12 masks with
    the selection inside (sti). Device time a forward (CUDA events), and the
    host time to enqueue one (host clock over 50 forwards, one sync at the
    end): the second is what the step's launching thread pays."""
    rng = np.random.default_rng(SEED + 6)
    x = torch.from_numpy(rng.random((TRAIN_BATCH, LENGTH, H, W), dtype=np.float32)).to(dev)
    shared_mask = gauge_masks(dev)["random79"].expand(TRAIN_BATCH, LENGTH, H, W)
    own_masks = sti_masks(dev, TRAIN_BATCH, STI_BLOCK)[:, None].expand(-1, LENGTH, -1, -1)
    line = []
    for label, shared, masks in (("stis, hoisted", True, shared_mask),
                                 ("sti", False, own_masks)):
        block = layers.InputBlock(LENGTH, max_points=LENGTH * STI_G,
                                  shared_batch_mask=shared, frames=LENGTH, device=dev)
        prep = None
        if shared:
            prep = factored_prepare_full(masks[0, 0], STI_G, k=K)
        with torch.no_grad():
            run = lambda: block(x * masks, masks, prepared=prep)  # noqa: E731
            dev_ms = cuda_ms(run)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                run()
            host_ms = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
        line.append(f"{label}: device {dev_ms:.4f} ms, host enqueue {host_ms:.4f} ms")
    print(f"InputBlock forward at batch {TRAIN_BATCH} (G={STI_G}): " + "; ".join(line))


def write_train_tree(tmp: Path, config: Path = TRAIN_CONFIG) -> dict:
    """Fake train store (64-frame events, window 16) and 79-gauge mask, written
    once, and the shipped training config ``config`` pointed at them."""
    store = tmp / "nimrod_train.zarr"
    mask = tmp / "masks" / "gauge_mask_128_train.txt"
    if not store.exists():
        fake.write_train_zarr(store, n_events=TRAIN_EVENTS, T=EVENT_FRAMES, H=H, W=W,
                              window=LENGTH, stride=1, seed=SEED)
        fake.write_gauge_mask(mask, H=H, W=W, n_gauges=79, seed=SEED)
        (tmp / "test_events").mkdir(exist_ok=True)
    cfg = load_config(config)
    cfg["data"]["train"]["data_root"] = str(store)
    cfg["data"]["test"]["data_root"] = str(tmp / "test_events")
    for split in ("train", "test"):
        cfg["data"][split]["mask"]["file"] = str(mask)
    cfg["train"].update(iterations=WARMUP_STEPS + TIMED_STEPS, log_step=WARMUP_STEPS)
    if cfg["train"]["batch_size"] != TRAIN_BATCH or cfg["model"]["base_channels"] != BASE:
        fail(f"{config.name} is no longer batch {TRAIN_BATCH}, base {BASE}")
    return cfg


def train(tmp: Path, card: str, dev) -> dict:
    """The GAN through scripts/train_torch.py, with device_decode off and on."""
    train_torch = load_script("train_torch")
    base_cfg = write_train_tree(tmp)
    required = ("gauge_topk", "combine_table_multi", "combine_table_multi_bwd",
                "maxpool2_duplicate")
    launches = {}
    for decode in (False, True):
        cfg = json.loads(json.dumps(base_cfg))
        cfg["save_dir"] = str(tmp / f"weights_dd{int(decode)}")
        cfg["data"]["train"]["device_decode"] = decode
        cfg_path = tmp / f"train_dd{int(decode)}.json"
        cfg_path.write_text(json.dumps(cfg))
        argv = ["--config", str(cfg_path), "--device", dev.type, "--log-level", "WARNING"]
        reset_launches()
        t0 = time.perf_counter()
        trainer = train_torch.main(train_torch.parse_args(argv))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        need = required + (("decode_normalize_mask",) if decode else ())
        for name in need:
            if launches[name] <= 0:
                fail(f"the training run (device_decode={decode}) launched no {name}")
        losses = (trainer.last_rec_loss, trainer.last_adv_loss, trainer.last_dis_loss)
        if not all(np.isfinite(losses)):
            fail(f"training losses are not finite: {losses}")
        if trainer.global_step != WARMUP_STEPS + TIMED_STEPS:
            fail(f"trained {trainer.global_step} steps")
        latest = Path(cfg["save_dir"]) / "latest.ckpt"
        if not latest.exists():
            fail("training wrote no latest.ckpt")
        (s0, t_0), (s1, t_1) = trainer.log_times[0], trainer.log_times[-1]
        if (s0, s1) != (WARMUP_STEPS, WARMUP_STEPS + TIMED_STEPS):
            fail(f"log points {trainer.log_times}")
        sps = (s1 - s0) / (t_1 - t_0)
        print(f"GAN training (device_decode={decode}): {s1} steps at batch "
              f"{TRAIN_BATCH}, base {BASE}, T={LENGTH}, {H}x{W} in {seconds:.2f} s "
              f"(run incl. set-up and validation); {sps:.3f} GAN steps/s over "
              f"steps {s0 + 1}-{s1} on {card}; mean rec {losses[0]:.4f}, adv "
              f"{losses[1]:.5f}, dis {losses[2]:.4f}; launches {launches}")
        if not decode:
            # the run stopped inside epoch 1 and saved it as done; the resume
            # takes six steps of epoch 2, the last four under the profiler (the
            # stis idle share the sti runs below are read against)
            prof = tmp / "profile_p2igan_stis"
            cfg["train"].update(iterations=s1 + 6, max_epochs=2, profile_dir=str(prof),
                                profile_start_step=s1 + 2, profile_steps=4)
            cfg_path.write_text(json.dumps(cfg))
            resumed = train_torch.main(train_torch.parse_args(
                argv + ["--resume", str(latest)]))
            if resumed.global_step != s1 + 6 or not np.isfinite(resumed.last_rec_loss):
                fail(f"resume ended at step {resumed.global_step}")
            print(f"resume from latest.ckpt continued to step {resumed.global_step}; "
                  + profile_report(prof))
    return launches


# -- p2igan on per-sample sti masks --------------------------------------------

def sti_config(cfg: dict) -> dict:
    """A shipped stis config with ``mask.type`` set to ``sti`` in both splits;
    its ``block_sizes: [10]`` then applies: 169 gauges a mask, 256 slots."""
    for split in ("train", "test"):
        mask = cfg["data"][split]["mask"]
        mask["type"] = "sti"
        if mask["block_sizes"] != [STI_BLOCK]:
            fail(f"the shipped config's block_sizes are {mask['block_sizes']}")
    return cfg


def serve_sti(tmp: Path, card: str, dev) -> dict:
    """The two 64-frame events through scripts/infer_torch.py, each under the
    sti mask its loader draws: nothing is hoisted, so every generator call (2
    an event at window batch 8) runs the gauge top-k for its 8 windows (#1,
    one launch) and the per-sample combine (#5); the shared-mask combine (#2)
    never runs. Then 2 x 16 frames under two different masks as ONE window
    stream (window batch 3, so a batch mixes events), card vs CPU path."""
    cfg = sti_config(load_config(tmp / "eval.json"))
    cfg["save_dir"] = str(tmp / "weights_sti")
    cfg_path = tmp / "eval_sti.json"
    cfg_path.write_text(json.dumps(cfg))
    checkpoint = tmp / "P2IGAN_seeded.pt"
    launches, events_per_s = serve(tmp, cfg_path, checkpoint, "p2igan_sti",
                                   required=STI_SERVING_KERNELS)
    calls = EVENTS * (-(-(EVENT_FRAMES // 4) // WINDOW_BATCH))
    want = {**dict.fromkeys(launches, 0), "gauge_topk": calls, "combine_table": calls,
            "maxpool2_duplicate": 3 * calls}
    if launches != want:
        fail(f"sti serving launched {launches}, expected {want}")
    print(f"p2igan sti serving: {events_per_s:.4f} events/s on {card}; a 64-frame "
          f"event launches gauge_topk x{calls // EVENTS}, combine_table x{calls // EVENTS}")

    store = zarrlite.open(tmp / "test_events.zarr", mode="r")
    evs = np.stack([store[f"event_{i + 1:02d}"][:LENGTH] for i in range(EVENTS)])
    evs = evs[..., None].astype(np.float32) / 255.0
    rng = np.random.default_rng(SEED + 21)
    masks = np.stack([create_mask_np(ev.shape, rng, "sti", block_sizes=[STI_BLOCK])
                      for ev in evs])
    if np.array_equal(masks[0], masks[1]):
        fail("the two sti masks are equal")
    outs = {}
    for d in ("cpu", dev):
        gen = load_generator(cfg, checkpoint, torch.device(d))
        if gen.idw_shared_batch_mask or not gen.idw_factored:
            fail("the sti config built a shared-mask generator")
        recon = SlidingWindowReconstructor(gen, stride=16, overlap=12, window_batch=3)
        outs[str(d)] = recon.batch(evs * masks, masks)
    err = float(np.abs(outs["cpu"] - outs[str(dev)]).max())
    print(f"p2igan_sti: 2 x 16 frames under two masks in one window stream, card vs "
          f"plain CPU path: max abs err {err:.4e} (x255 scale), max value "
          f"{outs['cpu'].max():.3f}")
    if not (np.isfinite(outs[str(dev)]).all() and err <= 1e-4 * 255.0):
        fail(f"p2igan_sti: card reconstruction differs from the CPU path by {err}")
    if not outs["cpu"].max() > 1.0:
        fail(f"p2igan_sti: the reconstruction is degenerate (max {outs['cpu'].max()})")
    return launches


STI_KERNEL_ROWS = ("gauge_topk_kernel", "combine_table_kernel",
                   "combine_table_bwd_partial_kernel", "sum_partials_kernel")


def train_sti(tmp: Path, card: str, dev, decode: bool) -> tuple:
    """The hinge GAN on p2igan_gan_baseline.json with sti masks (batch 12, a
    mask a sample) through scripts/train_torch.py: 15 steps, every one with
    its own gauge top-k (#1, one launch for the 12 masks), combine (#5) and
    combine backward (#6); the validation forwards add #1 and #5. With
    ``decode`` the raw pipeline ships uint8 frames and one mask frame a sample
    through #11. Then the profiled resume: idle share and the four kernels'
    share of the device time."""
    cfg = sti_config(write_train_tree(tmp, STI_TRAIN_CONFIG))
    cfg["data"]["train"]["device_decode"] = decode
    label = "p2igan sti GAN" + (" device_decode" if decode else "")
    launches, sps = train_family(tmp, card, dev, label, cfg, lambda steps, val: {
        "gauge_topk": steps + val, "combine_table": steps + val,
        "combine_table_bwd": steps, "maxpool2_duplicate": 3 * (steps + val),
        **({"decode_normalize_mask": None} if decode else {})})
    summary = json.loads((tmp / f"profile_{label.replace(' ', '_')}" / "summary.json")
                         .read_text())
    total = sum(summary["kernel_ms"].values())
    ours = {row: sum(ms for key, ms in summary["kernel_ms"].items() if f"{row}(" in key)
            for row in STI_KERNEL_ROWS}
    if total <= 0 or any(ms <= 0 for ms in ours.values()):
        fail(f"the profile shows no device time for {ours}")
    print(f"{label}: of {total:.2f} ms of kernel time in the {summary['steps']} profiled "
          f"steps, #1 + #5 + #6 take {sum(ours.values()):.3f} ms = "
          f"{sum(ours.values()) / total:.4f}: "
          + ", ".join(f"{row} {ms:.3f}" for row, ms in ours.items()))
    return launches, sps


# -- the dk and stdk families -------------------------------------------------

def dk_tail_inputs(dev, batch: int):
    """The tail's inputs as the full-width DK forward forms them: a seeded
    generator, ``batch`` windows of 16 random frames under the 79-gauge mask.
    Returns the eight tensors of ``mlp_tail_fused``, J = batch * 16."""
    rng = np.random.default_rng(SEED + 7)
    flat = np.zeros(H * W, np.float32)
    flat[rng.choice(H * W, VISIBLE_K, replace=False)] = 1.0
    frames = rng.random((batch, LENGTH, H * W), dtype=np.float32)
    z = torch.from_numpy(frames[:, :, flat > 0]).to(dev)             # (B, T, k)
    gen = DKGenerator(length=LENGTH, shared_batch_mask=True, device=dev,
                      generator=torch.Generator().manual_seed(SEED))
    net = gen._mlp.net
    for m in (net[0], net[2], net[4], net[6]):   # trained nets have biases
        m.bias.data = torch.from_numpy(
            rng.standard_normal(m.bias.shape).astype(np.float32) * 0.1).to(dev)
    K_s = sum(gen.num_basis_space)
    phi_s = torch.from_numpy(build_phi_space(H, W, gen.num_basis_space)).to(dev)
    with torch.no_grad():
        phi_part = phi_s @ net[0].weight[:, :K_s].t()
        offs = z.reshape(batch * LENGTH, VISIBLE_K) @ net[0].weight[:, K_s:].t() + net[0].bias
        return tuple(t.detach().contiguous() for t in (
            phi_part, offs, net[2].weight.t(), net[2].bias, net[4].weight.t(),
            net[4].bias, net[6].weight[0], net[6].bias[0]))


def check_mlp_tail(dev) -> dict:
    """Kernel #12 at the serving (J=128) and training (J=192) shapes, within
    1e-5 x max|plain|; both sides' distance to a float64 plain version. The
    plain version is the chain of three ``torch.matmul`` products (cuBLAS) over
    8 offset rows at a time, so its time is also printed as
    ``cublas_chain_ms``; the port never runs it on a CUDA tensor."""
    result = {}
    for batch in (WINDOW_BATCH, TRAIN_BATCH):
        args = dk_tail_inputs(dev, batch)
        J, hw, h = args[1].shape[0], args[0].shape[0], args[0].shape[1]
        out_k, out_p = mlp_tail_fused(*args), mlp_tail_reference(*args)
        out_64 = mlp_tail_reference(*(a.double() for a in args))
        torch.cuda.synchronize()
        scale = float(out_p.abs().max())
        e = float((out_k - out_p).abs().max())
        e_k64 = float((out_k.double() - out_64).abs().max())
        e_p64 = float((out_p.double() - out_64).abs().max())
        if not (scale > 0 and e <= 1e-5 * scale):
            fail(f"mlp_tail_fused J={J}: max abs err {e} > 1e-5 x {scale}")
        k_ms = cuda_ms(lambda: mlp_tail_fused(*args))
        p_ms = cuda_ms(lambda: mlp_tail_reference(*args), reps=5)
        flops = J * hw * (4 * h * h + 4 * h)
        nbytes = 4 * (hw * h + J * h + 2 * h * h + 3 * h + 1 + J * hw)
        b = bound(nbytes, flops)
        print(f"mlp_tail_fused J={J} HW={hw} h={h}: max abs err {e:.3e} "
              f"({e / scale:.2e} x max|plain| {scale:.3f}); to float64: kernel "
              f"{e_k64:.3e}, plain {e_p64:.3e}; kernel {k_ms:.4f} ms "
              f"({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms "
              f"(cublas_chain_ms {p_ms:.4f}), bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})")
        # the kernels line reports the training shape (the larger J)
        result = {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, **b}
    return result


def check_mlp_tail_bwd(dev) -> dict:
    """Kernel #13 at the training shape (J=192): dphi and doff within 1e-4 x
    max|plain|; the weight and bias gradients sum J*HW = 3.1e6 float32 terms
    in another order than autograd's matmuls, so 1e-3 x max|plain|. Both sides'
    distance to float64 autograd of the plain version is printed."""
    phi, off, fc2, b2, fc3, b3, fc4, _ = dk_tail_inputs(dev, TRAIN_BATCH)
    J, hw, h = off.shape[0], phi.shape[0], phi.shape[1]
    g = torch.from_numpy(np.random.default_rng(SEED + 8).standard_normal(
        (J, hw)).astype(np.float32)).to(dev)
    got = mlp_tail_bwd(phi, off, g, fc2, b2, fc3, b3, fc4)
    want = mlp_tail_bwd_reference(phi, off, g, fc2, b2, fc3, b3, fc4)
    want_64 = mlp_tail_bwd_reference(*(a.double() for a in (phi, off, g, fc2, b2,
                                                            fc3, b3, fc4)))
    torch.cuda.synchronize()
    names = ("dphi", "doff", "dfc2", "db2", "dfc3", "db3", "dfc4")
    err, worst = 0.0, {}
    for name, a, b_, c in zip(names, got, want, want_64):
        scale = float(b_.abs().max())
        e = float((a - b_).abs().max())
        tol = 1e-4 if name in ("dphi", "doff") else 1e-3
        worst[name] = (e / scale, float((a.double() - c).abs().max()) / scale,
                       float((b_.double() - c).abs().max()) / scale)
        if not (a.shape == b_.shape and scale > 0 and e <= tol * scale):
            fail(f"mlp_tail_bwd {name}: max abs err {e} > {tol} x {scale}")
        err = max(err, e)
    again = mlp_tail_bwd(phi, off, g, fc2, b2, fc3, b3, fc4)
    if not all(bitwise_equal(a, b_) for a, b_ in zip(got, again)):
        fail("mlp_tail_bwd does not repeat bit for bit")
    k_ms = cuda_ms(lambda: mlp_tail_bwd(phi, off, g, fc2, b2, fc3, b3, fc4), reps=10)
    p_ms = cuda_ms(lambda: mlp_tail_bwd_reference(phi, off, g, fc2, b2, fc3, b3, fc4),
                   reps=3, warmup=1)
    # six (rows, h, h) products a (j, pixel): two recomputed, two transposed,
    # two weight gradients; phi, g and the weights in, the gradients out
    flops = J * hw * (12 * h * h + 10 * h)
    nbytes = 4 * (2 * hw * h + 2 * J * h + J * hw + 4 * h * h + 6 * h)
    b = bound(nbytes, flops)
    print(f"mlp_tail_bwd J={J} HW={hw} h={h}: kernel vs plain / kernel vs float64 / "
          f"plain vs float64, x max|plain|: "
          + ", ".join(f"{n} {v[0]:.1e}/{v[1]:.1e}/{v[2]:.1e}" for n, v in worst.items())
          + f"; repeats bitwise; kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} "
          f"TFLOP/s), plain {p_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **b}


def write_dk_serving(tmp: Path, model: str) -> tuple:
    """A seeded full-width dk/stdk generator as a reference-layout .pt and the
    shipped gauge config pointed at the serving tree."""
    klass, config = DK_FAMILY[model]
    gen = klass(length=LENGTH, shared_batch_mask=True,
                generator=torch.Generator().manual_seed(SEED))
    if list(gen.state_dict())[:2] != ["_mlp.net.0.weight", "_mlp.net.0.bias"]:
        fail(f"{model} state_dict keys {list(gen.state_dict())}")
    # a random net's output may be negative everywhere, and the reconstruction
    # clips at 0: shift the output bias so that the first window's median is
    # 0.5, which keeps the card-vs-CPU comparison from being 0 against 0
    ev = zarrlite.open(tmp / "test_events.zarr", mode="r")["event_01"][:LENGTH]
    ev = torch.from_numpy(ev[None, ..., None].astype(np.float32) / 255.0)
    mask = np.loadtxt(tmp / "masks" / "gauge_mask_128.txt").astype(np.float32)
    masks = torch.from_numpy(mask)[None, None, :, :, None].expand_as(ev)
    with torch.no_grad():
        gen._mlp.net[6].bias += 0.5 - gen(ev * masks, masks).median()
    checkpoint = tmp / f"{model.upper()}_seeded.pt"
    torch.save(gen.state_dict(), checkpoint)
    cfg = load_config(config)
    cfg["save_dir"] = str(tmp / f"weights_{model}")
    cfg["data"]["train"]["data_root"] = str(tmp / "nimrod_train.zarr")  # unread
    for split in ("train", "test"):
        cfg["data"][split]["mask"]["file"] = str(tmp / "masks" / "gauge_mask_128.txt")
    cfg["data"]["test"]["data_root"] = str(tmp / "test_events.zarr")
    cfg_path = tmp / f"eval_{model}.json"
    cfg_path.write_text(json.dumps(cfg))
    return cfg_path, checkpoint


def host_loader_rate(tmp: Path, cfg: dict, label: str) -> float:
    """Windows/s of the host input pipeline alone (zarr window read, crop,
    /255, mask, collate; float mode, the config's 4 loader threads) on the
    training store: what the steps can be fed with."""
    loader = P2IDataModule(cfg).train_dataloader()
    t0 = time.perf_counter()
    windows = sum(batch[0].shape[0] for batch in loader)
    rate = windows / (time.perf_counter() - t0)
    print(f"host input pipeline alone ({label}): {windows} windows of {LENGTH}x{H}x{W} in "
          f"batches of {TRAIN_BATCH}: {rate:.1f} windows/s "
          f"({rate / TRAIN_BATCH:.2f} batches/s)")
    return rate


def train_family(tmp: Path, card: str, dev, label: str, cfg: dict, expected) -> tuple:
    """One family through scripts/train_torch.py from the config ``cfg`` (a
    shipped one pointed at the fake tree): 5 warm-up + 10 timed steps at batch
    12; ``expected(steps, val_batches)`` gives the kernel launches the run
    must show (None: at least one), every other kernel none. Every parameter of the generator (and
    of the critic under ``use_gan``) ends with a finite non-zero gradient, and
    every BatchNorm running statistic has moved. Then a resume (which must
    restore every weight and buffer) for 6 more steps, the last 4 under the
    trainer's torch.profiler window (kept out of the timed run, which it would
    slow): device idle share and time by kernel."""
    train_torch = load_script("train_torch")
    tag = label.replace(" ", "_")
    cfg["save_dir"] = str(tmp / f"weights_train_{tag}")
    cfg_path = tmp / f"train_{tag}.json"
    cfg_path.write_text(json.dumps(cfg))
    argv = ["--config", str(cfg_path), "--device", dev.type, "--log-level", "WARNING"]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_torch.main(train_torch.parse_args(argv))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = read_launches()
    steps = WARMUP_STEPS + TIMED_STEPS
    use_gan = bool(cfg["loss"]["use_gan"])
    losses = [trainer.last_rec_loss] + ([trainer.last_adv_loss, trainer.last_dis_loss]
                                        if use_gan else [])
    if trainer.global_step != steps or not all(np.isfinite(losses)):
        fail(f"{label} trained {trainer.global_step} steps, losses {losses}")
    if (trainer.discriminator is not None) != use_gan:
        fail(f"{label}: discriminator {trainer.discriminator}")
    want = {**dict.fromkeys(launches, 0), **expected(steps, len(trainer.val_loader))}
    # None: launched, but how often is not fixed (the prefetch thread runs ahead)
    want = {k: (launches[k] or None) if v is None else v for k, v in want.items()}
    if launches != want:
        fail(f"{label} training launched {launches}, expected {want}")
    modules = [trainer.generator] + ([trainer.discriminator] if use_gan else [])
    n_params = 0
    for module in modules:
        for name, prm in module.named_parameters():
            n_params += 1
            # the critic's head.bias may be exactly zero: while both hinges are
            # active for every sample its real and fake halves cancel
            may_be_zero = module is trainer.discriminator and name == "head.bias"
            if module is trainer.discriminator and name == "alpha3d":
                continue  # the P2I critic never reads it (nor does the reference)
            if prm.grad is None or not bool(torch.isfinite(prm.grad).all()) \
                    or (float(prm.grad.abs().max()) == 0.0 and not may_be_zero):
                fail(f"{label} parameter {name} has no finite non-zero gradient")
        for name, buf in module.named_buffers():
            if "running_" not in name:
                continue
            moved = float((buf - (1.0 if name.endswith("running_var") else 0.0)).abs().max())
            if not (bool(torch.isfinite(buf).all()) and moved > 0.0):
                fail(f"{label} buffer {name} did not move from its initial value")
    (s0, t_0), (s1, t_1) = trainer.log_times[0], trainer.log_times[-1]
    if (s0, s1) != (WARMUP_STEPS, steps):
        fail(f"log points {trainer.log_times}")
    sps = (s1 - s0) / (t_1 - t_0)
    print(f"{label} training: {s1} steps at batch {TRAIN_BATCH}, T={LENGTH}, {H}x{W} in "
          f"{seconds:.2f} s (run incl. set-up and validation); {sps:.3f} steps/s over "
          f"steps {s0 + 1}-{s1} on {card}; mean losses (rec, adv, dis) {losses}; all "
          f"{n_params} parameters' gradients finite and non-zero; peak device memory "
          f"{peak_gb:.2f} GB; launches {launches}")
    latest = Path(cfg["save_dir"]) / "latest.ckpt"
    if not latest.exists():
        fail(f"{label} training wrote no latest.ckpt")
    saved = {k: v.clone() for k, v in trainer.generator.state_dict().items()}
    prof = tmp / f"profile_{tag}"
    cfg["train"].update(iterations=s1 + 6, max_epochs=2, profile_dir=str(prof),
                        profile_start_step=s1 + 2, profile_steps=4)
    cfg_path.write_text(json.dumps(cfg))
    restored = train_torch.Trainer(load_config(cfg_path), device=dev.type)
    restored.load(latest)
    for key, val in restored.generator.state_dict().items():
        if not torch.equal(val, saved[key]):
            fail(f"{label}: resume did not restore {key}")
    resumed = train_torch.main(train_torch.parse_args(argv + ["--resume", str(latest)]))
    if resumed.global_step != s1 + 6 or not np.isfinite(resumed.last_rec_loss):
        fail(f"{label} resume ended at step {resumed.global_step}")
    print(f"{label}: resume restored every weight and buffer and continued to step "
          f"{resumed.global_step}; " + profile_report(prof))
    return launches, sps


def train_rec(tmp: Path, card: str, dev, model: str) -> tuple:
    """dk or stdk on the shipped gauge config: reconstruction loss only
    (use_gan 0), AdamNoMu; the tail forward runs once a step and a validation
    batch, its backward once a step."""
    cfg = write_train_tree(tmp, DK_FAMILY[model][1])
    if cfg["loss"]["use_gan"] or cfg["model"]["name"] != model:
        fail(f"{DK_FAMILY[model][1].name} is no longer a rec-loss {model} config")
    return train_family(tmp, card, dev, model, cfg, lambda steps, val: {
        "mlp_tail_fused": steps + val, "mlp_tail_bwd": steps})


# -- the simple family --------------------------------------------------------

def conv_excess(got: torch.Tensor, want: torch.Tensor, atol: float) -> tuple:
    """(max abs error, worst |got - want| - (atol + 1e-5 |want|)): the second
    is <= 0 when the pair meets rtol 1e-5 and the atol."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff - (atol + 1e-5 * want.abs())).max())


def check_fused_conv(dev, name: str, kernel, plain, chain, shapes, make) -> dict:
    """One of the two fused convolutions against its plain version, at the
    serving chunk (first shape: timed, and the one the kernels line reports)
    and at an odd shape: rtol 1e-5, atol 5e-6. The CPU tests hold the same
    functions to the JAX package's atol 1e-6; over the 1.3e8 outputs of the
    serving chunk the float32 summation-order difference between the kernel
    and cuDNN reaches 1.4e-6 at outputs near zero, each side as far from the
    float64 result, so the card's check states 5e-6 and prints whether 1e-6
    held too. ``make(shape)`` gives (x, weight, bias) with x in the
    memory order the simple generator hands over; ``chain(x, weight, bias)``
    is the cuDNN chain on channels-first tensors (two library calls)."""
    result = {}
    for shape in shapes:
        x, weight, bias = make(shape)
        with torch.no_grad():
            out_k, out_p = kernel(x, weight, bias), plain(x, weight, bias)
            out_64 = plain(x.double(), weight.double(), bias.double())
        torch.cuda.synchronize()
        if out_k.shape != out_p.shape:
            fail(f"{name}{shape}: shape {tuple(out_k.shape)} vs {tuple(out_p.shape)}")
        err, excess = conv_excess(out_k, out_p, 5e-6)
        strict = conv_excess(out_k, out_p, 1e-6)[1] <= 0.0
        e_k64 = float((out_k.double() - out_64).abs().max())
        e_p64 = float((out_p.double() - out_64).abs().max())
        del out_64
        if not excess <= 0.0:
            fail(f"{name}{shape}: max abs err {err}, {excess} over rtol 1e-5 atol 5e-6")
        line = (f"{name}{shape}: max abs err {err:.3e} (within rtol 1e-5, atol 5e-6; "
                f"within atol 1e-6: {strict}); to float64: kernel {e_k64:.3e}, "
                f"plain {e_p64:.3e}")
        if not result:
            # the chain gets cuDNN's own layouts, already contiguous
            xc = x.permute(0, 4, 1, 2, 3).contiguous()
            wc = weight.permute(4, 3, 0, 1, 2).contiguous()
            with torch.no_grad():
                k_ms = cuda_ms(lambda: kernel(x, weight, bias))
                p_ms = cuda_ms(lambda: plain(x, weight, bias), reps=10)
                lib_ms = cuda_ms(lambda: chain(xc, wc, bias), reps=10)
            b_, t_, h_, w_, cin = x.shape
            cout = weight.shape[4]
            voxels = b_ * t_ * h_ * w_
            flops = voxels * cout * (2 * 27 * cin + 3)
            nbytes = 4 * (x.numel() + out_k.numel() + weight.numel() + bias.numel())
            bnd = {**bound(nbytes, flops), "library_ms": lib_ms}
            line += (f"; kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s, "
                     f"{nbytes / k_ms / 1e6:.0f} GB/s), plain {p_ms:.4f} ms, cuDNN chain "
                     f"(conv, then activation) {lib_ms:.4f} ms, bound "
                     f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
            result = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **bnd}
        print(line)
    return result


def check_enc0(dev) -> dict:
    """Kernel #14: x is channels-last (B, T, H, W, Cin), as the concatenated
    (masked, mask) frames arrive. Weights U(+-1/sqrt(fan_in)), the init."""
    rng = np.random.default_rng(SEED + 14)

    def make(shape):
        b, t, h, w, cin, cout = shape
        bound_ = 1.0 / np.sqrt(27 * cin)
        return (torch.from_numpy(rng.standard_normal((b, t, h, w, cin)).astype(np.float32)).to(dev),
                torch.from_numpy(rng.uniform(-bound_, bound_, (3, 3, 3, cin, cout))
                                 .astype(np.float32)).to(dev),
                torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1).to(dev))

    def chain(xc, wc, bias):
        return torch.nn.functional.leaky_relu(
            torch.nn.functional.conv3d(xc, wc, bias, padding=1), 0.2)

    return check_fused_conv(dev, "enc0_conv3d_leaky", enc0_conv3d_leaky,
                            enc0_conv3d_leaky_reference, chain,
                            [(WINDOW_BATCH, LENGTH, H, W, 2, BASE), (2, 3, 37, 45, 3, 40)],
                            make)


def check_dec2(dev) -> dict:
    """Kernel #15: x is channels-first in memory, as cuDNN's transposed
    convolution leaves it, and non-negative (it follows a ReLU)."""
    rng = np.random.default_rng(SEED + 15)

    def make(shape):
        b, t, h, w, c = shape
        bound_ = 1.0 / np.sqrt(27 * c)
        x = torch.from_numpy(rng.standard_normal((b, c, t, h, w)).astype(np.float32))
        return (torch.relu(x.to(dev)).permute(0, 2, 3, 4, 1),
                torch.from_numpy(rng.uniform(-bound_, bound_, (3, 3, 3, c, 1))
                                 .astype(np.float32)).to(dev),
                torch.from_numpy(rng.standard_normal(1).astype(np.float32) * 0.1).to(dev))

    def chain(xc, wc, bias):
        return torch.sigmoid(torch.nn.functional.conv3d(xc, wc, bias, padding=1))

    return check_fused_conv(dev, "conv3d_cout1_sigmoid", conv3d_cout1_sigmoid,
                            conv3d_cout1_sigmoid_reference, chain,
                            [(WINDOW_BATCH, LENGTH, H, W, BASE), (2, 3, 37, 45, 5)], make)


def time_conv_layouts(dev) -> None:
    """The two cuDNN layers next to the kernels, at the serving chunk, in both
    memory formats PyTorch offers for 5-D tensors: what the choice of
    channels-first activations between #14, cuDNN and #15 rests on."""
    gen = torch.Generator().manual_seed(SEED)
    cl = torch.channels_last_3d
    x = torch.randn((WINDOW_BATCH, BASE, LENGTH, H, W), generator=gen).to(dev)
    w_enc1 = (torch.randn((2 * BASE, BASE, 3, 3, 3), generator=gen) * 0.02).to(dev)
    y = torch.randn((WINDOW_BATCH, 2 * BASE, LENGTH // 2, H // 2, W // 2), generator=gen).to(dev)
    w_dec1 = (torch.randn((2 * BASE, BASE, 2, 2, 2), generator=gen) * 0.02).to(dev)
    conv, conv_t = torch.nn.functional.conv3d, torch.nn.functional.conv_transpose3d
    with torch.no_grad():
        x_cl, w_enc1_cl = x.contiguous(memory_format=cl), w_enc1.contiguous(memory_format=cl)
        y_cl, w_dec1_cl = y.contiguous(memory_format=cl), w_dec1.contiguous(memory_format=cl)
        times = [cuda_ms(fn, reps=7) for fn in (
            lambda: conv(x, w_enc1, None, 2, 1), lambda: conv(x_cl, w_enc1_cl, None, 2, 1),
            lambda: conv_t(y, w_dec1, None, 2), lambda: conv_t(y_cl, w_dec1_cl, None, 2))]
    print("cuDNN float32 at the serving chunk, channels-first vs channels_last_3d: enc1 "
          f"(64 -> 128, stride 2) {times[0]:.4f} vs {times[1]:.4f} ms; dec1 (transposed, "
          f"128 -> 64, stride 2) {times[2]:.4f} vs {times[3]:.4f} ms")


def write_simple_serving(tmp: Path, dec2_fused: bool) -> tuple:
    """A seeded full-width simple generator as a reference-layout .pt (its
    BatchNorm affine and running statistics moved away from identity, so the
    fold is exercised; ``num_batches_tracked`` entries as a reference
    checkpoint carries them) and the shipped eval config with ``model``
    replaced."""
    checkpoint = tmp / "SIMPLE_seeded.pt"
    if not checkpoint.exists():
        gen = SimpleGenerator(base_channels=BASE,
                              generator=torch.Generator().manual_seed(SEED))
        state = gen.state_dict()
        rng = torch.Generator().manual_seed(SEED + 1)
        for i in range(3):
            n = state[f"encoder.{i}.1.weight"].shape[0]
            state[f"encoder.{i}.1.weight"] = 1.0 + 0.3 * torch.randn(n, generator=rng)
            state[f"encoder.{i}.1.bias"] = 0.2 * torch.randn(n, generator=rng)
            state[f"encoder.{i}.1.running_mean"] = 0.1 * torch.randn(n, generator=rng)
            state[f"encoder.{i}.1.running_var"] = torch.exp(0.5 * torch.randn(n, generator=rng))
            state[f"encoder.{i}.1.num_batches_tracked"] = torch.tensor(1000)
        torch.save(state, checkpoint)
    cfg = load_config(tmp / "eval.json")
    cfg["model"] = {**SIMPLE_MODEL, "dec2_fused": dec2_fused}
    cfg["save_dir"] = str(tmp / "weights_simple")
    cfg_path = tmp / f"eval_simple_{int(dec2_fused)}.json"
    cfg_path.write_text(json.dumps(cfg))
    return cfg_path, checkpoint


def serve_simple(tmp: Path, card: str, dev) -> dict:
    """Both kernels on, then dec2 through cuDNN; 64-frame events at stride 16,
    overlap 12 are 16 windows, two generator calls at window batch 8."""
    calls = EVENTS * (-(-(EVENT_FRAMES // 4) // WINDOW_BATCH))
    launches = {}
    for fused in (True, False):
        cfg_path, checkpoint = write_simple_serving(tmp, fused)
        label = "simple" if fused else "simple_dec2_cudnn"
        got, events_per_s = serve(tmp, cfg_path, checkpoint, label,
                                  required=("enc0_conv3d_leaky",))
        want = (calls, calls if fused else 0)
        if (got["enc0_conv3d_leaky"], got["conv3d_cout1_sigmoid"]) != want:
            fail(f"{label} serving launched {got}, expected enc0 x{want[0]}, dec2 x{want[1]}")
        check_against_cpu(tmp, cfg_path, checkpoint, label, dev)
        print(f"{label} serving (dec2_fused={fused}): {events_per_s:.4f} events/s on {card}")
        if fused:
            launches = got
            profile_simple_serving(tmp, cfg_path, checkpoint, dev)
    return launches


def profile_simple_serving(tmp: Path, cfg_path: Path, checkpoint: Path, dev) -> None:
    """One 64-frame event through the folded generator under torch.profiler:
    device time by operation and the idle share. The activations stay
    channels-first between the two kernels and cuDNN, so no copy of a
    (8, 64, 16, 128, 128) activation may show: copy kernels on the device
    (the two small weight permutes a call) must stay under 2% of the kernel
    time; one such copy a call would be 4% or more."""
    from torch.profiler import ProfilerActivity, profile

    cfg = load_config(cfg_path)
    ev = zarrlite.open(tmp / "test_events.zarr", mode="r")["event_01"][:]
    ev = ev[..., None].astype(np.float32) / 255.0
    mask = np.loadtxt(cfg["data"]["test"]["mask"]["file"]).astype(np.float32)
    masks = np.broadcast_to(mask[None, :, :, None], ev.shape).astype(np.float32)
    recon = SlidingWindowReconstructor(load_generator(cfg, checkpoint, dev), stride=16,
                                       overlap=12, window_batch=WINDOW_BATCH)
    recon(ev * masks, masks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        recon(ev * masks, masks)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = device_busy_us(prof)
    rows = sorted((r for r in prof.key_averages()
                   if r.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r.self_device_time_total)
    total = sum(r.self_device_time_total for r in rows)
    # copies made on the device (a layout conversion would be one); the
    # event's transfers over PCIe are named Memcpy HtoD / DtoH
    copies = sum(r.self_device_time_total for r in rows
                 if "copy" in r.key.lower() and "HtoD" not in r.key and "DtoH" not in r.key)
    print(f"simple serving profile, one {EVENT_FRAMES}-frame event (2 generator calls): "
          f"wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms, idle share "
          f"{1.0 - busy_us / wall_us:.3f}; copy kernels on the device {copies / 1e3:.3f} ms "
          f"= {copies / total:.4f} of kernel time; kernels by device time (ms, calls):\n  "
          + "\n  ".join(f"{r.key[:90]} {r.self_device_time_total / 1e3:.3f} {r.count}"
                        for r in rows[:14]))
    if not copies <= 0.02 * total:
        fail(f"simple serving copies {copies / total:.3f} of its device time: a layout "
             f"conversion sits between the kernels and cuDNN")


def simple_step_flops(use_gan: bool) -> float:
    """Convolution operations of one simple train step at batch 12, from the
    layer shapes: 3 x the generator's forward (forward, input gradient, weight
    gradient) and, under the GAN, 8 x the critic's (three forwards, two full
    backwards, one input-gradient pass for the generator's loss)."""
    def conv(voxels, cin, cout, taps):
        return 2.0 * TRAIN_BATCH * voxels * cin * cout * taps

    full, half, quarter = (LENGTH * H * W // 8 ** i for i in range(3))
    gen = (conv(full, 2, BASE, 27) + conv(half, BASE, 2 * BASE, 27)
           + conv(quarter, 2 * BASE, 4 * BASE, 27) + conv(quarter, 4 * BASE, 2 * BASE, 8)
           + conv(half, 2 * BASE, BASE, 8) + conv(full, BASE, 1, 27))
    disc = (conv(half, 1, BASE, 27) + conv(quarter, BASE, 2 * BASE, 27)
            + conv(quarter // 8, 2 * BASE, 4 * BASE, 27))
    return 3.0 * gen + (8.0 * disc if use_gan else 0.0)


def train_simple(tmp: Path, card: str, dev, use_gan: bool) -> tuple:
    """simple on the shipped GAN gauge config with ``model`` replaced: rec-loss
    only, or the hinge GAN against the simple BatchNorm critic. It trains on
    cuDNN alone: no kernel of the port may launch."""
    cfg = write_train_tree(tmp)
    cfg["model"] = dict(SIMPLE_MODEL)
    cfg["loss"]["use_gan"] = int(use_gan)
    label = "simple GAN" if use_gan else "simple rec-loss"
    launches, sps = train_family(tmp, card, dev, label, cfg, lambda steps, val: {})
    flops = simple_step_flops(use_gan)
    print(f"{label}: a step's convolutions are {flops / 1e12:.3f} TFLOP, "
          f"{flops / PEAK_FLOPS * 1e3:.2f} ms at the float32 peak; measured "
          f"{1e3 / sps:.2f} ms a step: {flops / PEAK_FLOPS * sps:.3f} of the bound's rate")
    return launches, sps


def profile_report(prof: Path) -> str:
    """The trainer's profiler window as text: idle share, top rows by device time."""
    summary = json.loads((prof / "summary.json").read_text())
    rows = [" ".join(line.split()) for line in
            (prof / "key_averages.txt").read_text().splitlines()[3:9]]
    return (f"profile of its last {summary['steps']} steps: wall "
            f"{summary['wall_ms']:.2f} ms, device busy {summary['device_busy_ms']:.2f} ms, "
            f"idle share {summary['device_idle_share']:.3f}; top rows by device time "
            f"(name, self CPU %, self CPU, CPU total %, CPU total, CPU avg, self CUDA, "
            f"self CUDA %, CUDA total, CUDA avg, calls):\n  " + "\n  ".join(rows))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    set_precision_policy()

    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"kernels built/loaded in {time.perf_counter() - t0:.2f} s: "
          f"{cuda_lib.library_path().name}")
    for line in cuda_lib.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    masks = gauge_masks(dev)
    results = {"gauge_topk": check_gauge_topk(masks),
               "combine_table_multi": check_combine(masks, dev),
               "maxpool2_duplicate": check_pool_dup(dev),
               "combine_table_multi_bwd": check_combine_bwd(masks),
               "decode_normalize_mask": check_decode(dev),
               "combine_table": check_combine_table(dev),
               "combine_table_bwd": check_combine_table_bwd(dev),
               "combine_dense": check_combine_dense(dev),
               "mlp_tail_fused": check_mlp_tail(dev),
               "mlp_tail_bwd": check_mlp_tail_bwd(dev),
               "enc0_conv3d_leaky": check_enc0(dev),
               "conv3d_cout1_sigmoid": check_dec2(dev)}
    check_gauge_topk_batched(dev)
    time_input_block(dev)
    time_conv_layouts(dev)

    # launches of every kernel, per path driven
    paths = {"idw_3d_factored op": run_idw_3d_factored(dev)}
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        os.environ["P2IGAN_FORCE_FILE_TRACKER"] = "1"
        from p2igan_tpu_torch.utils.tracking import get_tracker

        get_tracker().set_tracking_uri(str(tmp / "mlruns"))
        cfg_path = write_serving_tree(tmp)
        checkpoint = tmp / "P2IGAN_seeded.pt"
        paths["p2igan serving"], events_per_s = serve(tmp, cfg_path, checkpoint, "p2igan")
        check_against_cpu(tmp, cfg_path, checkpoint, "p2igan", dev)
        print(f"p2igan serving: {events_per_s:.4f} events/s on {card}")
        check_gradients(dev)
        paths["p2igan training"] = train(tmp, card, dev)
        paths["p2igan sti serving"] = serve_sti(tmp, card, dev)
        check_gradients(dev, sti=True)
        host_loader_rate(tmp, sti_config(write_train_tree(tmp, STI_TRAIN_CONFIG)),
                         "sti, a mask drawn per window")
        for decode in (False, True):
            label = "p2igan sti training" + (" device_decode" if decode else "")
            paths[label], sps = train_sti(tmp, card, dev, decode)
            print(f"{label}: {sps:.4f} GAN steps/s on {card}")
        host_loader_rate(tmp, write_train_tree(tmp, DK_FAMILY["dk"][1]), "stis gauge file")
        for model in DK_FAMILY:
            cfg_path, checkpoint = write_dk_serving(tmp, model)
            paths[f"{model} serving"], events_per_s = serve(
                tmp, cfg_path, checkpoint, model, required=("mlp_tail_fused",))
            check_against_cpu(tmp, cfg_path, checkpoint, model, dev)
            print(f"{model} serving: {events_per_s:.4f} events/s on {card}")
            paths[f"{model} training"], sps = train_rec(tmp, card, dev, model)
            print(f"{model} training: {sps:.4f} steps/s on {card}")
        paths["simple serving"] = serve_simple(tmp, card, dev)
        for use_gan in (False, True):
            label = "simple GAN training" if use_gan else "simple rec-loss training"
            paths[label], sps = train_simple(tmp, card, dev, use_gan)
            print(f"{label}: {sps:.4f} steps/s on {card}")

    print(json.dumps({"launches_by_path": paths}))
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": paths[LAUNCH_PATH.get(name, "p2igan training")][name],
                **results[name]}
               for name, (_, src, rep) in KERNELS.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
