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
     tie-heavy regular grid; a call and the device time), combine_table_multi (max abs error <= 1e-5 and
     the top gauge slot of every (z, pixel) identical; a call and the device
     time at N=8 and N=12), maxpool2_duplicate
     (bitwise at the three pyramid shapes of serving and of training and in
     its 8-byte form; a call and the device time against the
     ``max_pool2d`` -> ``repeat_interleave`` chain, its plain version);
   - at the shapes of the GAN training step (p2igan_gan_baseline_gauge.json:
     batch 12): combine_table_multi_bwd (N=12, D=16, HW=16384, G=128, k=4, on
     both masks; max abs error <= 1e-5 x max|plain|, since it sums in 64-bit
     fixed point and the plain version in float32; bitwise equal to its
     fixed-point model, across two launches and at tile budgets of one window
     and of all 12 at the widest row; a call and the device time) and
     decode_normalize_mask
     ((12, 16, 128, 128, 1) uint8 with a (12, 1, 128, 128, 1) mask; bitwise
     against the numpy decode; a call and the device time, each beside the
     elementwise chain's);
   - the metric suite (``metrics/metric.py``: PyTorch calls, no kernel of
     the port) on one full-width validation batch (12, 16, 128, 128, 1)
     whose values cross every threshold: the card's state against the
     port's CPU suite on the same tensors (counts exactly, every other leaf
     within rtol 1e-5), an update under the sync debug mode "error" (it
     waits for nothing), and the device ms of one update.
3. Serves two 64-frame 128x128 fake events through ``scripts/infer_torch.py``
   (seeded full-width generator saved as a reference-layout .pt, stride 16,
   overlap 12, window batch 8) and checks the output store, that it equals
   the warm-up run's bit for bit (as every served family below), that every
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
   resume that continues (its last 4 steps profiled: idle share, the share of
   #2 + #4 in the kernel time), and that the run launched every kernel of the
   training path. Both runs set ``train.eval_metrics``: each logs every key
   of the metric suite as a finite val/<key> and writes its epoch's example
   images (one train PNG and one for each of the first five validation
   batches, four here, each 2 x 128 rows by 16 x 128 columns of RGB); then the validation pass timed with the suite and
   without it (on, off, off, on). Every training run below also writes the
   example images, and its exact launch counts include their forwards.
   Prints GAN steps/s with the card's name and power limit.
6. p2igan on per-sample ``sti`` masks (the shipped eval and GAN configs with
   ``mask.type`` set to ``sti``; their ``block_sizes: [10]`` gives 169 gauges a
   mask in 256 gauge slots), where nothing is hoisted and every sample selects
   from its own gauges:
   - the per-sample combine (combine_table), its backward (combine_table_bwd)
     and the dense-field combine (combine_dense) against their plain versions
     at the training shape (B=12, D=16, G=256, HW=16384), the serving shape
     (B=8) and the reference default block size 4 (1024 gauges, G=1152): the
     two forwards bitwise, the backward within 1e-5 x max|plain|, bitwise
     equal across two launches and bitwise equal to the fixed-point sum of
     the plain selection's terms; a call and the CUDA-graph device time of
     #5 and #6 beside their bound (per pixel its distinct candidate
     distances, per (z, pixel) the selection rounds) and their library
     chains (distances -> ``topk`` -> gather -> weighted sum, or ->
     ``index_add_``);
   - the batched gauge top-k (12 or 8 masks a launch) against single-mask
     launches, its plain version and the CPU path, bitwise (a call and the
     device time, beside the distances -> ``topk`` chain), with the slot
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
     so its time is also printed as ``cublas_chain_ms``; the backward's rate
     against the float32 bound and the 3xTF32 ideal;
   - times the host input pipeline alone on the training store (windows/s);
   - serves the two fake events through ``scripts/infer_torch.py`` with
     ``dk_gauge.json`` and ``stdk_gauge.json``, checks the stores, the launch
     count and a 16-frame event against the port's plain CPU path;
   - trains both configs through ``scripts/train_torch.py`` (batch 12, 15
     steps cut from 200000 iterations, rec-loss only): launch counts of both
     kernels equal to the steps (plus the validation forwards), every
     parameter's last gradient finite and non-zero, and a 6-step resume whose
     last 4 steps run under ``torch.profiler`` (idle share, time by kernel,
     #13's share of the kernel time).
8. The simple family at full width (base 64, T=16, 128x128, seeded weights,
   BatchNorm statistics away from identity; the shipped p2igan configs with
   ``model`` set to ``{"name": "simple", "in_channels": 1, "base_channels":
   64}``):
   - the fused enc0 convolution (enc0_conv3d_leaky, Cin 2 -> 64) and the fused
     dec2 convolution (conv3d_cout1_sigmoid, 64 -> 1) against their plain
     versions (``F.conv3d`` + activation) at the serving chunk (B=8) and at an
     odd shape: |kernel - plain| <= 5e-6 + 1e-5 |plain| (summation order over
     1.3e8 outputs; whether 1e-6 held is printed); both sides' distance to a
     float64 plain version; a call and the device time; the cuDNN chain timed
     as ``library_ms``; and the neighbouring cuDNN layers timed in both 5-D
     memory formats;
   - serves the two fake events through ``scripts/infer_torch.py`` with both
     kernels (2 launches of each an event) and once with dec2 through cuDNN
     (``model.dec2_fused`` false), each against the port's plain CPU path;
     profiles one event (idle share, #14's and #15's share of the kernel
     time) and times its reconstruction with and without cuDNN's deterministic
     flag, in turns (a measurement; the policy stays deterministic);
   - trains 15 rec-loss steps and 15 hinge-GAN steps (against the simple
     BatchNorm critic) at batch 12 through ``scripts/train_torch.py``: every
     parameter's last gradient finite and non-zero, running statistics moved,
     peak device memory, then a 6-step resume whose last 4 steps run under
     ``torch.profiler``.
9. p2igan on masks that vary per frame (stin, fi, nowcasting: the shipped
   configs with ``mask.type`` set in every split; keep 4, block 10, interval
   2..6), through the generic IDW:
   - #8's range (idw_knn_single: the cell search of #9 since this replaced
     the brute-force kernel) at B=12, Q=262144, P=3200 and 4096 on random
     points, sti-lattice points, 2 valid points and an empty sample: out,
     sel_idx and w_norm bitwise equal to the brute-force plain version on the
     card;
   - the cell search (idw_knn_chunked, #9) at B=12 under each mask at the
     config's budget (98304, 67968, 65536 points): the card's cell build
     against its plain version; out, sel_idx and w_norm bitwise equal to the
     brute-force plain version on all 12 samples at fi and on two under stin
     and nowcasting, the linearity identity of its scatter backward, the time
     at B=8 and of the build alone; the same on seven adversarial samples
     (ties on both +-z sides, four-way xy ties, 2 valid, empty, one cell,
     points outside [0, 1], duplicate coordinates); and #9 bitwise equal to #8
     at P=3200. #8-#10's bound counts the certified pairs (no later than
     the query's k-th selected point in the (d, index) order: k a query)
     and prints the all-pairs work beside it;
   - the backward (scatter_selection, #10: the saved selection scattered,
     summed in 64-bit fixed point) at B=12, P=3200: each sample within 1e-5 x
     the largest sum of |terms| a point of it receives, against index_add_
     and against the recomputed selection of the TPU kernel's function;
     bitwise equal across two launches and with the queries permuted; the
     linearity identity <dv, v> == <g, f(v)>; ``index_add_`` of the same
     terms as its ``library_ms``; then on stin's selection (the global path);
   - the torch.cdist -> topk -> gather chain (16384 queries a call; the port
     never calls it) over the whole batch at P=3200 as ``library_ms`` of #8;
     #9's ``library_ms`` is null, the chain's time on one chunk of one fi
     sample printed beside it;
   - the two events served through ``scripts/infer_torch.py`` under each
     mask (launch counts asserted: #9 twice an event, #3 six times, #8
     never), and one window against the plain versions on the card;
   - the generator's gradients at batch 12 on stin masks (#9) and on sti
     masks through ``from_config(cfg, idw_factored=False)`` (P=3200: #8's
     range, #10), every parameter against the plain versions;
   - 15 hinge-GAN steps on stin masks at batch 12 with ``device_decode``
     through ``scripts/train_torch.py`` and a profiled resume (#9's share);
   - the repeat phase: two 5-step runs each of the stis, sti and stin GANs
     and of the generic IDW at P <= 4096 (sti masks, idw_factored off) end
     with bitwise-equal generator, critic and optimizer states and log
     bitwise-equal val/* values (``train.eval_metrics`` on); a third run
     of each under ``torch.use_deterministic_algorithms(True,
     warn_only=True)`` prints every op PyTorch names as having no
     deterministic version; then the stis GAN step with cuDNN's
     deterministic algorithms and without (on, off, off, on; the two
     15-step runs with them must end bitwise equal, the two without are
     compared and printed).
10. Prints the card, a JSON line of the fifteen kernels (time, plain version's
   time, the bound from this run's shapes and what sets it, the library
   chain's time, null only for #9, whose chain fits in no card's memory at
   its batch; launches on the kernel's main path; for #2 and #4 also the
   CUDA-graph device time and its share of the bound), then
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
import warnings
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
from p2igan_tpu_torch.metrics import MetricConfig, RainfallMetricSuite
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
from p2igan_tpu_torch.ops import idw_kernel
from p2igan_tpu_torch.ops.idw import (extract_points, factored_prepare,
                                      factored_prepare_full, gauge_geometry,
                                      idw_3d_factored)
from p2igan_tpu_torch.ops.idw_factored_kernel import (
    combine_dense, combine_dense_reference, combine_table, combine_table_bwd,
    combine_table_bwd_fixed_reference, combine_table_bwd_reference, combine_table_multi,
    combine_table_multi_bwd, combine_table_multi_bwd_fixed_reference,
    combine_table_multi_bwd_reference,
    combine_table_multi_reference, combine_table_reference, distinct_frame_table,
    gauge_topk, gauge_topk_reference, pruned_frame_table)
from p2igan_tpu_torch.ops.idw_kernel import (
    cell_build_reference, idw_cell_build, idw_knn_bwd_reference, idw_knn_chunked,
    idw_knn_chunked_reference, idw_knn_single, idw_knn_single_reference, prep_points,
    scatter_selection, scatter_selection_reference)
from p2igan_tpu_torch.ops.pool_dup import (maxpool2_duplicate,
                                           maxpool2_duplicate_reference)
from p2igan_tpu_torch.ops.wendland import build_phi_space
from p2igan_tpu_torch.training import trainer as trainer_module
from p2igan_tpu_torch.training.checkpoint import load_checkpoint_raw
from p2igan_tpu_torch.training.trainer import device_busy_us
from p2igan_tpu_torch.utils.tracking import get_tracker

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
# masks that vary per frame, with the shipped configs' keep 4, block_sizes [10]
# and interval [2..6]: (type, point budget at full width), the generic IDW
FRAME_MASK_ARGS = {"keep": 4, "block_sizes": [STI_BLOCK], "interval": [2, 3, 4, 5, 6]}
FRAME_MASKS = (("fi", 98304), ("stin", 67968), ("nowcasting", 65536))
# point counts of the single pass (#8, #10): the sti budget with idw_factored
# off (169 gauges a frame: 2704 points), and its limit (a block-8 sti mask:
# 256 gauges a frame, 4096 points)
STI_POINTS = 3200
SINGLE_PASS = ((STI_POINTS, STI_BLOCK), (4096, 8))
GRID = (LENGTH, H, W)
# queries of one library-chain chunk (torch.cdist -> topk -> gather)
LIB_CHUNK = 16384
# H100 SXM data sheet: device memory rate and the float32 rate outside the
# tensor cores (the precision policy keeps TF32 off)
PEAK_BYTES_PER_S, PEAK_FLOPS = 3.35e12, 67e12
# and the dense TF32 tensor-core rate: #13 makes three TF32 passes (3xTF32)
# to keep float32 accuracy, so its ideal beside the float32 bound is 3 x its
# operations at this rate
PEAK_TF32_FLOPS = 495e12
ROTATE_BYTES = 128 << 20  # traffic between two uses of one input in graph_ms: > 2x L2
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
    "idw_knn_single": (idw_knn_single, "p2igan_tpu_torch/csrc/idw_knn_cells.cu",
                       "p2igan_tpu/ops/pallas/idw_kernel.py:140"),
    "idw_knn_chunked": (idw_knn_chunked, "p2igan_tpu_torch/csrc/idw_knn_cells.cu",
                        "p2igan_tpu/ops/pallas/idw_kernel.py:212"),
    "scatter_selection": (scatter_selection, "p2igan_tpu_torch/csrc/idw_scatter.cu",
                          "p2igan_tpu/ops/pallas/idw_kernel.py:355"),
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
# the device kernels of one #9 launch: the cell build, then the search
CELL_SEARCH_KERNELS = ("cell_init_kernel", "cell_count_kernel", "cell_scan_kernel",
                       "cell_scatter_kernel", "cell_decode_kernel", "knn_cells_kernel")
# the device kernels of one #13 launch: the block partials, then their sums
TAIL_BWD_KERNELS = ("dk_mlp_tail_bwd_kernel", "sum_block_partials_kernel")
# and of a #12 launch
TAIL_FWD_KERNEL = "dk_mlp_tail_kernel"
SERVING_KERNELS = ("gauge_topk", "combine_table_multi", "maxpool2_duplicate")
STI_SERVING_KERNELS = ("gauge_topk", "combine_table", "maxpool2_duplicate")
# the path whose launch count each kernel reports in the kernels line
LAUNCH_PATH = {"combine_table": "p2igan sti training",
               "combine_table_bwd": "p2igan sti training",
               "combine_dense": "idw_3d_factored op",
               "idw_knn_single": "p2igan sti single pass gradients",
               "scatter_selection": "p2igan sti single pass gradients",
               "idw_knn_chunked": "p2igan stin training",
               "mlp_tail_fused": "dk training", "mlp_tail_bwd": "dk training",
               "enc0_conv3d_leaky": "simple serving",
               "conv3d_cout1_sigmoid": "simple serving"}
SIMPLE_MODEL = {"name": "simple", "in_channels": 1, "base_channels": BASE}
# the metric suite's default thresholds (mm/h) and FSS scales, and its state
# leaves that are counts
THRESHOLDS, SCALES = MetricConfig().thresholds, MetricConfig().scales
COUNT_LEAVES = ("n_obs", "ssim_n", "hits", "misses", "false", "correct", "counts")
# example images an epoch: one of the train loader, one a validation batch up to 5
VAL_EXAMPLES = 5
# end-to-end rates of this run by path (serving events/s, training steps/s),
# printed side by side at the end
RATES = {}


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
    the float32 rate, whichever is larger. ``library_ms`` defaults to null; a
    check sets it where PyTorch calls compute the kernel's function: #3's
    ``max_pool2d`` -> ``repeat_interleave`` and #12's and #13's cuBLAS chains
    (each its plain version), the fused convolutions' cuDNN chains, the
    ``torch.cdist`` -> ``topk`` -> gather chain of #8 and #10, the combines'
    distances -> ``topk`` -> gather -> weighted sum (#2, #5, #7) and that
    selection -> ``index_add_`` (#4, #6), #1's distances -> ``topk`` and #11's
    elementwise chain (its plain version). Only #9 has none: no chain over
    its batch fits in the card's memory. ``topk`` breaks ties in its own
    order, not the kernels' lowest index, so a chain is a yardstick of
    time, not of bits."""
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
        d_ms = topk_device_ms(args)
        print(f"gauge_topk[{name}] HW={H * W} G={G} k={K}: equal; "
              f"kernel {k_ms:.4f} ms (device {d_ms:.4f} ms, "
              f"{topk_bound(1, G)['bound_ms'] / d_ms:.4f} of the bound), plain {p_ms:.4f} ms")
        if ms is None:
            ms, plain_ms, dev_ms = k_ms, p_ms, d_ms
    # the library chain: all (pixel, slot) distances, then topk
    qx, qy, gx, gy, pen = gauge_geometry(masks["random79"], G)[:5]
    lib_ms = cuda_ms(lambda: torch.topk((qx[:, None] - gx) ** 2 + (qy[:, None] - gy) ** 2
                                        + pen, K, dim=1, largest=False))
    print(f"gauge_topk library chain (distances -> topk): {lib_ms:.4f} ms")
    b_ = topk_bound(1, G)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms, **b_,
            "bound_share": b_["bound_ms"] / dev_ms, "library_ms": lib_ms}


def topk_bound(batch: int, slots: int) -> dict:
    """#1 for ``batch`` masks of ``slots`` slots: two coordinates a pixel and
    three numbers a slot in, k distances and k slot ids a pixel out; 6 flops a
    (pixel, slot) distance and its compare with the k-th place (the one pass;
    its rare entries are not counted)."""
    hw = H * W
    return bound(4 * (2 * hw + 3 * batch * slots + 2 * K * batch * hw),
                 batch * hw * slots * 7)


def topk_device_ms(args) -> float:
    """Device time of one #1 launch on ``args`` (qx, qy, gx, gy, pen) by
    ``graph_ms``, over as many copies of the inputs as make each come back
    after ``ROTATE_BYTES`` of traffic (the inputs read, gd2 and gsel written)."""
    qx, gx = args[0], args[2]
    batch = gx.shape[0] if gx.dim() == 2 else 1
    per_call = 4 * (2 * qx.numel() + 3 * gx.numel() + 2 * K * batch * qx.numel())
    n = -(-ROTATE_BYTES // per_call)
    ins = [args] + [tuple(a.clone() for a in args) for _ in range(n - 1)]
    ms = graph_ms(lambda i: gauge_topk(*ins[i], k=K), n)
    del ins
    return ms


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
        devs = {}
        for n in (WINDOW_BATCH, TRAIN_BATCH):
            tabs = torch.randn((n, LENGTH, G), generator=gen).to(dev)
            devs[n] = combine_device_ms(
                lambda g_, s_, t_: combine_table_multi(g_, s_, t_, K), gd2_t, gsel_t, tabs,
                4 * n * LENGTH * H * W)
        b_ = combine_bound(WINDOW_BATCH)
        print(f"combine_table_multi[{name}] N={WINDOW_BATCH} D={LENGTH} "
              f"HW={H * W} k={K}: max abs err {e:.3e}, bitwise "
              f"{bitwise_equal(out_k, out_p)}, top slots equal; "
              f"kernel {k_ms:.4f} ms (device " + ", ".join(
                  f"N={n} {d_:.4f} ms, {combine_bound(n)['bound_ms'] / d_:.4f} of the bound"
                  for n, d_ in devs.items()) + f"), plain {p_ms:.4f} ms")
        if ms is None:
            ms, plain_ms, dev_ms = k_ms, p_ms, devs[WINDOW_BATCH]
            lib_ms = cuda_ms(lambda: library_combine(gd2_t[None], gsel_t[None], tables,
                                                     shared=True))
            print(f"combine_table_multi library chain (distances -> topk -> gather -> "
                  f"weighted sum) on {name}: {lib_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            **b_, "bound_share": b_["bound_ms"] / dev_ms, "library_ms": lib_ms}


def combine_device_ms(fn, gd2_t, gsel_t, data, out_bytes: int) -> float:
    """Device time of ``fn(gd2_t, gsel_t, data)`` (#2 or #4) by ``graph_ms``,
    over as many copies of the three inputs as make each come back after
    ``ROTATE_BYTES`` of traffic (the inputs read, ``out_bytes`` written)."""
    per_call = out_bytes + 4 * (data.numel() + gd2_t.numel() + gsel_t.numel())
    n = -(-ROTATE_BYTES // per_call)
    ins = [(gd2_t, gsel_t, data)] + [(gd2_t.clone(), gsel_t.clone(), data.clone())
                                     for _ in range(n - 1)]
    ms = graph_ms(lambda i: fn(*ins[i]), n)
    del ins
    return ms


def combine_bound(n: int) -> dict:
    """Forward and backward of the combine move the same bytes: the (k, HW)
    distances and slots, the (N, D, G) tables and the (N, D, HW) field. Per
    (z, pixel): kf*k = 20 candidate distances (8 flops with the sqrt and the
    weight), k selection rounds over them, and 2 k flops a window."""
    hw, cand = H * W, 5 * K
    return bound(4 * (2 * K * hw + n * LENGTH * G + n * LENGTH * hw),
                 LENGTH * hw * (cand * 8 + K * cand + 2 * K * n))


def graph_ms(fn, copies: int, reps: int = 10) -> float:
    """Device time of one call: ``fn(i)`` for i = 0, 1, ... captured in a
    CUDA graph (at least 20 calls, a whole number of rounds over ``copies``
    inputs, every output kept), replayed ``reps`` times, the median replay
    over the calls. No host time between launches, so a kernel of
    microseconds is timed as the device runs it. The caller gives enough
    input copies that each comes back only after ``ROTATE_BYTES`` of other
    traffic, and every call writes a new output, so neither is still in the
    50 MB L2 and the time can be held against a bound at the HBM rate."""
    calls = copies * -(-20 // copies)
    outs = [fn(i) for i in range(copies)]
    torch.cuda.synchronize()
    del outs
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(i % copies) for i in range(calls)]
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del outs, graph
    return statistics.median(times)


def check_pool_dup(dev) -> dict:
    """#3 at the three pyramid shapes of serving (batch 8, the kernels line)
    and of training (batch 12), bitwise equal to its plain version, which is
    the PyTorch chain ``max_pool2d`` -> ``repeat_interleave`` (so
    ``plain_ms`` and ``library_ms`` are the chain's time), NaN and signed zero
    included; a row width that takes the 8-byte form, and more planes than
    grid.z holds (the launch's split). Each shape: the time a call (CUDA
    events around one call, host work included) and the device time
    (``graph_ms``, over input copies that leave L2 between uses), both beside
    the chain's, and the share of the bytes bound. A call of either takes
    tens of microseconds of host and event time for microseconds of device
    work, so the kernels line reports the device times."""
    gen = torch.Generator().manual_seed(SEED)
    result = {}
    for label, batch in (("serving", WINDOW_BATCH), ("training", TRAIN_BATCH)):
        ms = chain_ms = dev_ms = dev_chain_ms = 0.0
        for shape in [(batch,) + s_[1:] for s_ in POOL_SHAPES]:
            x = torch.randn(shape, generator=gen)
            x.view(-1)[::7] = 0.0
            x.view(-1)[1::11] = -0.0
            x.view(-1)[3::101] = float("nan")
            x = x.to(dev)
            out_k, out_p = maxpool2_duplicate(x), maxpool2_duplicate_reference(x)
            if not bitwise_equal(out_k, out_p):
                fail(f"maxpool2_duplicate not bitwise equal at {shape}")
            k_ms = cuda_ms(lambda: maxpool2_duplicate(x), reps=50)
            p_ms = cuda_ms(lambda: maxpool2_duplicate_reference(x), reps=50)
            xs = [x] + [x.clone() for _ in range(-(-ROTATE_BYTES // (6 * x.numel())))]
            kd_ms = graph_ms(lambda i: maxpool2_duplicate(xs[i]), len(xs))
            pd_ms = graph_ms(lambda i: maxpool2_duplicate_reference(xs[i]), len(xs))
            del xs
            b_ms = 4 * 1.5 * x.numel() / PEAK_BYTES_PER_S * 1e3
            print(f"maxpool2_duplicate{shape}: bitwise equal (NaN, +-0); a call: kernel "
                  f"{k_ms:.4f} ms, chain {p_ms:.4f} ms ({p_ms / k_ms:.2f}x); device: "
                  f"kernel {kd_ms:.4f} ms, chain {pd_ms:.4f} ms ({pd_ms / kd_ms:.2f}x); "
                  f"bytes bound {b_ms:.4f} ms, {b_ms / kd_ms:.3f} of it")
            ms, chain_ms = ms + k_ms, chain_ms + p_ms
            dev_ms, dev_chain_ms = dev_ms + kd_ms, dev_chain_ms + pd_ms
        elems = sum(batch * int(np.prod(s_[1:])) for s_ in POOL_SHAPES)
        b_ = bound(4 * elems * 1.5, elems * 0.75)
        print(f"maxpool2_duplicate, the three {label} shapes: a call {ms:.4f} ms, chain "
              f"{chain_ms:.4f} ms; device {dev_ms:.4f} ms, chain {dev_chain_ms:.4f} ms; "
              f"bound {b_['bound_ms']:.5f} ms ({b_['bound_by']}), "
              f"{b_['bound_ms'] / dev_ms:.3f} of it on the device")
        if label == "serving":  # the input once, the output (half as many) once
            result = {"max_abs_err": 0.0, "ms": dev_ms, "plain_ms": dev_chain_ms, **b_,
                      "library_ms": dev_chain_ms}
    x = torch.randn(WINDOW_BATCH, BASE, 10, 6, generator=gen).to(dev)  # W % 4 != 0
    if not bitwise_equal(maxpool2_duplicate(x), maxpool2_duplicate_reference(x)):
        fail("maxpool2_duplicate (8-byte form) not bitwise equal")
    print(f"maxpool2_duplicate{tuple(x.shape)} (rows of 6: the 8-byte form): bitwise equal")
    x = torch.randn(1, 70000, 16, 128, device=dev,  # 70000 planes a block each: split
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    if not bitwise_equal(maxpool2_duplicate(x), maxpool2_duplicate_reference(x)):
        fail("maxpool2_duplicate (planes split over grid.x) not bitwise equal")
    print(f"maxpool2_duplicate{tuple(x.shape)} (more planes than grid.z): bitwise equal")
    return result


def check_combine_bwd(masks) -> dict:
    """Kernel #4 at the training shapes: N=12 windows, D=16, HW=16384: within
    1e-5 x max|plain| of its plain version (64-bit fixed-point sums against
    float32 ones in autograd's order), bitwise equal to its fixed-point model
    (``combine_table_multi_bwd_fixed_reference``: the kernel's exact
    arithmetic in plain PyTorch), across two launches and at the tile budgets
    of one window and of all 12 at the widest row (every slot); a call and
    the device time."""
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
        fixed = combine_table_multi_bwd_fixed_reference(gd2_t, gsel_t, g, G, K)
        if not bitwise_equal(out_k, fixed):
            fail(f"combine_table_multi_bwd is not bitwise its fixed-point model on {name}: "
                 f"{int((out_k != fixed).sum())} of {out_k.numel()} differ")
        widest = 8 * idw_factored_kernel.bwd_widest_row(LENGTH, G, K)
        for tile_bytes in (None, 0, widest * TRAIN_BATCH):
            again = combine_table_multi_bwd(gd2_t, gsel_t, g, G, K, tile_bytes=tile_bytes)
            if not bitwise_equal(again, out_k):
                fail(f"combine_table_multi_bwd on {name} does not repeat bit for bit "
                     f"(tile budget {tile_bytes})")
        k_ms = cuda_ms(lambda: combine_table_multi_bwd(gd2_t, gsel_t, g, G, K))
        d_ms = combine_device_ms(lambda g_, s_, c_: combine_table_multi_bwd(g_, s_, c_, G, K),
                                 gd2_t, gsel_t, g, 4 * TRAIN_BATCH * LENGTH * G)
        p_ms = cuda_ms(lambda: combine_table_multi_bwd_reference(gd2_t, gsel_t, g, G, K),
                       reps=5)
        b_ = combine_bound(TRAIN_BATCH)
        print(f"combine_table_multi_bwd[{name}] N={TRAIN_BATCH} D={LENGTH} "
              f"HW={H * W} G={G} k={K}: max abs err {e:.3e} "
              f"({e / scale:.2e} x max|plain| {scale:.3f}); bitwise equal to the "
              f"fixed-point model, across two launches and at tile budgets of one window "
              f"and of all; kernel {k_ms:.4f} ms (device {d_ms:.4f} ms, "
              f"{b_['bound_ms'] / d_ms:.4f} of the bound), plain {p_ms:.4f} ms")
        if ms is None:
            ms, plain_ms, dev_ms = k_ms, p_ms, d_ms
            lib_ms = cuda_ms(lambda: library_combine_bwd(gd2_t[None], gsel_t[None], g, G,
                                                         shared=True))
            print(f"combine_table_multi_bwd library chain (selection -> index_add_) on "
                  f"{name}: {lib_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            **b_, "bound_share": b_["bound_ms"] / dev_ms, "library_ms": lib_ms}


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
    # device times by graph replay, over input copies that leave L2 between uses
    n = -(-ROTATE_BYTES // (u8.size * 9 + mask.size))
    ins = [(u8_d, mask_d)] + [(u8_d.clone(), mask_d.clone()) for _ in range(n - 1)]
    d_ms = graph_ms(lambda i: decode_normalize_mask(*ins[i]), n)
    dp_ms = graph_ms(lambda i: decode_normalize_mask_reference(*ins[i]), n)
    del ins
    # a byte and (once per plane) a mask byte in, two floats out; 2 flops. The
    # plain version is the elementwise chain (convert, divide, multiply)
    b_ = bound(u8.size * 9 + mask.size, u8.size * 2)
    gbs = (u8.size * 9 + mask.size) / (d_ms * 1e-3) / 1e9
    print(f"decode_normalize_mask{u8.shape} mask {mask.shape}: bitwise equal to "
          f"numpy (kernel and plain); kernel {k_ms:.4f} ms a call (device {d_ms:.5f} ms, "
          f"{gbs:.0f} GB/s, {b_['bound_ms'] / d_ms:.4f} of the bound "
          f"{b_['bound_ms']:.5f} ms), plain (the elementwise chain) {p_ms:.4f} ms a call "
          f"(device {dp_ms:.5f} ms)")
    return {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, "device_ms": d_ms, **b_,
            "bound_share": b_["bound_ms"] / d_ms, "library_ms": p_ms,
            "library_device_ms": dp_ms}


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
        dev_ms = topk_device_ms(args)
        b_ = topk_bound(batch, slots)
        # the library chain: every (sample, pixel, slot) distance, then topk
        qx, qy, gx, gy, pen = args
        lib_ms = cuda_ms(lambda: torch.topk(
            (qx[None, :, None] - gx[:, None]) ** 2 + (qy[None, :, None] - gy[:, None]) ** 2
            + pen[:, None], K, dim=2, largest=False), reps=10)
        print(f"gauge_topk[sti {label}] B={batch} masks, {n_gauges} gauges in G={slots} "
              f"slots: equal to the plain version, to {batch} single launches and to "
              f"the CPU path (bitwise); one launch {one_ms:.4f} ms (device {dev_ms:.4f} ms, "
              f"{b_['bound_ms'] / dev_ms:.4f} of the bound), {batch} launches "
              f"{loop_ms:.4f} ms, plain {plain_ms:.4f} ms, library chain (distances -> "
              f"topk) {lib_ms:.4f} ms, bound {b_['bound_ms']:.5f} ms "
              f"({b_['bound_by']}); slot geometry on the device {geo_ms:.4f} ms, on the "
              f"host (copy, numpy, upload; {batch} masks) {host_ms:.4f} ms")


def sample_combine_bound(batch: int, slots: int) -> dict:
    """Forward and backward of the per-sample combine move the same bytes:
    (B, k, HW) distances and slots, (B, D, G) tables (or their gradient), the
    (B, D, HW) field (or its cotangent). The work no version can avoid: per
    (sample, pixel) the nv*k distinct candidate distances (an add and a sqrt
    each; nv distinct squared z-distances, ``distinct_frame_table``), and per
    (sample, z, pixel) k rounds over the kf*k candidates (a compare each), k
    weights (add, divide, multiply, sum), 2 k operations of values and one
    division."""
    hw = H * W
    vals, vmap = distinct_frame_table(LENGTH, K)
    nv, kf = vals.numel(), vmap.shape[1]
    per_pixel = 2 * nv * K + LENGTH * (K * kf * K + 4 * K + 2 * K + 1)
    return bound(4 * batch * (2 * K * hw + LENGTH * slots + LENGTH * hw),
                 batch * hw * per_pixel)


def library_selection(gd2_t: torch.Tensor, gsel_t: torch.Tensor, slots: int):
    """The library chains' selection for (B, k, HW) gauge distances and
    slots: every (z, pixel)'s kf*k candidate distances over the pruned frames
    at once, ``torch.topk`` of the k smallest, the IDW weights normalized.
    Returns the (B, D, HW, k) targets frame * G + slot and weights. ``topk``
    orders ties its own way, not by the lowest candidate as the kernels do."""
    sel, fd2 = pruned_frame_table(LENGTH, K, str(gd2_t.device))
    B, kf = gd2_t.shape[0], sel.shape[1]
    cd = torch.sqrt(gd2_t.transpose(1, 2)[:, None, :, None, :]
                    + fd2.view(LENGTH, kf, K)[None, :, None])          # (B, D, HW, kf, k)
    d, c = torch.topk(cd.clamp_max(1e15).flatten(3), K, dim=-1, largest=False)
    w = torch.where(d < 1e15, (d + 0.05).reciprocal().square(), 0.0)
    w = w / (w.sum(-1, keepdim=True) + 1e-12)
    hw = gd2_t.shape[2]
    frame = torch.gather(sel[None, :, None, :].expand(B, LENGTH, hw, kf), -1, c // K)
    slot = torch.gather(gsel_t.transpose(1, 2)[:, None].expand(B, LENGTH, hw, K), -1, c % K)
    return frame * slots + slot, w


def library_combine(gd2_t, gsel_t, tables, shared: bool = False):
    """The combine as PyTorch calls: ``library_selection`` -> gather ->
    weighted sum; ``shared``: one selection for every window (#2)."""
    N = tables.shape[0]
    off, w = library_selection(gd2_t, gsel_t, tables.shape[2])
    if shared:
        off, w = off.expand(N, *off.shape[1:]), w.expand(N, *w.shape[1:])
    vals = torch.gather(tables.reshape(N, -1), 1, off.reshape(N, -1)).view_as(w)
    return (w * vals).sum(-1)


def library_combine_bwd(gd2_t, gsel_t, g, slots: int, shared: bool = False):
    """The combine's backward as PyTorch calls: ``library_selection`` ->
    terms w * g -> ``index_add_`` into the (N, D, G) tables."""
    N = g.shape[0]
    off, w = library_selection(gd2_t, gsel_t, slots)
    plane = LENGTH * slots
    base = torch.arange(N, device=g.device)[:, None, None, None] * plane
    out = torch.zeros((N * plane,), device=g.device)
    return out.index_add_(0, (off + base).reshape(-1),
                          (w * g[..., None]).reshape(-1)).view(N, LENGTH, slots)


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
        g_ms = graph_ms(lambda i: combine_table(gd2_t, gsel_t, tables, K), 1)
        p_ms = cuda_ms(lambda: combine_table_reference(gd2_t, gsel_t, tables, K),
                       reps=3, warmup=1)
        lib_ms = cuda_ms(lambda: library_combine(gd2_t, gsel_t, tables))
        b_ = sample_combine_bound(batch, slots)
        print(f"combine_table[{label}] B={batch} D={LENGTH} HW={H * W} G={slots} k={K}: "
              f"bitwise equal; kernel {k_ms:.4f} ms (device {g_ms:.4f} ms, "
              f"{b_['bound_ms'] / g_ms:.4f} of the bound), plain {p_ms:.4f} ms, library "
              f"chain {lib_ms:.4f} ms, bound {b_['bound_ms']:.5f} ms ({b_['bound_by']})")
        if not result:
            result = {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, **b_,
                      "library_ms": lib_ms}
    return result


def check_combine_table_bwd(dev) -> dict:
    """Kernel #6 at the same three shapes: max abs error <= 1e-5 x max|plain|
    (64-bit fixed-point sums against float32 ones in autograd's order),
    bitwise equal across two launches, and bitwise equal to the fixed-point
    model of the plain selection's terms (``combine_table_bwd_fixed_reference``:
    the kernel's exact arithmetic in plain PyTorch)."""
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
        if not bitwise_equal(out_k, again):
            fail(f"combine_table_bwd does not repeat bit for bit ({label})")
        fixed = combine_table_bwd_fixed_reference(gd2_t, gsel_t, g, slots, K)
        if not bitwise_equal(out_k, fixed):
            fail(f"combine_table_bwd is not bitwise its fixed-point model ({label}): "
                 f"{int((out_k != fixed).sum())} of {out_k.numel()} differ")
        k_ms = cuda_ms(lambda: combine_table_bwd(gd2_t, gsel_t, g, slots, K))
        g_ms = graph_ms(lambda i: combine_table_bwd(gd2_t, gsel_t, g, slots, K), 1)
        p_ms = cuda_ms(lambda: combine_table_bwd_reference(gd2_t, gsel_t, g, slots, K),
                       reps=3, warmup=1)
        lib_ms = cuda_ms(lambda: library_combine_bwd(gd2_t, gsel_t, g, slots))
        b_ = sample_combine_bound(batch, slots)
        print(f"combine_table_bwd[{label}] B={batch} D={LENGTH} HW={H * W} G={slots} "
              f"k={K}: max abs err {e:.3e} ({e / scale:.2e} x max|plain| {scale:.3f}), "
              f"bitwise equal across two launches and to the fixed-point model; kernel "
              f"{k_ms:.4f} ms (device {g_ms:.4f} ms, {b_['bound_ms'] / g_ms:.4f} of the "
              f"bound), plain {p_ms:.4f} ms, library chain {lib_ms:.4f} ms, bound "
              f"{b_['bound_ms']:.5f} ms ({b_['bound_by']})")
        if not result:
            result = {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, **b_,
                      "library_ms": lib_ms}
    return result


def dense_case(dev, block: int, slots: int, gen) -> tuple:
    """(gd2_t (K, HW), cvals_t (LENGTH*K, HW)), #7's inputs: one (16, 128, 128)
    window of random values under a sti mask of ``block`` (``slots`` gauge
    slots), its candidate values gathered from the field as ``factored_apply``
    gathers them."""
    mask = sti_masks(dev, 1, block)[0]
    values = torch.randn((LENGTH, H * W), generator=gen).to(dev)
    gd2, gpix = factored_prepare(mask, slots, k=K)
    cvals_t = values[:, gpix.long()].permute(0, 2, 1).reshape(LENGTH * K, H * W).contiguous()
    return gd2.t().contiguous(), cvals_t


def dense_bound() -> dict:
    """#7's bound: gd2 (k, HW) and cvals (D*k, HW) in, (D, HW) out; per (z,
    pixel) kf*k = 20 candidate distances (8 flops with the sqrt and the
    weight), k selection rounds over them and 2 k flops."""
    hw, cand = H * W, 5 * K
    return bound(4 * hw * (K + LENGTH * K + LENGTH), LENGTH * hw * (cand * 8 + K * cand + 2 * K))


def dense_copies(gd2_t, cvals_t) -> list:
    """(gd2_t, cvals_t) and as many copies as make each come back to #7 only
    after ``ROTATE_BYTES`` of traffic (its inputs read, its output written)."""
    per_call = 4 * (gd2_t.numel() + cvals_t.numel() + cvals_t.shape[0] // K * cvals_t.shape[1])
    return [(gd2_t, cvals_t)] + [(gd2_t.clone(), cvals_t.clone())
                                 for _ in range(-(-ROTATE_BYTES // per_call) - 1)]


def check_combine_dense(dev) -> dict:
    """Kernel #7 under a block-10 and a block-4 sti mask (``dense_case``):
    bitwise equal to its plain version; a call, the device time by
    ``graph_ms`` over input copies that leave L2 between uses and its share
    of the bytes bound, beside the plain version and the library chain. The
    kernels line reports the first."""
    gen = torch.Generator().manual_seed(SEED + 2)
    hw = H * W
    result = {}
    for block, slots in ((STI_BLOCK, STI_G), (STI_DENSE_BLOCK, STI_DENSE_G)):
        gd2_t, cvals_t = dense_case(dev, block, slots, gen)
        out_k = combine_dense(gd2_t, cvals_t, K)
        out_p = combine_dense_reference(gd2_t, cvals_t, K)
        torch.cuda.synchronize()
        e = float((out_k - out_p).abs().max())
        if not bitwise_equal(out_k, out_p):
            fail(f"combine_dense not bitwise equal to its plain version (block {block}): "
                 f"max abs err {e}")
        k_ms = cuda_ms(lambda: combine_dense(gd2_t, cvals_t, K))
        ins = dense_copies(gd2_t, cvals_t)
        g_ms = graph_ms(lambda i: combine_dense(*ins[i], K), len(ins))
        del ins
        p_ms = cuda_ms(lambda: combine_dense_reference(gd2_t, cvals_t, K), reps=5)
        lib_ms = cuda_ms(lambda: library_combine_dense(gd2_t, cvals_t))
        b_ = dense_bound()
        print(f"combine_dense[block {block}] D={LENGTH} HW={hw} k={K}: bitwise equal; "
              f"kernel {k_ms:.4f} ms (device {g_ms:.5f} ms, {b_['bound_ms'] / g_ms:.4f} of "
              f"the bound), plain {p_ms:.4f} ms, library chain {lib_ms:.4f} ms, bound "
              f"{b_['bound_ms']:.5f} ms ({b_['bound_by']})")
        if not result:
            result = {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, "device_ms": g_ms,
                      **b_, "bound_share": b_["bound_ms"] / g_ms, "library_ms": lib_ms}
    return result


def library_combine_dense(gd2_t, cvals_t):
    """#7 as PyTorch calls: ``library_selection`` of the one window, then
    gather of the candidate values (row frame * k + s of cvals_t) and the
    weighted sum."""
    slot = torch.arange(K, dtype=torch.int32, device=gd2_t.device)[:, None].expand_as(gd2_t)
    off, w = library_selection(gd2_t[None], slot[None].contiguous(), K)
    vals = torch.gather(cvals_t.t(), 1, off[0].permute(1, 0, 2).reshape(gd2_t.shape[1], -1))
    return (w[0] * vals.view(-1, LENGTH, K).transpose(0, 1)).sum(-1)


def run_idw_3d_factored(dev) -> dict:
    """The path of kernel #7: ``idw_3d_factored`` (no model calls it, in either
    package) on one full-size window under a block-10 sti mask, forward and
    backward. The card's field equals the CPU path's bit for bit, its gradient
    to the values (autograd of the plain version, on the card) within 1e-5 x
    max. Then the forward's device time by ``graph_ms`` over input copies
    that leave L2 between uses, and its parts: ``factored_prepare`` (the gauge
    geometry, #1 and the slot sort), the candidate gather of
    ``factored_apply`` (with the layouts #7 takes) and #7 itself."""
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

    mask, field = mask.to(dev), values.to(dev)
    gd2, gpix = factored_prepare(mask, STI_G, k=K)

    def gather(f, g, p):
        cvals_t = f.reshape(LENGTH, H * W)[:, p.long()].permute(0, 2, 1)
        return g.t().contiguous(), cvals_t.reshape(LENGTH * K, H * W).contiguous()

    # as many copies of every part's inputs as #7's own traffic needs (the op
    # and the gather move more a call; factored_prepare less, from a 64 KB mask)
    dense = dense_copies(*gather(field, gd2, gpix))
    n = len(dense)
    ins = [(mask, field, gd2, gpix)] + [tuple(t.clone() for t in (mask, field, gd2, gpix))
                                        for _ in range(n - 1)]
    with torch.no_grad():
        parts = {"op": graph_ms(lambda i: idw_3d_factored(ins[i][0], ins[i][1], STI_G, k=K), n),
                 "factored_prepare": graph_ms(lambda i: factored_prepare(ins[i][0], STI_G, k=K),
                                              n),
                 "gather": graph_ms(lambda i: gather(*ins[i][1:]), n),
                 "combine_dense": graph_ms(lambda i: combine_dense(*dense[i], K), n)}
    del ins, dense
    print(f"idw_3d_factored forward, device ms by graph replay: the op {parts['op']:.5f}; "
          + ", ".join(f"{k_} {v:.5f} ({v / parts['op']:.3f})" for k_, v in parts.items()
                      if k_ != "op")
          + f"; #7's share of the op {parts['combine_dense'] / parts['op']:.3f}")
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
                       idw_factored=True, idw_shared_batch_mask=True,
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


def stores_equal(a: Path, b: Path) -> bool:
    """Two served zarr stores hold the same events, bit for bit."""
    sa, sb = zarrlite.open(a, mode="r"), zarrlite.open(b, mode="r")
    return sa.array_keys() == sb.array_keys() and all(
        sa[key][:].tobytes() == sb[key][:].tobytes() for key in sa.array_keys())


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
    if not stores_equal(tmp / f"warmup_{model}.zarr", Path(out)):
        fail(f"{model}: two serving runs on the same input wrote different bits")
    print(f"{model}: the warm-up run and the measured run wrote bitwise-equal stores")
    RATES[f"{model} serving"] = EVENTS / seconds
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
    """Route the generator through the plain versions of the combines, the
    generic IDW and the pool (the modules look them up at call time), e.g. on
    the card."""
    swaps = ((idw_factored_kernel, "combine_table_multi", combine_table_multi_reference),
             (idw_factored_kernel, "combine_table", combine_table_reference),
             (idw_kernel, "idw_knn_single", idw_knn_single_reference),
             (idw_kernel, "idw_knn_chunked", idw_knn_chunked_reference),
             (idw_kernel, "scatter_selection", scatter_selection_reference),
             (layers, "maxpool2_duplicate", maxpool2_duplicate_reference))
    saved = [getattr(module, name) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), fn in zip(swaps, saved):
            setattr(module, name, fn)


# the kernels a generator forward and backward must launch, by mask
GRADIENT_KERNELS = {"stis": ("combine_table_multi", "combine_table_multi_bwd"),
                    "sti": ("gauge_topk", "combine_table", "combine_table_bwd"),
                    "sti single pass": ("idw_knn_single", "scatter_selection"),
                    "stin": ("idw_knn_chunked", "scatter_selection")}


def check_gradients(dev, mode: str = "stis") -> dict:
    """One full-width generator forward and backward at batch 12: the
    autograd Functions must carry the gradient back to ``input.*`` (the
    attention blocks before the IDW) and ``Convsin.*`` (reached only through
    the first pool). Gradients are held against the same computation through
    the plain versions on the card, within 1e-4 x max|grad|: cuDNN's backward
    and the IDW backwards' reordered sums change the last bits. ``input.*``
    on the factored paths, every parameter on the generic ones.

    ``stis``: one shared 79-gauge mask, the selection hoisted (#2, #4);
    ``sti``: every sample under its own block-10 mask, the gauge selection
    inside the forward (#1, #5, #6); ``sti single pass``: the same masks
    through the generic IDW, as ``from_config(cfg, idw_factored=False)``
    builds it (P = 3200: #8's range forward, #10 backward); ``stin``: a stin
    mask a sample, 67968 points (#9 forward, #10 backward). Returns the
    launches."""
    rng = np.random.default_rng(SEED + 5)
    if mode == "stis":
        flat = np.zeros(H * W, np.float32)
        flat[rng.choice(H * W, 79, replace=False)] = 1.0
        mask_xy = flat.reshape(1, H, W)
    elif mode == "stin":
        mask_xy = None
        masks_np = frame_masks("stin", TRAIN_BATCH, SEED + 5)
    else:
        mask_xy = sti_masks("cpu", TRAIN_BATCH, STI_BLOCK, seed=SEED + 5).numpy()
    if mask_xy is not None:
        masks_np = np.broadcast_to(mask_xy[:, None, :, :, None],
                                   (TRAIN_BATCH, LENGTH, H, W, 1)).copy()
    masks = torch.from_numpy(masks_np).to(dev)
    frames = torch.from_numpy(rng.random((TRAIN_BATCH, LENGTH, H, W, 1),
                                         dtype=np.float32)).to(dev)
    required = GRADIENT_KERNELS[mode]
    seeded = {"generator": torch.Generator().manual_seed(SEED), "device": dev}
    if mode == "sti single pass":
        gen = P2IGenerator.from_config(sti_config(load_config(STI_TRAIN_CONFIG)),
                                       idw_factored=False, **seeded)
        if (gen.idw_factored, gen.idw_max_points, gen.base_channels) != \
                (False, STI_POINTS, BASE):
            fail(f"from_config(idw_factored=False) on sti built {gen.idw_max_points} points")
    else:
        idw_args = {"stis": {"idw_factored": True, "idw_shared_batch_mask": True},
                    "sti": {"idw_factored": True, "idw_max_points": LENGTH * STI_G},
                    "stin": {"idw_max_points": dict(FRAME_MASKS)["stin"]}}[mode]
        gen = P2IGenerator(H=H, W=W, length=LENGTH, num_res=NUM_RES, base_channels=BASE,
                           **seeded, **idw_args)
    kw = {"idw_prepared": gen.prepare_idw(masks[0, 0, :, :, 0])} if mode == "stis" else {}

    def grads():
        gen.zero_grad(set_to_none=True)
        preds = gen(frames * masks, masks, **kw)
        loss, _ = reconstruction_loss(preds, frames, 0.05)
        loss.backward()
        torch.cuda.synchronize()
        return {n: (None if p.grad is None else p.grad.detach().clone())
                for n, p in gen.named_parameters()}

    reset_launches()
    t0 = time.perf_counter()
    got = grads()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for name in required + ("maxpool2_duplicate",):
        if launches[name] <= 0:
            fail(f"the generator backward ({mode}) launched no {name} kernel")
    for name, g in got.items():
        if g is None or not bool(torch.isfinite(g).all()):
            fail(f"generator parameter {name} has no finite gradient ({mode})")
    generic = not gen.idw_factored
    for name, g in got.items():
        if (generic or name.startswith(("input.", "Convsin."))) and \
                float(g.abs().max()) == 0.0:
            fail(f"generator parameter {name} has a zero gradient ({mode})")
    with plain_versions():
        want = grads()
    worst = 0.0
    for name, g in got.items():
        if generic or name.startswith("input."):
            scale = float(want[name].abs().max())
            rel = float((g - want[name]).abs().max()) / scale
            worst = max(worst, rel)
            if not rel <= 1e-4:
                fail(f"{name} gradient differs from the plain path by {rel:.2e} x max ({mode})")
    checked = "every parameter" if generic else "input.*"
    print(f"gradients at batch {TRAIN_BATCH} ({mode}, {gen.idw_max_points} IDW points): "
          f"all {len(got)} generator parameters finite, "
          f"{'all' if generic else 'input.* and Convsin.*'} non-zero; {checked} vs plain "
          f"versions on the card: max {worst:.2e} x max|grad|; forward + backward "
          f"{seconds:.3f} s; launches {launches}")
    return launches


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
        block = layers.InputBlock(LENGTH, max_points=LENGTH * STI_G, factored=True,
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
    """The GAN through scripts/train_torch.py, with device_decode off and on,
    and with ``train.eval_metrics``: the validation pass runs the metric
    suite on the card, the epoch writes its example images
    (``check_evaluation``); then the validation pass timed with the suite and
    without."""
    train_torch = load_script("train_torch")
    base_cfg = write_train_tree(tmp)
    base_cfg["train"]["eval_metrics"] = True
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
        RATES["p2igan stis GAN" + (" device_decode" if decode else "")] = sps
        check_evaluation(trainer, f"GAN training (device_decode={decode})")
        if not decode:
            time_validation(trainer, card)
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
            print_kernel_share(prof, "p2igan stis GAN", STIS_KERNEL_ROWS, "#2 + #4")
    return launches


def stis_rate(tmp: Path, dev, label: str, deterministic: bool) -> tuple:
    """(GAN steps/s, latest.ckpt) of the stis GAN (device_decode off, 5
    warm-up + 10 timed steps) with cuDNN's deterministic flag as given: the
    trainer's precision policy sets it, so for ``deterministic`` False the
    policy is wrapped for this run only (a measurement, not a program
    switch)."""
    train_torch = load_script("train_torch")
    cfg = write_train_tree(tmp)
    cfg["save_dir"] = str(tmp / f"weights_{label}")
    cfg_path = tmp / f"train_{label}.json"
    cfg_path.write_text(json.dumps(cfg))
    policy = trainer_module.set_precision_policy

    def without_deterministic_cudnn():
        policy()
        torch.backends.cudnn.deterministic = False

    if not deterministic:
        trainer_module.set_precision_policy = without_deterministic_cudnn
    try:
        trainer = train_torch.main(train_torch.parse_args(
            ["--config", str(cfg_path), "--device", dev.type, "--log-level", "WARNING"]))
        torch.cuda.synchronize()
        if torch.backends.cudnn.deterministic != deterministic:
            fail(f"cuDNN's deterministic flag is {torch.backends.cudnn.deterministic}")
    finally:
        trainer_module.set_precision_policy = policy
        set_precision_policy()
    (s0, t_0), (s1, t_1) = trainer.log_times[0], trainer.log_times[-1]
    return (s1 - s0) / (t_1 - t_0), Path(cfg["save_dir"]) / "latest.ckpt"


def deterministic_cudnn_cost(tmp: Path, card: str, dev) -> None:
    """The stis GAN step with cuDNN's deterministic algorithms (the precision
    policy) and without, in turns: on, off, off, on; and whether the two
    15-step runs of each end with bitwise-equal checkpoints (required with
    the flag, printed without it)."""
    rates, ckpts = {True: [], False: []}, {True: [], False: []}
    for i, det in enumerate((True, False, False, True)):
        sps, ckpt = stis_rate(tmp, dev, f"cudnn_det{int(det)}_{i}", det)
        rates[det].append(sps)
        ckpts[det].append(load_checkpoint_raw(ckpt))
    same = {det: not same_bits(*ckpts[det]) for det in ckpts}
    if not same[True]:
        fail("two 15-step stis GAN runs with deterministic cuDNN ended with different bits")
    on, off = statistics.mean(rates[True]), statistics.mean(rates[False])
    RATES["p2igan stis GAN, cuDNN not deterministic"] = off
    print(f"deterministic cuDNN: stis GAN {on:.4f} steps/s with it ({rates[True]}), "
          f"{off:.4f} without ({rates[False]}): {(on / off - 1) * 100:+.2f}% on {card}; "
          f"two 15-step runs end bitwise equal: {same[True]} with it, {same[False]} "
          f"without")


@contextlib.contextmanager
def generic_idw():
    """``P2IGenerator.from_config`` builds the generic IDW, as
    ``from_config(cfg, idw_factored=False)`` does: the trainer then runs
    #8's range and #10 on sti masks (P = 3200)."""
    build = P2IGenerator.from_config.__func__
    P2IGenerator.from_config = classmethod(
        lambda cls, config, **kw: build(cls, config, **{"idw_factored": False, **kw}))
    try:
        yield
    finally:
        P2IGenerator.from_config = classmethod(build)


def tensors_of(obj, prefix=""):
    """Every tensor (and other leaf) of a checkpoint payload by its path."""
    if isinstance(obj, dict):
        for key, val in obj.items():
            yield from tensors_of(val, f"{prefix}/{key}")
    elif isinstance(obj, (list, tuple)):
        for i, val in enumerate(obj):
            yield from tensors_of(val, f"{prefix}/{i}")
    else:
        yield prefix, obj


def same_bits(a, b) -> list:
    """(path, max abs difference or None) where two checkpoint payloads
    differ (tensors by their bytes)."""
    la, lb = dict(tensors_of(a)), dict(tensors_of(b))
    if la.keys() != lb.keys():
        return [(key, None) for key in sorted(set(la) ^ set(lb))]
    diff = []
    for key, x in la.items():
        y = lb[key]
        if isinstance(x, torch.Tensor):
            same = (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and x.numpy().tobytes() == y.numpy().tobytes())
        else:
            same = x == y
        if not same:
            diff.append((key, float((x.double() - y.double()).abs().max())
                         if isinstance(x, torch.Tensor) and x.shape == y.shape else None))
    return diff


REPEAT_STEPS = 5


def repeat_configs(tmp: Path) -> dict:
    """(config, context, kernels the run must launch) of each p2igan training
    path the repeat phase runs twice."""
    stin = frame_config(write_train_tree(tmp, STI_TRAIN_CONFIG), "stin")
    stin["data"]["train"]["device_decode"] = True
    sti = sti_config(write_train_tree(tmp, STI_TRAIN_CONFIG))
    return {"stis GAN": (write_train_tree(tmp), contextlib.nullcontext,
                         ("combine_table_multi", "combine_table_multi_bwd")),
            "sti GAN": (sti, contextlib.nullcontext, ("combine_table", "combine_table_bwd")),
            "stin GAN": (stin, contextlib.nullcontext, ("idw_knn_chunked", "scatter_selection")),
            "generic P<=4096 GAN": (json.loads(json.dumps(sti)), generic_idw,
                                    ("idw_knn_single", "scatter_selection"))}


def train_repeat(tmp: Path, card: str, dev) -> None:
    """Two training runs of each p2igan path (``REPEAT_STEPS`` hinge-GAN steps
    at batch 12, same seed and data, through scripts/train_torch.py) end with
    bitwise-equal generator, critic and optimizer states in latest.ckpt: the
    stis GAN, the sti GAN, the stin GAN (device_decode) and the generic IDW at
    P <= 4096 on sti masks (#8's range, #10), and log bitwise-equal val/*
    values (``train.eval_metrics`` on). First one more run of each under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: every op
    PyTorch flags as having no deterministic version on the card is
    printed."""
    train_torch = load_script("train_torch")
    for label, (cfg, context, required) in repeat_configs(tmp).items():
        named = set()
        cfg["train"].update(iterations=REPEAT_STEPS, log_step=REPEAT_STEPS, eval_metrics=True)
        tag = "repeat_" + label.replace(" ", "_").replace("<=", "le")
        payloads, val_logs = [], []
        t0 = time.perf_counter()
        for run in ("warn", "a", "b"):
            cfg["save_dir"] = str(tmp / f"weights_{tag}_{run}")
            cfg_path = tmp / f"train_{tag}_{run}.json"
            cfg_path.write_text(json.dumps(cfg))
            argv = ["--config", str(cfg_path), "--device", dev.type, "--log-level", "WARNING"]
            reset_launches()
            with context(), warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if run == "warn":
                    torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    trainer = train_torch.main(train_torch.parse_args(argv))
                    torch.cuda.synchronize()
                finally:
                    torch.use_deterministic_algorithms(False)
            if trainer.global_step != REPEAT_STEPS:
                fail(f"{label}: the repeat run trained {trainer.global_step} steps")
            launches = read_launches()
            for name in required:
                if launches[name] <= 0:
                    fail(f"{label}: the repeat run launched no {name}")
            if run == "warn":
                named |= {" ".join(str(w.message).split())[:240] for w in caught
                          if "deterministic" in str(w.message)}
            else:
                payloads.append(load_checkpoint_raw(Path(cfg["save_dir"]) / "latest.ckpt"))
                val_logs.append(read_logged(get_tracker().run_dir))
        print(f"repeat {label}: under torch.use_deterministic_algorithms(True, "
              f"warn_only=True) PyTorch flagged {len(named)} op(s)"
              + "".join(f"\n  {msg}" for msg in sorted(named)))
        diff = same_bits(*payloads)
        n = len(dict(tensors_of(payloads[0])))
        if diff:
            fail(f"{label}: two training runs differ in {len(diff)} of {n} checkpoint "
                 f"entries (path, max abs difference): {diff[:8]}")
        if not val_logs[0] or val_logs[0] != val_logs[1]:
            fail(f"{label}: the two runs logged validation metrics {val_logs}")
        print(f"repeat {label}: two {REPEAT_STEPS}-step runs at batch {TRAIN_BATCH} end "
              f"with bitwise-equal checkpoints (all {n} entries: generator, critic, both "
              f"optimizers) and log bitwise-equal val/* values (all {len(val_logs[0])} "
              f"keys, eval_metrics on); three runs {time.perf_counter() - t0:.1f} s")


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


STI_KERNEL_ROWS = ("gauge_topk_kernel", "combine_table_kernel", "combine_table_bwd_kernel",
                   "row_absmax_kernel", "fixed_finish_kernel")
# the device kernels of #2 and #4 on the stis path (#1 runs once a mask, before
# the profiled steps; #4's sums take the fixed-point kernels)
STIS_KERNEL_ROWS = ("combine_table_multi_kernel", "combine_table_multi_bwd_kernel",
                    "row_absmax_kernel", "fixed_finish_kernel")


def train_sti(tmp: Path, card: str, dev, decode: bool) -> tuple:
    """The hinge GAN on p2igan_gan_baseline.json with sti masks (batch 12, a
    mask a sample) through scripts/train_torch.py: 15 steps, every one with
    its own gauge top-k (#1, one launch for the 12 masks), combine (#5) and
    combine backward (#6); the validation and example forwards add #1 and
    #5. With
    ``decode`` the raw pipeline ships uint8 frames and one mask frame a sample
    through #11. Then the profiled resume: idle share and the four kernels'
    share of the device time."""
    cfg = sti_config(write_train_tree(tmp, STI_TRAIN_CONFIG))
    cfg["data"]["train"]["device_decode"] = decode
    label = "p2igan sti GAN" + (" device_decode" if decode else "")
    launches, sps = train_family(tmp, card, dev, label, cfg, lambda steps, fwd: {
        "gauge_topk": steps + fwd, "combine_table": steps + fwd,
        "combine_table_bwd": steps, "maxpool2_duplicate": 3 * (steps + fwd),
        **({"decode_normalize_mask": None} if decode else {})})
    print_kernel_share(tmp / f"profile_{label.replace(' ', '_')}", label, STI_KERNEL_ROWS,
                       "#1 + #5 + #6")
    return launches, sps


def print_kernel_share(prof: Path, label: str, rows, what: str) -> None:
    """The share of the kernels ``rows`` in the kernel time of a trainer's
    profiled steps; fails if the profile shows one of them no time."""
    summary = json.loads((prof / "summary.json").read_text())
    total = sum(summary["kernel_ms"].values())
    # a kernel's rows: its name, then its arguments or its template arguments
    ours = {row: sum(ms for key, ms in summary["kernel_ms"].items()
                     if f"{row}(" in key or f"{row}<" in key)
            for row in rows}
    if total <= 0 or any(ms <= 0 for ms in ours.values()):
        fail(f"the profile shows no device time for {ours}")
    print(f"{label}: of {total:.2f} ms of kernel time in the {summary['steps']} profiled "
          f"steps, {what} take {sum(ours.values()):.3f} ms = "
          f"{sum(ours.values()) / total:.4f}: "
          + ", ".join(f"{row} {ms:.3f}" for row, ms in ours.items()))


# -- the generic IDW: masks that vary per frame --------------------------------

def frame_masks(kind: str, batch: int, seed: int) -> np.ndarray:
    """(batch, T, H, W, 1) masks of ``kind`` as the loaders draw them with the
    shipped configs' parameters (stin: 4 dense frames, then a block-10
    jittered grid; fi: every (interval+1)-th frame dense; nowcasting: the
    first 4 frames dense)."""
    rng = np.random.default_rng(seed)
    return np.stack([create_mask_np((LENGTH, H, W, 1), rng, kind, **FRAME_MASK_ARGS)
                     for _ in range(batch)])


def knn_points(dev, batch: int, points: int, block: int, seed: int):
    """(pts4, vals) of ``prep_points`` for ``batch`` samples of ``points``
    slots, four cases in turn: random points; the observed voxels of a sti
    mask of block size ``block`` (frame-constant, so every unobserved
    query sees exact +-z ties, and the jittered grid adds integer-offset
    ties); random points with 2 valid (fewer than k); none valid (empty)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((batch, points, 3), dtype=np.float32)
    valid = np.ones((batch, points), bool)
    lattice = sti_masks("cpu", batch, block, seed=seed)[:, None].expand(-1, LENGTH, -1, -1)
    on_grid = extract_points(lattice, torch.zeros(batch, *GRID), points)
    for b in range(1, batch, 4):
        pts[b] = on_grid[0][b].numpy()
        valid[b] = on_grid[2][b].numpy()
    valid[2::4, 2:] = False
    valid[3::4] = False
    vals = rng.normal(size=(batch, points)).astype(np.float32) * valid
    pts4, pv = prep_points(*(torch.from_numpy(a) for a in (pts, vals, valid)))
    return pts4.to(dev), pv.to(dev)


def knn_all_pairs_ms(batch: int, points: int) -> float:
    """The TPU kernel's work, every (query, point) pair at 9 + 3k operations
    and a square root, over the float32 rate: the generic IDW's bound before
    the cell search, kept beside the new one so the rows stay comparable."""
    return batch * LENGTH * H * W * points * (9 + 3 * K + 1) / PEAK_FLOPS * 1e3


def knn_bound(batch: int, points: int, selection: bool = False) -> dict:
    """The generic IDW's least time (#8, #9 and #10 compute one function):
    bytes are the points (x, y, z, penalty) and values once, the output (and
    the selection, k indices and weights a query) once; operations are the
    TPU kernels' 9 + 3k and one square root for each certified pair. A pair
    is certified when it comes no later than the query's k-th selected point
    in the order the selection uses, (d, index); that order is total, so
    these are exactly the k selected points of each query, the pairs even an
    exact search has to look at (any other can be ruled out by a bound, ties
    and invalid slots included), whatever the data."""
    q = LENGTH * H * W
    return bound(4 * batch * (5 * points + q * (1 + (2 * K if selection else 0))),
                 batch * q * K * (9 + 3 * K + 1))


def knn_bound_line(batch: int, points: int, b_: dict) -> str:
    return (f"bound {b_['bound_ms']:.5f} ms ({b_['bound_by']}; {batch * LENGTH * H * W * K} "
            f"certified pairs, {K} a query); the all-pairs work "
            f"{knn_all_pairs_ms(batch, points):.4f} ms")


def library_chain_ms(pts4: torch.Tensor, vals: torch.Tensor, backward: bool = False,
                     whole: bool = True) -> float:
    """The PyTorch calls for the same function (``torch.cdist`` without the
    matrix-product expansion -> ``topk`` -> gather -> weighted mean; with
    ``backward``, the normalized weights scattered back by ``index_add_``),
    LIB_CHUNK queries a call: over every query of every sample with
    ``whole``, else on the first chunk of the first sample only. One warm-up
    chunk, then one timed pass. The port never calls it."""
    grid = idw_kernel._grid(*GRID, str(pts4.device))

    def chain(b, lo):
        pts, pen, v = pts4[b, :, :3], pts4[b, :, 3], vals[b]
        d = torch.cdist(grid[lo:lo + LIB_CHUNK], pts,
                        compute_mode="donot_use_mm_for_euclid_dist")
        d = torch.where(pen[None] > 0, float("inf"), d)
        dist, idx = torch.topk(d, K, dim=1, largest=False)
        w = 1.0 / (dist + 0.05) ** 2
        w_norm = w / (w.sum(1, keepdim=True) + 1e-12)
        out = (w_norm * v[idx]).sum(1)
        if backward:
            torch.zeros_like(v).index_add_(0, idx.reshape(-1), w_norm.reshape(-1))
        return out

    chunks = [(b, lo) for b in range(pts4.shape[0] if whole else 1)
              for lo in range(0, grid.shape[0] if whole else 1, LIB_CHUNK)]
    chain(0, 0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for b, lo in chunks:
        chain(b, lo)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def check_idw_knn_single(dev) -> dict:
    """#8's range (the cell search of #9 since it replaced the brute-force
    kernel) at B=12 over the full (16, 128, 128) grid, at P = 3200 (the sti
    budget with idw_factored off) and 4096 (its limit), on the four cases of
    ``knn_points``: out, sel_idx and w_norm bitwise equal to the brute-force
    plain version on the card; timed without the selection (serving) and with
    it (a training forward)."""
    result = {}
    for points, block in SINGLE_PASS:
        pts4, pv = knn_points(dev, TRAIN_BATCH, points, block, SEED + 30)
        out_k, (sel_k, w_k) = idw_knn_single(pts4, pv, GRID, with_sel=True)
        out_p, (sel_p, w_p) = idw_knn_single_reference(pts4, pv, GRID, with_sel=True)
        torch.cuda.synchronize()
        e = float((out_k - out_p).abs().max())
        n_diff = int((out_k.view(torch.int32) != out_p.view(torch.int32)).sum())
        if n_diff or not (torch.equal(sel_k, sel_p) and bitwise_equal(w_k, w_p)) or \
                not bitwise_equal(idw_knn_single(pts4, pv, GRID)[0], out_k):
            fail(f"idw_knn_single differs from its plain version at P={points}: "
                 f"{n_diff} entries, max abs err {e}; sel_idx "
                 f"{int((sel_k != sel_p).sum())} entries")
        if bool(out_k[3::4].any()) or not bool(out_k[2::4].abs().max() > 0.1):
            fail("idw_knn_single: an empty sample is not zero, or 2 valid points gave none")
        k_ms = cuda_ms(lambda: idw_knn_single(pts4, pv, GRID), reps=10)
        sel_ms = cuda_ms(lambda: idw_knn_single(pts4, pv, GRID, with_sel=True), reps=10)
        p_ms = cuda_ms(lambda: idw_knn_single_reference(pts4, pv, GRID), reps=1, warmup=0)
        lib_ms = library_chain_ms(pts4, pv, whole=not result)
        b_ = knn_bound(TRAIN_BATCH, points)
        print(f"idw_knn_single B={TRAIN_BATCH} Q={LENGTH * H * W} P={points} k={K} "
              f"(random, sti-lattice, 2 valid, empty): out, sel_idx, w_norm bitwise "
              f"equal to the brute force; kernel {k_ms:.4f} ms ({sel_ms:.4f} ms with the "
              f"selection), plain {p_ms:.4f} ms, "
              f"cdist chain {lib_ms:.2f} ms ("
              + ("every query of the batch" if not result else
                 f"one {LIB_CHUNK}-query chunk of one sample")
              + f"), {knn_bound_line(TRAIN_BATCH, points, b_)}")
        if not result:
            result = {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, **b_,
                      "library_ms": lib_ms}
    return result


def frame_points(dev, kind: str, points: int, batch: int, seed: int):
    """(pts4, vals) of ``batch`` windows under ``kind`` masks, their observed
    voxels gathered by ``extract_points`` into the config's budget."""
    masks = torch.from_numpy(frame_masks(kind, batch, seed)[..., 0]).to(dev)
    values = torch.rand(masks.shape, generator=torch.Generator().manual_seed(seed)).to(dev)
    pts, vals, valid = extract_points(masks, values * masks, points)
    n_obs = int((masks > 0).sum(dim=(1, 2, 3)).max())
    if not 0 < n_obs <= points or int(valid.sum(1).max()) != n_obs:
        fail(f"{kind}: {n_obs} observed voxels for a budget of {points}")
    return prep_points(pts, vals, valid)


ADVERSARIAL = ("z ties", "xy ties", "2 valid", "empty", "one cell", "outside [0, 1]",
               "duplicates")
ADVERSARIAL_POINTS = 32768


def adversarial_points(dev):
    """(pts4, vals) of one full-grid sample a case of ``ADVERSARIAL``, 32768
    slots: frames 5 and 7 dense (every query of frame 6 sees +-z ties); every
    other pixel of frames 0-7 (four-way xy ties); random points with 2 valid
    and with none; every point inside one cell; random points in [-0.5, 1.5];
    8192 coordinates four times each, at different indices."""
    rng = np.random.default_rng(SEED + 35)
    n = ADVERSARIAL_POINTS
    masks = np.zeros((2, LENGTH, H, W), np.float32)
    masks[0, [5, 7]] = 1.0
    masks[1, :8, ::2, ::2] = 1.0
    lattice = extract_points(torch.from_numpy(masks), torch.from_numpy(masks), n)[0].numpy()
    pts = np.concatenate([lattice, rng.random((2, n, 3), dtype=np.float32),
                          0.5 + 0.005 * rng.random((1, n, 3), dtype=np.float32),
                          rng.random((1, n, 3), dtype=np.float32) * 2 - 0.5,
                          np.tile(rng.random((1, n // 4, 3), dtype=np.float32), (1, 4, 1))])
    valid = np.ones((len(ADVERSARIAL), n), bool)
    valid[2, 2:] = False
    valid[3] = False
    vals = rng.normal(size=valid.shape).astype(np.float32) * valid
    pts4, pv = prep_points(*(torch.from_numpy(a) for a in (pts, vals, valid)))
    return pts4.to(dev), pv.to(dev)


def check_cell_build(pts4: torch.Tensor, label: str) -> None:
    """The card's cell build (as #9 runs it) against its plain version: counts,
    starts and boxes equal, every cell holding the same members (the card's
    order within a valid cell is free), the invalid set in index order."""
    dims = idw_kernel.cell_dims(*GRID)
    got = idw_cell_build(pts4, dims)
    want = cell_build_reference(pts4, dims)
    count, start, order, lo, hi = want
    C, Pp = count.shape[1], pts4.shape[1]
    cell_sorted = torch.stack([torch.repeat_interleave(torch.arange(C, device=pts4.device),
                                                       count[b].long())
                               for b in range(count.shape[0])])
    key = lambda o: torch.sort(cell_sorted.long() * Pp + o.long(), dim=1).values
    same_inv = all(torch.equal(got[2][b, int(start[b, -1]):], order[b, int(start[b, -1]):])
                   for b in range(count.shape[0]))
    if not (torch.equal(got[0], count) and torch.equal(got[1], start)
            and bool((got[3] == lo).all()) and bool((got[4] == hi).all())
            and torch.equal(key(got[2]), key(order)) and same_inv):
        fail(f"the card's cell build differs from its plain version ({label})")
    print(f"cell build ({label}, B={count.shape[0]}, {C} cells a sample of "
          f"{dims[0]}x{dims[1]}x{dims[2]} + the invalid set): equal to its plain version; "
          f"{int(count[:, :-1].sum())} valid points, {int(count[:, -1].sum())} invalid "
          f"slots, at most {int(count[:, :-1].max())} in a cell")


def check_idw_knn_chunked(dev) -> dict:
    """Kernel #9 (the cell search) at Q = 262144 under each mask that varies
    per frame, B=12 at the config's budget (fi 98304, stin 67968, nowcasting
    65536 points): the card's cell build against its plain version; out,
    sel_idx and w_norm bitwise equal to the brute-force plain version on all 12
    samples at fi (the kernels line's row; ~2 s a sample) and on the first two
    under stin and nowcasting; the linearity identity of the scatter backward;
    the time at serving's B=8 and of the build alone; the bound from the
    certified pairs (``knn_bound``) beside the all-pairs work. Then the
    adversarial cases (``adversarial_points``), build and selection bitwise,
    and #9 against #8 at P = 3200, bit for bit. The kernels line reports fi at B=12, with no
    library time: the cdist chain over the whole batch would take minutes, so
    it is timed on one chunk and printed as that."""
    result = {}
    dims = idw_kernel.cell_dims(*GRID)
    for kind, points in FRAME_MASKS:
        pts4, pv = frame_points(dev, kind, points, TRAIN_BATCH, SEED + 31)
        check_cell_build(pts4, kind)
        out_k, (sel_k, w_k) = idw_knn_chunked(pts4, pv, GRID, with_sel=True)
        n = TRAIN_BATCH if kind == "fi" else 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p, (sel_p, w_p) = idw_knn_chunked_reference(pts4[:n], pv[:n], GRID)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        e = float((out_k[:n] - out_p).abs().max())
        if not (bitwise_equal(out_k[:n], out_p) and torch.equal(sel_k[:n], sel_p)
                and bitwise_equal(w_k[:n], w_p)):
            fail(f"idw_knn_chunked ({kind}) differs from its plain version: out "
                 f"{int((out_k[:n] != out_p).sum())} entries, max abs err {e}; sel_idx "
                 f"{int((sel_k[:n] != sel_p).sum())}")
        g = torch.randn(out_k.shape, generator=torch.Generator().manual_seed(SEED)).to(dev)
        lhs = float((scatter_selection(sel_k, w_k, g, pts4.shape[1]).double()
                     * pv.double()).sum())
        rhs = float((g.double() * out_k.double()).sum())
        tol = 1e-5 * float((g.abs().double() * idw_knn_chunked(pts4, pv.abs(), GRID)[0]
                            .double()).sum())
        if not abs(lhs - rhs) <= tol:
            fail(f"chunked scatter backward ({kind}): <dv, v> {lhs} vs <g, f(v)> {rhs}")
        k_ms = cuda_ms(lambda: idw_knn_chunked(pts4, pv, GRID, with_sel=True), reps=10)
        serve_ms = cuda_ms(lambda: idw_knn_chunked(pts4[:WINDOW_BATCH], pv[:WINDOW_BATCH],
                                                   GRID), reps=10)
        build_ms = cuda_ms(lambda: idw_cell_build(pts4, dims), reps=10)
        b_ = knn_bound(TRAIN_BATCH, points, selection=True)
        line = (f"idw_knn_chunked[{kind}] B={TRAIN_BATCH} Q={LENGTH * H * W} P={points} "
                f"k={K}: out, sel_idx, w_norm bitwise equal on {n} samples, max abs err "
                f"{e:.3e}; <dv, v> - <g, f(v)> = {lhs - rhs:.3e} (limit {tol:.3e}); "
                f"kernel {k_ms:.4f} ms with the selection (the cell build alone "
                f"{build_ms:.4f} ms), B={WINDOW_BATCH} without {serve_ms:.4f} ms; plain "
                f"{p_ms:.1f} ms on {n} samples; {knn_bound_line(TRAIN_BATCH, points, b_)}"
                f", {b_['bound_ms'] / k_ms:.4f} of the bound")
        if kind == "fi":
            lib_ms = library_chain_ms(pts4, pv, whole=False)
            line += f"; cdist chain {lib_ms:.1f} ms on one {LIB_CHUNK}-query chunk of one sample"
            result = {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, **b_}
        print(line)
    pts4, pv = adversarial_points(dev)
    check_cell_build(pts4, "adversarial: " + ", ".join(ADVERSARIAL))
    out_k, (sel_k, w_k) = idw_knn_chunked(pts4, pv, GRID, with_sel=True)
    out_p, (sel_p, w_p) = idw_knn_chunked_reference(pts4, pv, GRID)
    for b, name in enumerate(ADVERSARIAL):
        if not (bitwise_equal(out_k[b], out_p[b]) and torch.equal(sel_k[b], sel_p[b])
                and bitwise_equal(w_k[b], w_p[b])):
            fail(f"idw_knn_chunked ({name}) differs from its plain version: sel_idx "
                 f"{int((sel_k[b] != sel_p[b]).sum())} entries")
    if bool(out_k[3].any()) or not bool(out_k[2].abs().max() > 0.1):
        fail("idw_knn_chunked: an empty sample is not zero, or 2 valid points gave none")
    adv_ms = cuda_ms(lambda: idw_knn_chunked(pts4, pv, GRID, with_sel=True), reps=10)
    print(f"idw_knn_chunked, the adversarial cases (P={ADVERSARIAL_POINTS} a sample: "
          f"{', '.join(ADVERSARIAL)}): out, sel_idx, w_norm bitwise equal to the plain "
          f"version; kernel {adv_ms:.4f} ms for the {len(ADVERSARIAL)} samples")
    pts4, pv = knn_points(dev, TRAIN_BATCH, STI_POINTS, STI_BLOCK, SEED + 32)
    if not bitwise_equal(idw_knn_chunked(pts4, pv, GRID)[0],
                         idw_knn_single(pts4, pv, GRID)[0]):
        fail(f"idw_knn_chunked differs from idw_knn_single at P={STI_POINTS}")
    print(f"idw_knn_chunked at P={STI_POINTS} (the four cases): bitwise equal to "
          f"idw_knn_single")
    return result


def scatter_error(got, want, mass) -> float:
    """The largest |got - want| of a sample over its largest sum of |terms|."""
    return float(((got - want).abs().amax(dim=1) / mass).max())


def check_scatter(dev) -> dict:
    """Kernel #10 (``scatter_selection``: the saved selection's normalized
    weight x cotangent added into the points) at B=12, P = 3200, Q = 262144 on
    the four cases of ``knn_points``, from #8's range's selection: each sample
    within 1e-5 x the largest sum of |terms| a point of it receives, against
    its plain version (``index_add_``) and against ``idw_knn_bwd_reference``
    (the TPU kernel's function, the selection recomputed: w * (g / sum w));
    bitwise equal across two launches and with the queries permuted;
    <dv, v> == <g, f(v)> within 1e-5 x <|g|, f(|v|)>. ``library_ms`` is
    ``index_add_`` of the same terms (one call). Then the same on stin's
    selection (67968 points: the global path, no tile)."""
    pts4, pv = knn_points(dev, TRAIN_BATCH, STI_POINTS, STI_BLOCK, SEED + 33)
    Q, Pp = LENGTH * H * W, pts4.shape[1]
    g = torch.randn((TRAIN_BATCH, Q), generator=torch.Generator().manual_seed(SEED + 33)).to(dev)
    out, (sel, w) = idw_knn_single(pts4, pv, GRID, with_sel=True)
    got = scatter_selection(sel, w, g, Pp)
    perm = torch.randperm(Q, generator=torch.Generator().manual_seed(SEED + 34)).to(dev)
    shuffled = scatter_selection(sel[:, perm].contiguous(), w[:, perm].contiguous(),
                                 g[:, perm].contiguous(), Pp)
    if not (bitwise_equal(got, scatter_selection(sel, w, g, Pp))
            and bitwise_equal(got, shuffled)):
        fail("scatter_selection does not repeat bit for bit (two launches, queries permuted)")
    mass = scatter_selection_reference(sel, w, g.abs(), Pp).amax(dim=1)
    plain = scatter_selection_reference(sel, w, g, Pp)
    e = float((got - plain).abs().max())
    ratios = {"index_add_": scatter_error(got, plain, mass),
              "recomputed": scatter_error(got, idw_knn_bwd_reference(pts4, g, GRID), mass)}
    if not (bool((mass > 0).all()) and max(ratios.values()) <= 1e-5):
        fail(f"scatter_selection: a sample's max abs err over its largest sum of |terms| "
             f"is {ratios}")
    rhs = float((g.double() * out.double()).sum())
    lhs = float((got.double() * pv.double()).sum())
    tol = 1e-5 * float((g.abs().double() * idw_knn_single(pts4, pv.abs(), GRID)[0]
                        .double()).sum())
    if not abs(lhs - rhs) <= tol:
        fail(f"scatter_selection: <dv, v> {lhs} vs <g, f(v)> {rhs}")
    k_ms = cuda_ms(lambda: scatter_selection(sel, w, g, Pp))
    p_ms = cuda_ms(lambda: scatter_selection_reference(sel, w, g, Pp), reps=10)
    flat = (sel.long() + Pp * torch.arange(TRAIN_BATCH, device=dev)[:, None, None]).reshape(-1)
    terms = (w * g[:, :, None]).reshape(-1)
    acc = torch.zeros((TRAIN_BATCH * Pp,), device=dev)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, flat, terms), reps=10)
    n_terms = TRAIN_BATCH * Q * K
    b_ = bound(4 * (2 * n_terms + TRAIN_BATCH * Q + TRAIN_BATCH * Pp), 2 * n_terms)
    print(f"scatter_selection B={TRAIN_BATCH} Q={Q} P={STI_POINTS} k={K} (random, "
          f"sti-lattice, 2 valid, empty): max abs err {e:.3e}; a sample's max abs err at "
          f"most {ratios['index_add_']:.2e} x its largest sum of |terms| against index_add_, "
          f"{ratios['recomputed']:.2e} against the recomputed selection (sums "
          f"{float(mass.min()):.3e} to {float(mass.max()):.3f}); bitwise equal across two "
          f"launches and with the queries permuted; <dv, v> - <g, f(v)> = {lhs - rhs:.3e} "
          f"(limit {tol:.3e}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, index_add_ "
          f"{lib_ms:.4f} ms, bound {b_['bound_ms']:.5f} ms ({b_['bound_by']}), "
          f"{b_['bound_ms'] / k_ms:.4f} of it")
    spts, spv = frame_points(dev, "stin", dict(FRAME_MASKS)["stin"], TRAIN_BATCH, SEED + 31)
    _, (ssel, sw) = idw_knn_chunked(spts, spv, GRID, with_sel=True)
    sPp = spts.shape[1]
    s_got = scatter_selection(ssel, sw, g, sPp)
    s_mass = scatter_selection_reference(ssel, sw, g.abs(), sPp).amax(dim=1)
    s_ratio = scatter_error(s_got, scatter_selection_reference(ssel, sw, g, sPp), s_mass)
    if not (bitwise_equal(s_got, scatter_selection(ssel, sw, g, sPp)) and s_ratio <= 1e-5):
        fail(f"scatter_selection on stin's selection: repeats "
             f"{bitwise_equal(s_got, scatter_selection(ssel, sw, g, sPp))}, err {s_ratio}")
    s_ms = cuda_ms(lambda: scatter_selection(ssel, sw, g, sPp))
    s_pms = cuda_ms(lambda: scatter_selection_reference(ssel, sw, g, sPp), reps=10)
    print(f"scatter_selection on stin's selection (B={TRAIN_BATCH}, P={sPp}, the global "
          f"path): bitwise equal across two launches, at most {s_ratio:.2e} x a sample's "
          f"largest sum of |terms| from index_add_; kernel {s_ms:.4f} ms, plain "
          f"{s_pms:.4f} ms")
    return {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, **b_, "library_ms": lib_ms}


def frame_config(cfg: dict, kind: str) -> dict:
    """A shipped config with ``mask.type`` set to ``kind`` in every split."""
    for split in ("train", "test"):
        mask = cfg["data"][split]["mask"]
        mask["type"] = kind
        if {key: mask[key] for key in FRAME_MASK_ARGS} != FRAME_MASK_ARGS:
            fail(f"the shipped config's mask is {mask}")
    return cfg


def serve_frame_masks(tmp: Path, card: str, dev, kind: str, points: int) -> dict:
    """The two 64-frame events through scripts/infer_torch.py under ``kind``
    masks (one an event from the test loader, each window its slice):
    nothing is hoisted, every generator call (2 an event at window batch 8)
    runs #9 once for its 8 windows, #8 never. Then one 16-frame window under
    a fresh mask, the generator on the card against the same with the plain
    versions on the card (1e-4 on the tanh scale, i.e. 1e-4 x 255 served)."""
    cfg = frame_config(load_config(tmp / "eval.json"), kind)
    cfg["save_dir"] = str(tmp / f"weights_{kind}")
    cfg_path = tmp / f"eval_{kind}.json"
    cfg_path.write_text(json.dumps(cfg))
    checkpoint = tmp / "P2IGAN_seeded.pt"
    launches, events_per_s = serve(tmp, cfg_path, checkpoint, f"p2igan_{kind}",
                                   required=("idw_knn_chunked", "maxpool2_duplicate"))
    calls = EVENTS * (-(-(EVENT_FRAMES // 4) // WINDOW_BATCH))
    want = {**dict.fromkeys(launches, 0), "idw_knn_chunked": calls,
            "maxpool2_duplicate": 3 * calls}
    if launches != want:
        fail(f"{kind} serving launched {launches}, expected {want}")
    gen = load_generator(cfg, checkpoint, dev)
    if gen.idw_factored or gen.idw_max_points != points:
        fail(f"the {kind} config built idw_factored={gen.idw_factored}, "
             f"{gen.idw_max_points} points")
    ev = zarrlite.open(tmp / "test_events.zarr", mode="r")["event_01"][:LENGTH]
    masks = torch.from_numpy(frame_masks(kind, 1, SEED + 34)).to(dev)
    masked = torch.from_numpy(ev[None, ..., None].astype(np.float32) / 255.0).to(dev) * masks
    with torch.inference_mode():
        got = gen(masked, masks)
        with plain_versions():
            want_out = gen(masked, masks)
    err = float((got - want_out).abs().max())
    print(f"p2igan {kind} serving: {events_per_s:.4f} events/s on {card}; a 64-frame event "
          f"launches idw_knn_chunked x{calls // EVENTS} (P={points}); one window, card vs "
          f"plain versions on the card: max abs err {err:.3e} (tanh scale)")
    if not (bool(torch.isfinite(got).all()) and err <= 1e-4):
        fail(f"{kind}: the window differs from the plain versions by {err}")
    return launches


def train_stin(tmp: Path, card: str, dev) -> tuple:
    """The hinge GAN on p2igan_gan_baseline.json with stin masks (batch 12, a
    mask a sample, 67968 points) and ``device_decode`` through
    scripts/train_torch.py: #9 once a step with its selection and once a
    validation batch or example image without, the scatter backward (#10)
    once a step, #11 with the whole (T, H, W) mask a sample; then the
    profiled resume."""
    cfg = frame_config(write_train_tree(tmp, STI_TRAIN_CONFIG), "stin")
    cfg["data"]["train"]["device_decode"] = True
    label = "p2igan stin GAN device_decode"
    launches, sps = train_family(tmp, card, dev, label, cfg, lambda steps, fwd: {
        "idw_knn_chunked": steps + fwd, "scatter_selection": steps,
        "maxpool2_duplicate": 3 * (steps + fwd), "decode_normalize_mask": None})
    summary = json.loads((tmp / f"profile_{label.replace(' ', '_')}" / "summary.json")
                         .read_text())
    total = sum(summary["kernel_ms"].values())
    ours = sum(ms for key, ms in summary["kernel_ms"].items()
               if any(f"{name}(" in key for name in CELL_SEARCH_KERNELS))
    if not (total > 0 and ours > 0):
        fail("the stin profile shows no device time for #9 (the cell build and search)")
    print(f"{label}: of {total:.2f} ms of kernel time in the {summary['steps']} profiled "
          f"steps, #9 takes {ours:.3f} ms = {ours / total:.4f}")
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
    1e-5 x max|plain|, two launches bitwise equal; both sides' distance to a
    float64 plain version. Timed a call (CUDA events) and as device time
    (CUDA-graph replay), each beside the float32 bound. The plain version is
    the chain of three ``torch.matmul`` products (cuBLAS) over 8 offset rows
    at a time, so its time is also printed as ``cublas_chain_ms``; the port
    never runs it on a CUDA tensor."""
    result = {}
    for batch in (WINDOW_BATCH, TRAIN_BATCH):
        args = dk_tail_inputs(dev, batch)
        J, hw, h = args[1].shape[0], args[0].shape[0], args[0].shape[1]
        out_k, out_p = mlp_tail_fused(*args), mlp_tail_reference(*args)
        again = mlp_tail_fused(*args)
        out_64 = mlp_tail_reference(*(a.double() for a in args))
        torch.cuda.synchronize()
        scale = float(out_p.abs().max())
        e = float((out_k - out_p).abs().max())
        e_k64 = float((out_k.double() - out_64).abs().max())
        e_p64 = float((out_p.double() - out_64).abs().max())
        if not (scale > 0 and e <= 1e-5 * scale):
            fail(f"mlp_tail_fused J={J}: max abs err {e} > 1e-5 x {scale}")
        if not bitwise_equal(out_k, again):
            fail(f"mlp_tail_fused J={J}: two launches differ")
        k_ms = cuda_ms(lambda: mlp_tail_fused(*args))
        g_ms = graph_ms(lambda i: mlp_tail_fused(*args), 1)
        p_ms = cuda_ms(lambda: mlp_tail_reference(*args), reps=5)
        flops = J * hw * (4 * h * h + 4 * h)
        nbytes = 4 * (hw * h + J * h + 2 * h * h + 3 * h + 1 + J * hw)
        b = bound(nbytes, flops)
        print(f"mlp_tail_fused J={J} HW={hw} h={h}: max abs err {e:.3e} "
              f"({e / scale:.2e} x max|plain| {scale:.3f}); to float64: kernel "
              f"{e_k64:.3e}, plain {e_p64:.3e}; two launches bitwise equal; kernel "
              f"{k_ms:.4f} ms a call ({flops / k_ms / 1e9:.1f} TFLOP/s, "
              f"{b['bound_ms'] / k_ms:.3f} of the bound), device {g_ms:.4f} ms "
              f"({b['bound_ms'] / g_ms:.3f} of the bound); plain {p_ms:.4f} ms "
              f"(cublas_chain_ms {p_ms:.4f}), bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})")
        # the kernels line reports the training shape (the larger J); the
        # plain version is the cuBLAS chain, so it is also the library time
        result = {"max_abs_err": e, "ms": k_ms, "plain_ms": p_ms, **b, "library_ms": p_ms}
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
    tf32x3_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
    print(f"mlp_tail_bwd J={J} HW={hw} h={h}: kernel vs plain / kernel vs float64 / "
          f"plain vs float64, x max|plain|: "
          + ", ".join(f"{n} {v[0]:.1e}/{v[1]:.1e}/{v[2]:.1e}" for n, v in worst.items())
          + f"; repeats bitwise; kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} "
          f"TFLOP/s), plain {p_ms:.4f} ms (cublas_chain_ms), bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}: {b['bound_ms'] / k_ms:.3f} of the float32 peak "
          f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s); the 3xTF32 ideal, three passes at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, {tf32x3_ms:.4f} ms "
          f"({tf32x3_ms / k_ms:.3f} of it)")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **b, "library_ms": p_ms}


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
    12; ``expected(steps, forwards)`` gives the kernel launches the run must
    show (None: at least one), every other kernel none; ``forwards`` are the
    forwards without gradient: the validation batches and the epoch's example
    images (one train batch, up to five validation batches). Every parameter of the generator (and
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
    n_val = len(trainer.val_loader)
    forwards = n_val + 1 + min(VAL_EXAMPLES, n_val)
    want = {**dict.fromkeys(launches, 0), **expected(steps, forwards)}
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
    RATES[label] = sps
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
    (use_gan 0), AdamNoMu; the tail forward runs once a step, a validation
    batch and an example image, its backward once a step."""
    cfg = write_train_tree(tmp, DK_FAMILY[model][1])
    if cfg["loss"]["use_gan"] or cfg["model"]["name"] != model:
        fail(f"{DK_FAMILY[model][1].name} is no longer a rec-loss {model} config")
    launches, sps = train_family(tmp, card, dev, model, cfg, lambda steps, fwd: {
        "mlp_tail_fused": steps + fwd, "mlp_tail_bwd": steps})
    summary = json.loads((tmp / f"profile_{model}" / "summary.json").read_text())
    total = sum(summary["kernel_ms"].values())
    tail_bwd = sum(ms for key, ms in summary["kernel_ms"].items()
                   if any(name in key for name in TAIL_BWD_KERNELS))
    tail_fwd = sum(ms for key, ms in summary["kernel_ms"].items()
                   if TAIL_FWD_KERNEL in key)
    if not (total > 0 and tail_bwd > 0):
        fail(f"the {model} profile shows no device time for #13 (mlp_tail_bwd)")
    if not tail_fwd > 0:
        fail(f"the {model} profile shows no device time for #12 (mlp_tail_fused)")
    print(f"{model} training: of {total:.2f} ms of kernel time in the {summary['steps']} "
          f"profiled steps (device busy {summary['device_busy_ms']:.2f} ms), #13 "
          f"(mlp_tail_bwd) takes {tail_bwd:.3f} ms = {tail_bwd / total:.4f}, #12 "
          f"(mlp_tail_fused) {tail_fwd:.3f} ms = {tail_fwd / total:.4f}")
    return launches, sps


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
                # one input: it alone is larger than ROTATE_BYTES or its output is
                d_ms = graph_ms(lambda i: kernel(x, weight, bias), 1)
                p_ms = cuda_ms(lambda: plain(x, weight, bias), reps=10)
                lib_ms = cuda_ms(lambda: chain(xc, wc, bias), reps=10)
            b_, t_, h_, w_, cin = x.shape
            cout = weight.shape[4]
            voxels = b_ * t_ * h_ * w_
            flops = voxels * cout * (2 * 27 * cin + 3)
            nbytes = 4 * (x.numel() + out_k.numel() + weight.numel() + bias.numel())
            bnd = {**bound(nbytes, flops), "library_ms": lib_ms}
            line += (f"; kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s, "
                     f"{nbytes / k_ms / 1e6:.0f} GB/s; device {d_ms:.4f} ms, "
                     f"{bnd['bound_ms'] / d_ms:.4f} of the bound), plain {p_ms:.4f} ms, "
                     f"cuDNN chain (conv, then activation) {lib_ms:.4f} ms, bound "
                     f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
            result = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "device_ms": d_ms,
                      **bnd, "bound_share": bnd["bound_ms"] / d_ms}
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
            simple_deterministic_cudnn_cost(tmp, cfg_path, checkpoint, card, dev)
    return launches


def simple_deterministic_cudnn_cost(tmp: Path, cfg_path: Path, checkpoint: Path, card: str,
                                    dev) -> None:
    """One 64-frame event's reconstruction through the folded simple generator
    (both kernels) with cuDNN's deterministic flag as the precision policy sets
    it and without, in turns (on, off, off, on; 3 events each): a measurement
    only, the policy stays deterministic."""
    cfg = load_config(cfg_path)
    ev = zarrlite.open(tmp / "test_events.zarr", mode="r")["event_01"][:]
    ev = ev[..., None].astype(np.float32) / 255.0
    mask = np.loadtxt(cfg["data"]["test"]["mask"]["file"]).astype(np.float32)
    masks = np.broadcast_to(mask[None, :, :, None], ev.shape).astype(np.float32)
    recon = SlidingWindowReconstructor(load_generator(cfg, checkpoint, dev), stride=16,
                                       overlap=12, window_batch=WINDOW_BATCH)
    times = {True: [], False: []}
    try:
        for det in (True, False, False, True):
            torch.backends.cudnn.deterministic = det
            recon(ev * masks, masks)  # the first call under a flag picks its algorithms
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                recon(ev * masks, masks)
            torch.cuda.synchronize()
            times[det].append((time.perf_counter() - t0) / 3 * 1e3)
    finally:
        set_precision_policy()
    on, off = statistics.mean(times[True]), statistics.mean(times[False])
    print(f"simple serving reconstruction, one {EVENT_FRAMES}-frame event: {on:.2f} ms with "
          f"deterministic cuDNN (the policy; {[round(t, 2) for t in times[True]]}), "
          f"{off:.2f} ms without ({[round(t, 2) for t in times[False]]}): "
          f"{(on / off - 1) * 100:+.2f}% on {card}")


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
    ours = {name: sum(r.self_device_time_total for r in rows
                      if f"{name}(" in r.key or f"{name}<" in r.key)
            for name in ("enc0_kernel", "dec2_kernel")}
    print(f"simple serving profile, one {EVENT_FRAMES}-frame event (2 generator calls): "
          f"wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms, idle share "
          f"{1.0 - busy_us / wall_us:.3f}; copy kernels on the device {copies / 1e3:.3f} ms "
          f"= {copies / total:.4f} of kernel time; #14 (enc0_kernel) "
          f"{ours['enc0_kernel'] / 1e3:.3f} ms = {ours['enc0_kernel'] / total:.4f} and #15 "
          f"(dec2_kernel) {ours['dec2_kernel'] / 1e3:.3f} ms = "
          f"{ours['dec2_kernel'] / total:.4f} of kernel time; kernels by device time (ms, "
          f"calls):\n  "
          + "\n  ".join(f"{r.key[:90]} {r.self_device_time_total / 1e3:.3f} {r.count}"
                        for r in rows[:14]))
    if not all(us > 0 for us in ours.values()):
        fail(f"the simple serving profile shows no device time for {ours}")
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
    launches, sps = train_family(tmp, card, dev, label, cfg, lambda steps, fwd: {})
    flops = simple_step_flops(use_gan)
    print(f"{label}: a step's convolutions are {flops / 1e12:.3f} TFLOP, "
          f"{flops / PEAK_FLOPS * 1e3:.2f} ms at the float32 peak; measured "
          f"{1e3 / sps:.2f} ms a step: {flops / PEAK_FLOPS * sps:.3f} of the bound's rate")
    return launches, sps


# -- the online evaluation path -------------------------------------------------

def rain_pair(rng, shape) -> tuple:
    """Normalized (preds, target) in [0, 60] (the metric transform maps them to
    0.036-202 mm/h, so every threshold splits them); a value whose transform
    lies within 1e-5 of a threshold is drawn again, so the card's and the
    CPU's ``pow`` cannot flip a count."""
    def clear(x):
        while True:
            mm = 10.0 ** (x.astype(np.float64) * 0.0625) * 0.036
            near = np.zeros(x.shape, bool)
            for thr in THRESHOLDS:
                near |= np.abs(mm / thr - 1.0) < 1e-5
            if not near.any():
                return x
            x[near] = rng.uniform(0.0, 60.0, int(near.sum())).astype(np.float32)

    target = rng.uniform(0.0, 60.0, shape).astype(np.float32)
    preds = np.clip(target + rng.normal(0.0, 6.0, shape), 0.0, 60.0).astype(np.float32)
    return clear(preds), clear(target)


def check_metric_suite(dev, card: str) -> None:
    """The metric suite on one full-width validation batch (12, 16, 128, 128,
    1) whose values cross every threshold: the card's suite against the
    port's CPU suite on the same tensors (counts equal, every other leaf
    within rtol 1e-5); an update waits for nothing (it runs under the sync
    debug mode "error"); the device ms of one update, beside the bytes bound
    of reading its two inputs once."""
    rng = np.random.default_rng(SEED)
    preds, target = rain_pair(rng, (TRAIN_BATCH, LENGTH, H, W, 1))
    pd, td = torch.from_numpy(preds).to(dev), torch.from_numpy(target).to(dev)
    on_card, on_cpu = RainfallMetricSuite(device=dev), RainfallMetricSuite(device="cpu")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        on_card.update(pd, td)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    on_cpu.update(torch.from_numpy(preds), torch.from_numpy(target))
    worst = 0.0
    for part_card, part_cpu in zip(on_card.state, on_cpu.state):
        for key, val in part_card.items():
            got, want = val.cpu().double(), part_cpu[key].double()
            if key in COUNT_LEAVES:
                if not torch.equal(got, want):
                    fail(f"metric suite: {key} {got.tolist()} on the card, "
                         f"{want.tolist()} on the CPU")
                continue
            rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
            worst = max(worst, rel)
            if rel > 1e-5:
                fail(f"metric suite: {key} on the card is {rel:.3g} off the CPU's (rtol 1e-5)")
    cat = on_cpu.state[1]
    if not all(bool((cat[key] > 0).all()) for key in ("hits", "misses", "false", "correct")):
        fail(f"the metric suite's inputs leave a count empty: {cat}")
    ms = cuda_ms(lambda: on_card.update(pd, td), reps=10)
    t0 = time.perf_counter()
    on_card.update(pd, td)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    bytes_ms = 2 * pd.numel() * 4 / PEAK_BYTES_PER_S * 1e3
    print(f"metric suite on ({TRAIN_BATCH}, {LENGTH}, {H}, {W}, 1), {len(THRESHOLDS)} "
          f"thresholds x {len(SCALES)} scales: the card's state equals the CPU's (counts "
          f"exactly, the rest within rtol {worst:.3g}); every count non-empty (hits "
          f"{cat['hits'].tolist()}); an update waits for nothing; {ms:.4f} ms of device "
          f"time an update (host enqueue {host_ms:.4f} ms), the bytes bound "
          f"{bytes_ms:.5f} ms, on {card}")


def read_logged(run_dir: Path, prefix: str = "val/") -> dict:
    """{key: [value, ...]} of a file-tracker run's metrics under ``prefix``,
    each value as ``float.hex`` (or the raw token of a non-finite one)."""
    out = {}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["key"].startswith(prefix):
            val = rec["value"]
            out.setdefault(rec["key"], []).append(rec.get("raw") if val is None
                                                  else float(val).hex())
    return out


def check_evaluation(trainer, label: str) -> dict:
    """After a training run with ``train.eval_metrics``: the validation pass
    logged every key of the metric suite as val/<key>, each finite, and the
    epoch wrote its example images (one of the train loader, one for each
    of the first five validation batches: four here), each 2 x 128 rows by
    16 x 128 columns of RGB."""
    from PIL import Image

    logged = read_logged(get_tracker().run_dir)
    want = ({"val/mae", "val/rmse", "val/ssim", "val/loss"}
            | {f"val/cat_thr{t:.2f}/{m}" for t in THRESHOLDS
               for m in ("pod", "far", "csi", "hss")}
            | {f"val/fss_thr{t:.2f}_s{s}" for t in THRESHOLDS for s in SCALES})
    if set(logged) != want:
        fail(f"{label}: logged {sorted(set(logged) ^ want)} against the suite's keys")
    last = {key: float.fromhex(vals[-1]) for key, vals in logged.items()}
    if not all(np.isfinite(list(last.values()))):
        fail(f"{label}: a validation metric is not finite: {last}")
    artifacts = Path(trainer.cfg["save_dir"]) / "artifacts"
    names = ["train_epoch1_batch0_ex0.png"] + [
        f"val_epoch1_batch{b}_ex0.png" for b in range(min(VAL_EXAMPLES, len(trainer.val_loader)))]
    for name in names:
        if not (artifacts / name).exists():
            fail(f"{label}: no example image {name} (found "
                 f"{sorted(p.name for p in artifacts.glob('*.png'))})")
        with Image.open(artifacts / name) as img:
            if img.format != "PNG" or img.mode != "RGB" or img.size != (LENGTH * W, 2 * H):
                fail(f"{label}: {name} is {img.format} {img.mode} {img.size}")
    print(f"{label}: {len(last)} val/* keys logged and finite (mae {last['val/mae']:.6g}, "
          f"rmse {last['val/rmse']:.6g}, ssim {last['val/ssim']:.6g}, cat_thr0.50/csi "
          f"{last['val/cat_thr0.50/csi']:.6g}, fss_thr0.50_s8 "
          f"{last['val/fss_thr0.50_s8']:.6g}); {len(names)} example PNGs of "
          f"{2 * H}x{LENGTH * W} RGB")
    return last


def time_validation(trainer, card: str) -> None:
    """Host ms of one validation pass (the loader's batches, the loss, and
    with ``eval_metrics`` the predictions and the metric suite), synchronized,
    with the suite and without, in turns: on, off, off, on."""
    times = {True: [], False: []}
    for on in (True, False, False, True):
        trainer.eval_metrics = on
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._evaluate_rec_loss(trainer.val_loader)
        torch.cuda.synchronize()
        times[on].append((time.perf_counter() - t0) * 1e3)
    print(f"validation pass over {len(trainer.val_loader)} batches of {TRAIN_BATCH}: "
          f"{statistics.mean(times[True]):.2f} ms with eval_metrics ({times[True]}), "
          f"{statistics.mean(times[False]):.2f} ms without ({times[False]}) on {card}")


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

    t_start = t0 = time.perf_counter()
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
               "idw_knn_single": check_idw_knn_single(dev),
               "idw_knn_chunked": check_idw_knn_chunked(dev),
               "scatter_selection": check_scatter(dev),
               "mlp_tail_fused": check_mlp_tail(dev),
               "mlp_tail_bwd": check_mlp_tail_bwd(dev),
               "enc0_conv3d_leaky": check_enc0(dev),
               "conv3d_cout1_sigmoid": check_dec2(dev)}
    check_gauge_topk_batched(dev)
    time_input_block(dev)
    time_conv_layouts(dev)
    t0 = time.perf_counter()
    check_metric_suite(dev, card)
    print(f"metric suite phase: {time.perf_counter() - t0:.1f} s")

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
        check_gradients(dev, "stis")
        paths["p2igan training"] = train(tmp, card, dev)
        paths["p2igan sti serving"] = serve_sti(tmp, card, dev)
        check_gradients(dev, "sti")
        host_loader_rate(tmp, sti_config(write_train_tree(tmp, STI_TRAIN_CONFIG)),
                         "sti, a mask drawn per window")
        for decode in (False, True):
            label = "p2igan sti training" + (" device_decode" if decode else "")
            paths[label], sps = train_sti(tmp, card, dev, decode)
            print(f"{label}: {sps:.4f} GAN steps/s on {card}")
        for kind, points in FRAME_MASKS:
            t0 = time.perf_counter()
            paths[f"p2igan {kind} serving"] = serve_frame_masks(tmp, card, dev, kind, points)
            print(f"p2igan {kind} serving phase: {time.perf_counter() - t0:.1f} s")
        for mode in ("stin", "sti single pass"):
            paths[f"p2igan {mode} gradients"] = check_gradients(dev, mode)
        t0 = time.perf_counter()
        paths["p2igan stin training"], sps = train_stin(tmp, card, dev)
        print(f"p2igan stin training: {sps:.4f} GAN steps/s on {card}; phase "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_repeat(tmp, card, dev)
        deterministic_cudnn_cost(tmp, card, dev)
        print(f"repeat phase: {time.perf_counter() - t0:.1f} s")
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

    print(f"p2igan in this run on {card}: serving events/s "
          + ", ".join(f"{kind} {RATES[f'p2igan{sfx} serving']:.4f}" for kind, sfx in
                      (("stis", ""), ("sti", "_sti"), ("stin", "_stin"), ("fi", "_fi"),
                       ("nowcasting", "_nowcasting")))
          + "; GAN steps/s " + ", ".join(f"{key[7:]} {sps:.4f}" for key, sps in RATES.items()
                                         if key.startswith("p2igan") and "GAN" in key))
    print(f"chip_smoke phases took {time.perf_counter() - t_start:.1f} s")
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
