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
6. Prints the card, a JSON line of the five kernels, then
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

from p2igan_tpu.config import load_config
from p2igan_tpu.data import fake, zarrlite
from p2igan_tpu_torch.data.stores import store_compressor
from p2igan_tpu_torch.inference.driver import (SlidingWindowReconstructor,
                                               load_generator, set_precision_policy)
from p2igan_tpu_torch.losses import reconstruction_loss
from p2igan_tpu_torch.models import P2IGenerator
from p2igan_tpu_torch.ops import cuda_lib, idw_factored_kernel, layers
from p2igan_tpu_torch.ops.decode_mask import (decode_normalize_mask,
                                              decode_normalize_mask_reference)
from p2igan_tpu_torch.ops.doconv import make_d_diag
from p2igan_tpu_torch.ops.idw import factored_prepare_full, gauge_geometry
from p2igan_tpu_torch.ops.idw_factored_kernel import (
    combine_table_multi, combine_table_multi_bwd, combine_table_multi_bwd_reference,
    combine_table_multi_reference, gauge_topk, gauge_topk_reference)
from p2igan_tpu_torch.ops.pool_dup import (maxpool2_duplicate,
                                           maxpool2_duplicate_reference)

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "p2igan_tpu" / "config" / "p2igan_baseline_eval.json"
TRAIN_CONFIG = REPO / "p2igan_tpu" / "config" / "p2igan_gan_baseline_gauge.json"
SEED = 2024
H = W = 128
LENGTH, BASE, NUM_RES, WINDOW_BATCH, G, K = 16, 64, 4, 8, 128, 4
EVENTS, EVENT_FRAMES = 2, 64
TRAIN_BATCH, TRAIN_EVENTS, WARMUP_STEPS, TIMED_STEPS = 12, 5, 5, 10
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
    "decode_normalize_mask": (decode_normalize_mask,
                              "p2igan_tpu_torch/csrc/decode_mask.cu",
                              "p2igan_tpu/ops/pallas/decode_mask.py:53"),
}
SERVING_KERNELS = ("gauge_topk", "combine_table_multi", "maxpool2_duplicate")


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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    return {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms}


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


def serve(tmp: Path, cfg_path: Path, dev) -> tuple:
    spec = importlib.util.spec_from_file_location(
        "infer_torch", REPO / "scripts" / "infer_torch.py")
    infer_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(infer_torch)

    def argv(out):
        return infer_torch.parse_args([
            "--config", str(cfg_path), "--checkpoint", str(tmp / "P2IGAN_seeded.pt"),
            "--output", str(tmp / out), "--stride", "16", "--overlap", "12",
            "--window-batch", str(WINDOW_BATCH), "--device", "cuda",
            "--overwrite", "--log-level", "WARNING"])

    t0 = time.perf_counter()
    infer_torch.main(argv("warmup.zarr"))
    torch.cuda.synchronize()
    print(f"serving warm-up run (CUDA context, cuDNN, kernel load): "
          f"{time.perf_counter() - t0:.3f} s")
    reset_launches()
    t0 = time.perf_counter()
    out = infer_torch.main(argv("served.zarr"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    print(f"served {EVENTS} events x {EVENT_FRAMES} frames in {seconds:.3f} s: "
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
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            fail(f"the serving run launched no {name} kernel")
    return launches, EVENTS / seconds


def check_against_cpu(tmp: Path, cfg_path: Path, dev) -> None:
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
        gen = load_generator(cfg, tmp / "P2IGAN_seeded.pt", torch.device(d))
        recon = SlidingWindowReconstructor(gen, stride=16, overlap=12, window_batch=4)
        outs[str(d)] = recon(masked, masks)
    err = float(np.abs(outs["cpu"] - outs[str(dev)]).max())
    print(f"16-frame event, card vs plain CPU path: max abs err {err:.4e} "
          f"(x255 scale), max value {outs['cpu'].max():.3f}")
    if not err <= 1e-4 * 255.0:
        fail(f"card reconstruction differs from the CPU path by {err}")


@contextlib.contextmanager
def plain_versions():
    """Route the generator through the plain versions of the combine and the
    pool (the modules look them up at call time), e.g. on the card."""
    saved = idw_factored_kernel.combine_table_multi, layers.maxpool2_duplicate
    idw_factored_kernel.combine_table_multi = combine_table_multi_reference
    layers.maxpool2_duplicate = maxpool2_duplicate_reference
    try:
        yield
    finally:
        idw_factored_kernel.combine_table_multi, layers.maxpool2_duplicate = saved


def check_gradients(dev) -> None:
    """One full-width generator forward and backward at batch 12: the
    autograd Functions must carry the gradient back to ``input.*`` (the
    attention blocks before the combine) and ``Convsin.*`` (reached only
    through the first pool). The ``input.*`` gradients are held against the
    same computation through the plain versions on the card, within 1e-4 x
    max|grad|: cuDNN's backward and the combine backward's reordered sums
    change the last bits."""
    rng = np.random.default_rng(SEED + 5)
    flat = np.zeros(H * W, np.float32)
    flat[rng.choice(H * W, 79, replace=False)] = 1.0
    masks = torch.from_numpy(np.broadcast_to(flat.reshape(1, 1, H, W, 1),
                                             (TRAIN_BATCH, LENGTH, H, W, 1)).copy()).to(dev)
    frames = torch.from_numpy(rng.random((TRAIN_BATCH, LENGTH, H, W, 1),
                                         dtype=np.float32)).to(dev)
    gen = P2IGenerator(H=H, W=W, length=LENGTH, num_res=NUM_RES, base_channels=BASE,
                       generator=torch.Generator().manual_seed(SEED), device=dev)
    prep = gen.prepare_idw(masks[0, 0, :, :, 0])

    def grads():
        gen.zero_grad(set_to_none=True)
        preds = gen(frames * masks, masks, idw_prepared=prep)
        loss, _ = reconstruction_loss(preds, frames, 0.05)
        loss.backward()
        torch.cuda.synchronize()
        return {n: (None if p.grad is None else p.grad.detach().clone())
                for n, p in gen.named_parameters()}

    reset_launches()
    got = grads()
    launches = read_launches()
    for name in ("combine_table_multi", "combine_table_multi_bwd", "maxpool2_duplicate"):
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
    print(f"gradients at batch {TRAIN_BATCH}: all {len(got)} generator parameters "
          f"finite, input.* and Convsin.* non-zero; input.* vs plain versions on "
          f"the card: max {worst:.2e} x max|grad|; launches {launches}")


def write_train_tree(tmp: Path) -> Path:
    """Fake train store (64-frame events, window 16), 79-gauge mask and the
    shipped GAN config pointed at them."""
    fake.write_train_zarr(tmp / "nimrod_train.zarr", n_events=TRAIN_EVENTS,
                          T=EVENT_FRAMES, H=H, W=W, window=LENGTH, stride=1, seed=SEED)
    mask = fake.write_gauge_mask(tmp / "masks" / "gauge_mask_128_train.txt", H=H, W=W,
                                 n_gauges=79, seed=SEED)
    (tmp / "test_events").mkdir(exist_ok=True)
    cfg = load_config(TRAIN_CONFIG)
    cfg["data"]["train"]["data_root"] = str(tmp / "nimrod_train.zarr")
    cfg["data"]["test"]["data_root"] = str(tmp / "test_events")
    for split in ("train", "test"):
        cfg["data"][split]["mask"]["file"] = str(mask)
    cfg["train"].update(iterations=WARMUP_STEPS + TIMED_STEPS, log_step=WARMUP_STEPS)
    if cfg["train"]["batch_size"] != TRAIN_BATCH or cfg["model"]["base_channels"] != BASE:
        fail(f"{TRAIN_CONFIG.name} is no longer batch {TRAIN_BATCH}, base {BASE}")
    return cfg


def train(tmp: Path, card: str, dev) -> dict:
    """The GAN through scripts/train_torch.py, with device_decode off and on."""
    spec = importlib.util.spec_from_file_location(
        "train_torch", REPO / "scripts" / "train_torch.py")
    train_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_torch)
    os.environ["P2IGAN_FORCE_FILE_TRACKER"] = "1"
    from p2igan_tpu_torch.utils.tracking import get_tracker

    get_tracker().set_tracking_uri(str(tmp / "mlruns"))
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
            # takes two steps of epoch 2
            cfg["train"].update(iterations=s1 + 2, max_epochs=2)
            cfg_path.write_text(json.dumps(cfg))
            resumed = train_torch.main(train_torch.parse_args(
                argv + ["--resume", str(latest)]))
            if resumed.global_step != s1 + 2 or not np.isfinite(resumed.last_rec_loss):
                fail(f"resume ended at step {resumed.global_step}")
            print(f"resume from latest.ckpt continued to step {resumed.global_step}")
    return launches


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
               "decode_normalize_mask": check_decode(dev)}

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        cfg_path = write_serving_tree(tmp)
        _, events_per_s = serve(tmp, cfg_path, dev)
        check_against_cpu(tmp, cfg_path, dev)
        print(f"serving: {events_per_s:.4f} events/s on {card}")
        check_gradients(dev)
        launches = train(tmp, card, dev)

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **results[name]}
               for name, (_, src, rep) in KERNELS.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
