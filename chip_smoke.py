"""Bring-up check of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs one GPU

1. Prints the card (nvidia-smi name and power limit) and versions, then
   builds the CUDA kernels from ``p2igan_tpu_torch/csrc``.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes of the stis serving path (p2igan_baseline_eval.json: 128x128,
   T=16, window batch 8, G=128 gauge slots, k=4), and times both (median of
   CUDA-event timings):
   - gauge_topk: gsel equal and gd2 bitwise equal, on a random 79-gauge mask
     and on a tie-heavy regular grid;
   - combine_table_multi: max abs error <= 1e-5 at N=8 windows, and the
     highest-weight gauge slot of every (z, pixel) identical (one-hot tables,
     one window per slot);
   - maxpool2_duplicate: bitwise equal at the three pyramid shapes.
3. Serves two 64-frame 128x128 fake events through ``scripts/infer_torch.py``
   (seeded full-width generator saved as a reference-layout .pt, stride 16,
   overlap 12, window batch 8) and checks the output store, that every
   kernel was launched by that run, and that the card's reconstruction agrees
   with the port's plain CPU path on a 16-frame event (atol 1e-4 x 255).
4. Prints a JSON line per kernel result, then ``{"ok": true, "device": ...}``
   as the last line. Any failed check exits non-zero without that line.
"""

from __future__ import annotations

import importlib.util
import json
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
from p2igan_tpu_torch.models import P2IGenerator
from p2igan_tpu_torch.ops import cuda_lib
from p2igan_tpu_torch.ops.doconv import make_d_diag
from p2igan_tpu_torch.ops.idw import factored_prepare_full, gauge_geometry
from p2igan_tpu_torch.ops.idw_factored_kernel import (
    combine_table_multi, combine_table_multi_reference, gauge_topk,
    gauge_topk_reference)
from p2igan_tpu_torch.ops.pool_dup import (maxpool2_duplicate,
                                           maxpool2_duplicate_reference)

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "p2igan_tpu" / "config" / "p2igan_baseline_eval.json"
SEED = 2024
H = W = 128
LENGTH, BASE, NUM_RES, WINDOW_BATCH, G, K = 16, 64, 4, 8, 128, 4
EVENTS, EVENT_FRAMES = 2, 64
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
}


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
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = infer_torch.main(argv("served.zarr"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, (fn, _, _) in KERNELS.items()}
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
    for name, n in launches.items():
        if n <= 0:
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
               "maxpool2_duplicate": check_pool_dup(dev)}

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        cfg_path = write_serving_tree(tmp)
        launches, events_per_s = serve(tmp, cfg_path, dev)
        check_against_cpu(tmp, cfg_path, dev)
    print(f"serving: {events_per_s:.4f} events/s on {card}")

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
