"""The rank processes of ``tests/test_torch_parallel.py``: one spawn of a
gloo group over a ``file://`` store (no port, no clash between test workers)
runs every case in turn on every rank, and each writes what it got to
``rank{r}_<case>.pt``; the test compares. The port's side only: this module imports no JAX, so the
ranks start quickly; the test also calls its model and step helpers for
the single process."""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from p2igan_tpu_torch.data import fake
from p2igan_tpu_torch.inference.driver import SlidingWindowReconstructor, run_inference
from p2igan_tpu_torch.metrics import metric as M
from p2igan_tpu_torch.models import (DKGenerator, P2IDiscriminator, P2IGenerator,
                                     SimpleDiscriminator, SimpleGenerator)
from p2igan_tpu_torch.ops.idw import factored_prepare_full
from p2igan_tpu_torch.parallel import create_mesh, shard_rows
from p2igan_tpu_torch.training import steps as tsteps
from p2igan_tpu_torch.training import trainer as trainer_module
from p2igan_tpu_torch.training.checkpoint import load_generator_state
from p2igan_tpu_torch.training.trainer import Trainer

T = 4
OPT = {"lr": 1e-4, "beta1": 0.0, "beta2": 0.99}
GAN = dict(use_gan=True, gan_loss_type="hinge", adversarial_weight=0.01, k1_alpha=0.05)
# the step cases: (generator, discriminator or None, step kwargs)
P2I_KW = dict(H=32, W=32, length=T, num_res=1, base_channels=16, idw_max_points=128,
              idw_factored=True, idw_shared_batch_mask=True)


def models(kind: str):
    """(generator, discriminator or None, step kwargs) of a step case, with
    seeded weights (p2igan's are replaced by the JAX package's)."""
    g = torch.Generator().manual_seed(3)
    if kind == "p2igan":
        return (P2IGenerator(**P2I_KW, generator=g),
                P2IDiscriminator(in_channels=T, channels=1), GAN)
    if kind == "simple_rec":
        return SimpleGenerator(base_channels=8, generator=g), None, dict(
            use_gan=False, k1_alpha=0.05)
    if kind == "simple_gan":
        return (SimpleGenerator(base_channels=8, generator=g),
                SimpleDiscriminator(base_channels=8, generator=g), GAN)
    if kind == "dk":
        return DKGenerator(length=T, visible_k=7, shared_batch_mask=True), None, dict(
            use_gan=False, k1_alpha=0.05)
    raise ValueError(kind)


def run_step(kind: str, states: dict, batch: tuple, mesh=None) -> dict:
    """One train step of ``kind`` from ``states`` on ``batch`` (numpy, the
    global batch; each rank of ``mesh`` takes its rows): the metrics, every
    parameter's gradient and the modules' states after the step."""
    gen, disc, kw = models(kind)
    gen.load_state_dict(states["gen"])
    opt_d = None
    if disc is not None:
        disc.load_state_dict(states["disc"])
        opt_d = tsteps.make_optimizer(OPT, disc.parameters())
    opt_g = tsteps.make_optimizer(OPT, gen.parameters())
    prep = None
    if kind == "p2igan":  # the hoisted stis selection, from the shared mask
        prep = factored_prepare_full(torch.from_numpy(batch[2][0, 0, :, :, 0]), 128)
    step = tsteps.build_train_step(gen, disc, opt_g, opt_d, idw_prepared=prep,
                                   mesh=mesh, **kw)
    rows = batch if mesh is None else shard_rows(batch, mesh.rank, mesh.world)
    m = step(*(torch.from_numpy(np.ascontiguousarray(a)) for a in rows))
    out = {"metrics": {k: float(v) for k, v in m.items()}}
    for name, module in (("gen", gen), ("disc", disc)):
        if module is not None:
            out[name] = {k: v.clone() for k, v in module.state_dict().items()}
            out[name + "_grad"] = {k: p.grad.clone() for k, p in module.named_parameters()
                                   if p.grad is not None}
    return out


def trainer_config(root: Path, save_dir: Path, iterations: int,
                   max_epochs=None) -> dict:
    """A p2igan stis GAN at 32x32, global batch 4, validation with the
    metric suite (the tree of ``write_trainer_tree``)."""
    train = {"iterations": iterations, "optimizer": OPT, "batch_size": 4,
             "num_workers": 2, "log_step": 1, "use_validation": True,
             "eval_metrics": True}
    if max_epochs is not None:
        train["max_epochs"] = max_epochs
    return {
        "seed": 7, "save_dir": str(save_dir), "experiment_name": "parallel",
        "run_name": "run",
        "model": {"name": "p2igan", "in_channels": 1, "out_channels": 1,
                  "base_channels": 4 * T},
        "data": {"train": {"data_root": str(root / "train.zarr"), "w": 32, "h": 32,
                           "sample_length": T,
                           "mask": {"type": "stis", "file": str(root / "gauges.txt")}}},
        "loss": {"adversarial_weight": 0.01, "k1_weight": 0.05, "gan_loss": "hinge",
                 "use_gan": 1},
        "train": train,
    }


def write_trainer_tree(root: Path) -> None:
    """25 windows: 20 train (5 batches of 4), 5 validation (batches of 4
    and 1: the last one every rank takes whole)."""
    fake.write_train_zarr(root / "train.zarr", n_events=5, T=12, H=32, W=32,
                          window=T, stride=2, seed=0)
    fake.write_gauge_mask(root / "gauges.txt", H=32, W=32, n_gauges=9, seed=1)


def resolved_gradients(trainer, resolved: dict) -> None:
    """Wrap the trainer's steps: after each, mark in ``resolved`` (by (module,
    parameter)) the elements whose gradient stood above 1e-6 x the module's
    largest at every step so far (the rest hold rounding noise of a zero)."""
    build = trainer._build_steps

    def rebuild(idw_prepared=None):
        build(idw_prepared)
        step = trainer.train_step

        def recording(*batch):
            metrics = step(*batch)
            for name, module in (("gen", trainer.generator),
                                 ("disc", trainer.discriminator)):
                grads = {k: p.grad for k, p in module.named_parameters()
                         if p.grad is not None}
                top = max(float(g.abs().max()) for g in grads.values())
                for k, g in grads.items():
                    ok = g.abs() > 1e-6 * top
                    resolved[name, k] = resolved[name, k] & ok if (name, k) in resolved \
                        else ok
            return metrics

        trainer.train_step = recording

    trainer._build_steps = rebuild
    rebuild()


def train(cfg: dict, resume=None) -> dict:
    """A Trainer run: its end state, counters, the checkpoints it wrote and
    its gradients' elements above the noise floor at every step."""
    saved, resolved = [], {}
    save = trainer_module.save_checkpoint

    def recording(path, payload):
        saved.append(Path(path).name)
        save(path, payload)

    trainer_module.save_checkpoint = recording
    try:
        trainer = Trainer(cfg, device="cpu")
        resolved_gradients(trainer, resolved)
        if resume is not None:
            trainer.load(resume)
        trainer.train()
    finally:
        trainer_module.save_checkpoint = save
    return {"step": trainer.global_step, "saved": saved,
            "losses": (trainer.last_rec_loss, trainer.last_adv_loss,
                       trainer.last_dis_loss),
            **{name: {k: v.clone() for k, v in module.state_dict().items()}
               for name, module in (("gen", trainer.generator),
                                    ("disc", trainer.discriminator))},
            "resolved": resolved,
            "nu": [s["nu"].clone() for s in trainer.opt_g.state.values()]}


# -- the cases (every rank) ----------------------------------------------

def _steps(mesh, tmp: Path) -> dict:
    spec = torch.load(tmp / "steps.pt", weights_only=False)
    return {kind: run_step(kind, states, spec["batch"][kind], mesh)
            for kind, states in spec["states"].items()}


def _suite_and_serving(mesh, tmp: Path) -> dict:
    spec = torch.load(tmp / "suite.pt", weights_only=False)
    preds, target = spec["preds"], spec["target"]
    shards = range(mesh.rank * 4, mesh.rank * 4 + 4)
    cat = M.categorical_metrics_init(len(spec["thresholds"]))
    suite = M.RainfallMetricSuite(device="cpu")
    for i in shards:
        cat = M.categorical_metrics_update(cat, torch.from_numpy(preds[i]),
                                           torch.from_numpy(target[i]),
                                           spec["thresholds"])
        suite.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    out = {"categorical": M.RainfallMetricSuite.all_reduce_state(cat, mesh),
           "suite": suite.all_reduce_state(suite.state, mesh)}

    cfg = json.loads((tmp / "serve.json").read_text())
    kw = dict(checkpoint=str(tmp / "gen.pt"), stride=T, overlap=2, window_batch=2,
              device="cpu")
    # batch_events 1: rank 0 serves alone; the others return with no collective
    out["solo"] = run_inference(json.loads(json.dumps(cfg)), batch_events=1,
                                output=str(tmp / "solo.zarr"), **kw)
    out["store"] = run_inference(cfg, batch_events=2, output=str(tmp / "dealt.zarr"), **kw)
    gen = P2IGenerator(H=32, W=32, length=T, base_channels=16, idw_factored=True,
                       idw_shared_batch_mask=True)
    gen.load_state_dict(load_generator_state(tmp / "gen.pt"))
    recon = SlidingWindowReconstructor(gen.fold_for_inference(), stride=T, overlap=2,
                                       window_batch=2)
    out["differing_masks"] = recon.batch(spec["masked"], spec["masks"], mesh)
    return out


def _trainer(mesh, tmp: Path) -> dict:
    first = train(trainer_config(tmp, tmp / "dp", 3))
    resumed = train(trainer_config(tmp, tmp / "dp", 5, max_epochs=2),
                    resume=tmp / "dp" / "latest.ckpt")
    return {"first": first, "resumed": resumed}


CASES = {"steps": _steps, "suite_and_serving": _suite_and_serving, "trainer": _trainer}


def _entry(rank: int, world: int, tmp: str) -> None:
    tmp = Path(tmp)
    torch.set_num_threads(2)
    os.environ["P2IGAN_FORCE_FILE_TRACKER"] = "1"
    from p2igan_tpu_torch.utils.tracking import get_tracker

    get_tracker().set_tracking_uri(str(tmp / f"mlruns_rank{rank}"))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        mesh = create_mesh("cpu")
        assert (mesh.rank, mesh.world, mesh.distributed) == (rank, world, True)
        for case, run in CASES.items():
            torch.save(run(mesh, tmp), tmp / f"rank{rank}_{case}.pt")
    finally:
        dist.destroy_process_group()


def start(tmp: Path, world: int = 2):
    """Start every case on ``world`` gloo ranks; :func:`finish` waits for
    them."""
    return mp.spawn(_entry, args=(world, str(tmp)), nprocs=world, join=False)


def finish(context, tmp: Path) -> dict:
    """Wait for the ranks of ``context``; what each rank got, by case and
    rank."""
    while not context.join():
        pass
    return {case: [torch.load(tmp / f"rank{r}_{case}.pt", weights_only=False)
                   for r in range(len(context.processes))] for case in CASES}
