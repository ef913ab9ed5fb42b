"""Data parallelism of the PyTorch port (``p2igan_tpu_torch/parallel``) on the
CPU: two gloo ranks (``tests/torch_parallel_ranks.py``) against the port's
single process and the JAX package.

Tolerances: a step on two ranks against one step on the whole batch, losses
within 1e-4 and parameters within 1e-5 (``tests/test_parallel.py``'s
data-parallel step); the running statistics rtol 1e-5, atol 1e-6 (the
simple family's parity tests); the p2igan step's losses and gradients
against the JAX package's rtol 1e-4, atol 1e-4 x max|grad| (its single-step
parity test). The ranks' states are bitwise equal; the served stores are
bitwise the single process's; metric counts are exact, other leaves rtol
1e-6.

Where a gradient is zero in exact arithmetic, both runs hold rounding noise
of it (a convolution bias that feeds a BatchNorm; an output the critic
cancels), and Adam's first step moves such an element by up to lr either
way, whatever the noise: the parameter check then takes the elements whose
gradient on both sides is above 1e-6 x the largest of the module's (the
noise sits 1e-7 under it), and bounds the rest by Adam's largest move, lr a
step each way. Every gradient is held within 1e-4 of its value plus 1e-5 x
the module's largest.
"""

import contextlib
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import PartitionSpec as P

from p2igan_tpu.metrics import metric as JM
from p2igan_tpu.models import P2IDiscriminator as JaxDiscriminator
from p2igan_tpu.models import P2IGenerator as JaxGenerator
from p2igan_tpu.parallel import mesh as jmesh
from p2igan_tpu.training import steps as jsteps
from p2igan_tpu_torch.data import fake, zarrlite
from p2igan_tpu_torch.inference.driver import SlidingWindowReconstructor, run_inference
from p2igan_tpu_torch.metrics import metric as M
from p2igan_tpu_torch.models import P2IGenerator
from p2igan_tpu_torch.models.convert import params_from_jax, state_dict_from_jax
from p2igan_tpu_torch.parallel import create_mesh, pad_to_multiple, shard_rows
from p2igan_tpu_torch.training.checkpoint import load_generator_state
from p2igan_tpu_torch.utils.tracking import get_tracker

import torch_parallel_ranks as ranks
from test_torch_gan import _capture, _port_disc

B, HW, T = 4, 32, ranks.T
THRESHOLDS = (0.5, 2.0)


@pytest.fixture(autouse=True)
def _file_tracker(monkeypatch, tmp_path):
    monkeypatch.setenv("P2IGAN_FORCE_FILE_TRACKER", "1")
    get_tracker().set_tracking_uri(str(tmp_path / "mlruns"))


@contextlib.contextmanager
def _threads(n: int):
    """This process's torch work on ``n`` threads, as each rank's."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _compiled(jitted, *args):
    """``jitted`` compiled for ``args`` without XLA's backend (LLVM)
    optimisation: the same program, compiled in a tenth of the CPU time."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": "0"})


def _close(got, want, atol, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol,
                               err_msg=err_msg)


def _assert_params(got: dict, want: dict, resolved: dict, steps: int = 1,
                   name: str = "") -> None:
    """Parameters within 1e-5 where ``resolved`` (the gradient above the
    noise floor on both sides, at every step), within Adam's bound (lr a
    step each way) elsewhere."""
    for key, ok in resolved.items():
        diff = (got[key] - want[key]).abs()
        _close(diff[ok], 0.0, 1e-5, f"{name}.{key}")
        assert float(diff.max()) <= 2 * ranks.OPT["lr"] * steps, f"{name}.{key}"


def _assert_gradients(got: dict, want: dict, name: str = "") -> dict:
    """Every gradient within 1e-4 x |g| + 1e-5 x the module's largest; the
    elements above the noise floor on both sides."""
    top = max(float(g.abs().max()) for g in want.values())
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-5 * top,
                                   err_msg=f"{name}.{key} gradient")
    return {key: (w.abs() > 1e-6 * top) & (got[key].abs() > 1e-6 * top)
            for key, w in want.items()}


def _bitwise(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("n,world", [(10, 4), (8, 4), (5, 2), (3, 1), (12, 8)])
def test_pad_to_multiple_and_shard_rows_match_the_jax_mesh(n, world):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got, got_n = pad_to_multiple(x, world)
    want, want_n = jmesh.pad_to_multiple(x, world)
    np.testing.assert_array_equal(got, want)
    assert got_n == want_n
    # batch_sharding's rows of rank r: the r-th contiguous block of n // world
    shards = [shard_rows((x, x + 1), r, world) for r in range(world)]
    if n % world:  # replicated, as the JAX trainer puts such a batch
        assert all(s[0] is x for s in shards)
    else:
        np.testing.assert_array_equal(np.concatenate([s[0] for s in shards]), x)
        np.testing.assert_array_equal(np.concatenate([s[1] for s in shards]), x + 1)
        assert {len(s[0]) for s in shards} == {n // world}


def test_a_run_without_torchrun_creates_no_process_group(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    mesh = create_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.distributed, mesh.is_main) == (0, 1, False, True)
    assert mesh.device == torch.device("cpu") and not dist.is_initialized()
    g = torch.ones(3)
    mesh.mean_(g)
    mesh.barrier()
    assert torch.equal(g, torch.ones(3))  # no collective, no division
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        create_mesh("cuda")


# -- one step on two ranks ----------------------------------------------------

def _p2igan_case(rng):
    """The JAX package's generator and critic weights, the port's states from
    them, a B=4 batch under one shared stis mask and the JAX step (a function
    returning its new state and metrics; ``_capture`` keeps the
    gradients)."""
    flat = np.zeros(HW * HW, np.float32)
    flat[rng.choice(HW * HW, 9, replace=False)] = 1.0
    masks = np.broadcast_to(flat.reshape(1, 1, HW, HW, 1), (B, T, HW, HW, 1)).copy()
    frames = rng.random((B, T, HW, HW, 1), dtype=np.float32)
    masked = frames * masks
    # compiled inits: op by op they take 20 s each on the CPU
    jgen = JaxGenerator(**ranks.P2I_KW)
    args = (jax.random.key(0), jnp.asarray(masked), jnp.asarray(masks))
    gvars = dict(_compiled(jax.jit(jgen.init), *args)(*args))
    jdisc = JaxDiscriminator(in_channels=T)
    args = (jax.random.key(1), jnp.asarray(frames[:2]))
    dvars = dict(_compiled(jax.jit(jdisc.init), *args)(*args))
    gp, dp = gvars.pop("params"), dvars["params"]
    dextra = {k: v for k, v in dvars.items() if k != "params"}
    jopt_g = optax.chain(_capture(), jsteps.make_optimizer(ranks.OPT))
    jopt_d = optax.chain(_capture(), jsteps.make_optimizer(ranks.OPT))
    state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gp,
                              gen_extra=gvars, opt_g=jopt_g.init(gp), disc_params=dp,
                              disc_extra=dextra, opt_d=jopt_d.init(dp))
    prep = ranks.factored_prepare_full(torch.from_numpy(masks[0, 0, :, :, 0]), 128)
    jstep = jsteps.build_train_step(
        jgen, jdisc, jopt_g, jopt_d, donate=False, fused_disc_forward=True,
        idw_prepared=tuple(jnp.asarray(t.numpy()) for t in prep), **ranks.GAN)
    states = {"gen": state_dict_from_jax({"params": gp}),
              "disc": _port_disc(dvars).state_dict()}
    args = (state, *(jnp.asarray(a) for a in (frames, masked, masks)))
    return states, (frames, masked, masks), lambda: _compiled(jstep, *args)(*args)


def _seeded_case(kind, rng):
    gen, disc, _ = ranks.models(kind)
    states = {"gen": gen.state_dict()}
    if disc is not None:
        states["disc"] = disc.state_dict()
    if kind == "dk":
        masks = np.zeros((B, T, HW * HW, 1), np.float32)
        masks[:, :, rng.choice(HW * HW, 7, replace=False)] = 1.0
        masks = masks.reshape(B, T, HW, HW, 1)
        size = (B, T, HW, HW, 1)
    else:
        size = (B, T, 16, 16, 1)
        masks = (rng.random(size) < 0.3).astype(np.float32)
    frames = rng.random(size, dtype=np.float32)
    return states, (frames, frames * masks, masks)


@pytest.fixture(scope="module")
def parallel(tmp_path_factory):
    """Every case's inputs, then one spawn of two gloo ranks that runs them
    all (``torch_parallel_ranks.CASES``) while this process runs the JAX
    package's p2igan step and the single process's steps, stores and
    trainer run."""
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(5)
    states, batches = {}, {}
    states["p2igan"], batches["p2igan"], jax_step = _p2igan_case(rng)
    for kind in ("simple_rec", "simple_gan", "dk"):
        states[kind], batches[kind] = _seeded_case(kind, rng)
    torch.save({"states": states, "batch": batches}, tmp / "steps.pt")
    rng = np.random.default_rng(6)
    # values from [0, 60] cross the transform's thresholds (metrics tests)
    preds = (rng.random((8, 2, 16, 16)) * 60).astype(np.float32)
    target = (rng.random((8, 2, 16, 16)) * 60).astype(np.float32)
    masked, masks = _differing_masks(rng)
    cfg = _serving_tree(tmp)
    torch.save({"preds": preds, "target": target, "thresholds": THRESHOLDS,
                "masked": masked, "masks": masks}, tmp / "suite.pt")
    ranks.write_trainer_tree(tmp)
    context = ranks.start(tmp)
    jax_out = jax_step()
    with _threads(2), pytest.MonkeyPatch.context() as patch:
        patch.setenv("P2IGAN_FORCE_FILE_TRACKER", "1")
        get_tracker().set_tracking_uri(str(tmp / "mlruns_single"))
        single = {kind: ranks.run_step(kind, states[kind], batches[kind])
                  for kind in states}
        kw = dict(checkpoint=str(tmp / "gen.pt"), stride=T, overlap=2, window_batch=2,
                  device="cpu")
        stores = {be: run_inference(json.loads(json.dumps(cfg)), batch_events=be,
                                    output=str(tmp / f"single_be{be}.zarr"), **kw)
                  for be in (1, 2)}
        trainer = ranks.train(ranks.trainer_config(tmp, tmp / "one", 3))
    return SimpleNamespace(tmp=tmp, dealt=ranks.finish(context, tmp), steps=single,
                           jax=jax_out, stores=stores, trainer=trainer,
                           suite=(preds, target, masked, masks))


@pytest.mark.parametrize("kind", ["p2igan", "simple_rec", "simple_gan", "dk"])
def test_a_step_on_two_ranks_is_the_step_on_the_whole_batch(parallel, kind):
    """Losses within 1e-4 and parameters within 1e-5 of one process's step
    on the global batch; for simple the running statistics too (every
    BatchNorm's statistics are the global batch's); both ranks end with
    bitwise-equal states."""
    dealt, single = [r[kind] for r in parallel.dealt["steps"]], parallel.steps[kind]
    for key, value in single["metrics"].items():
        # a rank's metrics are its rows'; the loss of the batch is their mean
        mean = np.mean([r["metrics"][key] for r in dealt])
        _close(mean, value, 1e-4, key)
    for name in ("gen", "disc"):
        if name not in single:
            continue
        _bitwise(dealt[0][name], dealt[1][name])
        _bitwise(dealt[0][name + "_grad"], dealt[1][name + "_grad"])
        grads = single[name + "_grad"]
        resolved = _assert_gradients(dealt[0][name + "_grad"], grads, name)
        _assert_params(dealt[0][name], single[name], resolved, name=name)
        for key, want in single[name].items():
            got = dealt[0][name][key]
            if "running" in key:
                # the critic's third forward runs on its updated biases, which
                # took Adam's noise step: its running means may differ by
                # momentum x 2 lr = 2e-5 (the simple parity tests' bound)
                np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key,
                                           atol=3e-5 if "features" in key else 1e-6)
            elif key not in grads:  # the spectral vectors
                _close(got, want, 1e-5, f"{name}.{key}")
    if kind.startswith("simple"):
        moved = dealt[0]["gen"]["encoder.0.1.running_mean"]
        assert float(moved.abs().max()) > 1e-3  # the statistics did advance


def test_the_p2igan_step_on_two_ranks_matches_the_jax_step(parallel):
    dealt, (new, jm) = parallel.dealt["steps"], parallel.jax
    for key in ("loss", "rec_loss", "adv_loss", "dis_loss", "pool", "reg"):
        mean = np.mean([r["p2igan"]["metrics"][key] for r in dealt])
        np.testing.assert_allclose(mean, float(jm[key]), rtol=1e-4, err_msg=key)
    for name, module, jgrads in (("gen", P2IGenerator(**ranks.P2I_KW), new.opt_g[0]),
                                 ("disc", ranks.models("p2igan")[1], new.opt_d[0])):
        want = params_from_jax(module, jgrads)
        got = dealt[0]["p2igan"][name + "_grad"]
        for key, w in want.items():
            w = w.numpy()
            if key not in got:  # alpha3d: unused, JAX's gradient is zero
                np.testing.assert_array_equal(w, 0.0, err_msg=key)
                continue
            np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=key)


# -- metric state and serving -------------------------------------------------

def _serving_tree(tmp, n_events=3, ev_t=10):
    rng = np.random.default_rng(0)
    store = zarrlite.open_group(tmp / "test.zarr", mode="w")
    for i in range(n_events):
        frames = fake.synthesize_event(rng, ev_t, HW, HW).astype(np.float32)
        store.create_dataset(f"event_{i + 1:02d}", shape=frames.shape,
                             chunks=frames.shape, dtype="float32", data=frames,
                             compressor={"id": "zlib", "level": 1})
    mask = fake.write_gauge_mask(tmp / "mask.txt", H=HW, W=HW, n_gauges=9, seed=2)
    mask_cfg = {"type": "stis", "file": str(mask)}
    cfg = {"seed": 1, "model": {"name": "p2igan", "in_channels": 1, "base_channels": 16},
           "data": {"train": {"data_root": str(tmp / "test.zarr"), "w": HW, "h": HW,
                              "sample_length": T, "mask": mask_cfg},
                    "test": {"data_root": str(tmp / "test.zarr"), "w": HW, "h": HW,
                             "sample_length": None}},
           "train": {"num_workers": 1}}
    (tmp / "serve.json").write_text(json.dumps(cfg))
    gen = P2IGenerator(H=HW, W=HW, length=T, base_channels=16, idw_factored=True,
                       idw_shared_batch_mask=True,
                       generator=torch.Generator().manual_seed(0))
    torch.save(gen.state_dict(), tmp / "gen.pt")
    return cfg


def _differing_masks(rng, ev_t=10):
    """Two events under two 9-gauge masks: the hoisted selection of event 0
    must not serve event 1."""
    masks = np.zeros((2, ev_t, HW, HW, 1), np.float32)
    for e in range(2):
        flat = np.zeros(HW * HW, np.float32)
        flat[rng.choice(HW * HW, 9, replace=False)] = 1.0
        masks[e] = flat.reshape(1, HW, HW, 1)
    return rng.random(masks.shape, dtype=np.float32) * masks, masks


def test_all_reduce_state_is_the_jax_psum_state(parallel):
    """8 shards (tests/test_parallel.py's shapes), 4 a rank, against
    ``psum_state`` under ``shard_map`` on the 8-device CPU mesh."""
    dealt, (preds, target, _, _) = parallel.dealt["suite_and_serving"], parallel.suite

    def local_update(p, t):
        st = JM.categorical_metrics_init(len(THRESHOLDS))
        st = JM.categorical_metrics_update(st, p[0], t[0], THRESHOLDS)
        return JM.RainfallMetricSuite.psum_state(st, "data")

    mesh = jmesh.create_mesh()
    assert int(np.prod(mesh.devices.shape)) == 8
    f = shard_map(local_update, mesh=mesh, in_specs=(P("data"), P("data")),
                  out_specs=P())
    want = f(jnp.asarray(preds), jnp.asarray(target))
    for r in range(2):
        got = dealt[r]["categorical"]
        assert set(got) == set(want)
        for k in want:  # every categorical leaf is a count: exact
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
            assert float(got[k].min()) > 0, k


def test_all_reduce_state_of_the_suite_is_the_single_process_state(parallel):
    dealt, (preds, target, _, _) = parallel.dealt["suite_and_serving"], parallel.suite
    suite = M.RainfallMetricSuite(device="cpu")
    for i in range(8):
        suite.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    assert M.RainfallMetricSuite.all_reduce_state(suite.state, create_mesh("cpu")) \
        is suite.state
    for r in range(2):
        got = dealt[r]["suite"]
        assert isinstance(got, tuple) and len(got) == 3
        for g, w in zip(got, suite.state):
            assert g.keys() == w.keys()
            for k in w:
                if k in ("n_obs", "ssim_n", "hits", "misses", "false", "correct",
                         "counts"):
                    np.testing.assert_array_equal(g[k].numpy(), w[k].numpy(), err_msg=k)
                else:
                    np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=1e-6,
                                               err_msg=k)


def test_serving_on_two_ranks_is_the_single_process_store_bit_for_bit(parallel):
    """batch_events 2 over 3 events of 10 frames (5 windows each, chunks of
    2: a batch of 5 chunks, then one of 3), rank 0 writing; then two events
    under different masks, each served under its own gauge selection."""
    tmp, dealt, (_, _, masked, masks) = (parallel.tmp, parallel.dealt["suite_and_serving"],
                                         parallel.suite)
    single = parallel.stores[2]
    assert dealt[0]["store"] == dealt[1]["store"] == tmp / "dealt.zarr"
    a, b = zarrlite.open(single, mode="r"), zarrlite.open(tmp / "dealt.zarr", mode="r")
    assert a.array_keys() == b.array_keys() == ["event_01", "event_02", "event_03"]
    for key in a.array_keys():
        assert a[key][:].tobytes() == b[key][:].tobytes(), key
        assert a[key][:].max() > 1.0

    gen = P2IGenerator(H=HW, W=HW, length=T, base_channels=16, idw_factored=True,
                       idw_shared_batch_mask=True)
    gen.load_state_dict(load_generator_state(tmp / "gen.pt"))
    recon = SlidingWindowReconstructor(gen.fold_for_inference(), stride=T, overlap=2,
                                       window_batch=2)
    want = recon.batch(masked, masks)
    assert dealt[1]["differing_masks"] is None
    assert dealt[0]["differing_masks"].tobytes() == want.tobytes()
    # and that is each event's own reconstruction, not event 0's selection
    for e in range(2):
        assert recon(masked[e], masks[e]).tobytes() == want[e].tobytes()
    shared = recon.batch(masked, np.broadcast_to(masks[:1], masks.shape).copy())
    assert not np.array_equal(shared[1], want[1])


def test_serving_one_event_at_a_time_on_two_ranks_is_rank_0_alone(parallel):
    """batch_events 1, as the JAX package, serves on one device: rank 0
    writes the single process's store bit for bit and the other rank returns
    at once, with no collective (it went on to the next calls' collectives
    in step with rank 0)."""
    tmp, dealt = parallel.tmp, parallel.dealt["suite_and_serving"]
    assert [r["solo"] for r in dealt] == [tmp / "solo.zarr"] * 2
    a = zarrlite.open(parallel.stores[1], mode="r")
    b = zarrlite.open(tmp / "solo.zarr", mode="r")
    assert a.array_keys() == b.array_keys() == ["event_01", "event_02", "event_03"]
    for key in a.array_keys():
        assert a[key][:].tobytes() == b[key][:].tobytes(), key


# -- the trainer ----------------------------------------------------------------

def test_trainer_on_two_ranks_saves_on_rank_0_and_resumes(parallel):
    """3 GAN steps with validation (eval_metrics) on two ranks: rank 0 alone
    writes latest.ckpt, which holds what the single process's run holds
    (parameters within 1e-5); a resume from it continues on both ranks to
    step 5, both ending bitwise equal."""
    tmp, dealt, single = parallel.tmp, parallel.dealt["trainer"], parallel.trainer
    first = [r["first"] for r in dealt]
    assert first[0]["saved"] == ["latest.ckpt", "best.ckpt"] and first[1]["saved"] == []
    assert [f["step"] for f in first] == [3, 3]
    for name in ("gen", "disc"):
        resolved = {k: ok & first[0]["resolved"][n, k]
                    for (n, k), ok in single["resolved"].items() if n == name}
        _assert_params(first[0][name], single[name], resolved, steps=3, name=name)
        for key, want in single[name].items():
            if key not in resolved:  # the spectral vectors
                _close(first[0][name][key], want, 1e-5, f"{name}.{key}")
    for got, want in zip(first[0]["losses"], single["losses"]):
        _close(got, want, 1e-4)
    resumed = [r["resumed"] for r in dealt]
    ckpt = torch.load(tmp / "dp" / "latest.ckpt", weights_only=False)
    _bitwise(ckpt["generator"]["params"],
             {k: resumed[1]["gen"][k] for k in ckpt["generator"]["params"]})
    assert [r["step"] for r in resumed] == [5, 5]
    assert resumed[0]["saved"][0] == "latest.ckpt" and resumed[1]["saved"] == []
    _bitwise(resumed[0]["gen"], resumed[1]["gen"])
    _bitwise(resumed[0]["disc"], resumed[1]["disc"])
    for a, b in zip(resumed[0]["nu"], resumed[1]["nu"]):
        assert torch.equal(a, b)
    assert any(not torch.equal(v, first[0]["gen"][k]) for k, v in resumed[0]["gen"].items())
    logged = [json.loads(line) for line in
              next((tmp / "mlruns_rank0").rglob("metrics.jsonl")).read_text()
              .splitlines()]
    keys = {m["key"] for m in logged}
    assert {"val/loss", "val/mae", "train/steps_per_sec", "train/step_loss"} <= keys
    assert not (tmp / "mlruns_rank1").exists()
