"""JAX trainer checkpoints in the port, on the CPU: the flax-free decoder
(``p2igan_tpu_torch/utils/flax_msgpack.py``) against flax's own, resume
(``Trainer.load``) against the JAX trainer's, serving (``load_generator``,
``run_inference``) against the JAX driver's, and the committed fixture
(``tests/fixtures/jax_ckpt``).

Tolerances: the decoder is bitwise flax's. After a resume the restored state
is bitwise the checkpoint's (converted), and one step from it is held as the
existing step tests hold a step: the parameters where the gradient is not
within 1e-3 x max of zero at atol 1e-2 x lr (``tests/test_torch_sti_train.py``).
Served stores: atol 1e-4 x 255 on single-gauge masks
(``tests/test_torch_inference.py``); dk/stdk forwards atol 1e-4
(``tests/test_torch_dk_model.py``), simple rtol 1e-4.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import flax.serialization as ser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2igan_tpu.data import zarrlite
from p2igan_tpu.inference import driver as jdriver
from p2igan_tpu.models import DKGenerator as JaxDK
from p2igan_tpu.models import P2IDiscriminator as JaxDiscriminator
from p2igan_tpu.models import P2IGenerator as JaxGenerator
from p2igan_tpu.models import SimpleGenerator as JaxSimple
from p2igan_tpu.models import STDKGenerator as JaxSTDK
from p2igan_tpu.models import torch_import as TI
from p2igan_tpu.parallel.mesh import create_mesh
from p2igan_tpu.training import checkpoint as jckpt
from p2igan_tpu.training import steps as jsteps
from p2igan_tpu.training.trainer import Trainer as JaxTrainer
from p2igan_tpu_torch.data import fake as tfake
from p2igan_tpu_torch.inference.driver import load_generator, run_inference
from p2igan_tpu_torch.models import (DKGenerator, P2IDiscriminator, P2IGenerator,
                                     SimpleGenerator, STDKGenerator)
from p2igan_tpu_torch.models.convert import module_state_from_jax, params_from_jax
from p2igan_tpu_torch.training import steps as tsteps
from p2igan_tpu_torch.training.checkpoint import (is_jax_checkpoint, load_checkpoint_raw,
                                                  load_generator_state)
from p2igan_tpu_torch.training.trainer import Trainer
from p2igan_tpu_torch.utils import flax_msgpack

from test_torch_inference import _serving_tree

FIXTURES = Path(__file__).parent / "fixtures"
sys.path.insert(0, str(FIXTURES))
import jax_ckpt_writer  # noqa: E402

T, HW, LR = 4, 16, 1e-3


def assert_same_tree(want, got, path=""):
    """flax's tree vs the port decoder's, leaf by leaf, bitwise (bf16 leaves
    are torch tensors on the port's side)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for key in want:
            assert_same_tree(want[key], got[key], f"{path}/{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(got, torch.Tensor):
        want = np.asarray(want)
        assert want.dtype.name == "bfloat16" and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              want.view(np.uint16)), path
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_decoder_is_flax_on_every_leaf_type(monkeypatch):
    tree = {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
            "bf16": jnp.asarray([[1.5, -2.0, 3.25]], jnp.bfloat16),
            "ints": {"i8": np.arange(-3, 3, dtype=np.int8), "u16": np.uint16(7),
                     "i64": np.int64(-2 ** 40), "count": jnp.asarray(3, jnp.int32)},
            "scalars": {"f": np.float32(2.5), "bf": jnp.asarray(0.75, jnp.bfloat16),
                        "py": 0.1, "big": 70000, "neg": -70000, "small": -3},
            "complex": complex(1.0, -2.5), "none": None, "flag": True, "text": "hé",
            "bytes": b"\x00\x01", "empty": {}, "tuple": (np.zeros(0, np.float64), 4)}
    data = ser.to_bytes(tree)
    assert_same_tree(ser.msgpack_restore(data), flax_msgpack.msgpack_restore(data))
    # leaves over flax's chunk size are split, and joined again
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 24)
    chunked = {"a": np.arange(40, dtype=np.float32).reshape(5, 8),
               "b": {"c": jnp.arange(30, dtype=jnp.bfloat16)}, "d": np.arange(3.0)}
    data = ser.to_bytes(chunked)
    assert flax_msgpack.CHUNKED_KEY.encode() in data
    got = flax_msgpack.msgpack_restore(data)
    assert_same_tree(ser.msgpack_restore(data), got)
    assert got["a"].shape == (5, 8) and got["b"]["c"].shape == (30,)
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(data[:-3])


def test_committed_fixture_decodes_as_flax_does():
    path = FIXTURES / "jax_ckpt" / "latest.ckpt"
    assert path.stat().st_size <= 1 << 20 and is_jax_checkpoint(path)
    data = path.read_bytes()
    raw = flax_msgpack.msgpack_restore(data)
    assert_same_tree(ser.msgpack_restore(data), raw)
    assert (raw["epoch"], raw["global_step"]) == (1, 2)
    assert set(raw) == {"epoch", "global_step", "best_val", "generator", "optimizer_g"}
    assert int(raw["optimizer_g"]["0"]["count"]) == 2
    assert float(np.abs(raw["optimizer_g"]["0"]["nu"]["enc0"]["kernel"]).max()) > 0


def test_fixture_writer_regenerates_the_committed_tree(tmp_path):
    """The JAX trainer, rerun by the writer, gives the committed checkpoint's
    tree: the same keys, shapes, dtypes and counters, and values within
    rtol 1e-5 (two CPU runs of XLA need not sum in one order)."""
    out = jax_ckpt_writer.make_fixture(tmp_path / "jax_ckpt")
    committed = FIXTURES / "jax_ckpt"
    assert (out / "config.json").read_text() == (committed / "config.json").read_text()
    want = load_checkpoint_raw(committed / "latest.ckpt")
    got = load_checkpoint_raw(out / "latest.ckpt")

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert list(a) == list(b), path
            for key in a:
                walk(a[key], b[key], f"{path}/{key}")
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7, err_msg=path)
        else:
            assert a == b, path

    walk(want, got)


# -- resume -----------------------------------------------------------------


def _batch(seed):
    """A batch under one single-gauge stis mask: JAX's jitted step contracts
    the gauge distances into FMAs and may break exact distance ties otherwise
    than its eager arithmetic, which the port follows (ROADMAP queue 3)."""
    rng = np.random.default_rng(seed)
    flat = np.zeros(HW * HW, np.float32)
    flat[HW * HW // 2 + 5] = 1.0
    masks = np.broadcast_to(flat.reshape(1, 1, HW, HW, 1), (2, T, HW, HW, 1)).astype(np.float32)
    frames = rng.random((2, T, HW, HW, 1), dtype=np.float32)
    return frames, frames * masks, masks


GEN_KW = dict(H=HW, W=HW, length=T, num_res=1, base_channels=4 * T, idw_max_points=128,
              idw_factored=True, idw_shared_batch_mask=True)
STEP_KW = dict(gan_loss_type="hinge", adversarial_weight=0.01, k1_alpha=0.05)
# (family, beta1, the checkpoint's optimizer): "adam" is stock optax.adam, which
# carries mu; at beta1 = 0 that is a checkpoint from before the mu-free Adam
RESUME_CASES = {"dk-nomu": ("dk", 0.0, "nomu"), "dk-adam-b1": ("dk", 0.5, "adam"),
                "dk-mu-at-b1-0": ("dk", 0.0, "adam"), "p2igan-gan": ("p2igan", 0.0, "nomu")}


def _o0(jitted, *args):
    """``jitted`` compiled for ``args`` without XLA's backend (LLVM)
    optimisation, as ``tests/test_torch_parallel.py`` does: the same program
    in a fraction of the compile time."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": "0"})


def _jax_models(family):
    if family == "p2igan":
        return JaxGenerator(**GEN_KW), JaxDiscriminator(in_channels=T)
    return JaxDK(length=T, visible_k=7, shared_batch_mask=True), None


def _jax_state(family, opt_g, opt_d):
    jgen, jdisc = _jax_models(family)
    _, masked, masks = _batch(0)
    args = (jax.random.key(0), jnp.asarray(masked), jnp.asarray(masks))
    gvars = dict(_o0(jax.jit(jgen.init), *args)(*args))
    gp = gvars.pop("params")
    dp = dextra = None
    if jdisc is not None:
        args = (jax.random.key(1), jnp.asarray(masked))
        dvars = dict(_o0(jax.jit(jdisc.init), *args)(*args))
        dp = dvars.pop("params")
        dextra = dvars
    return jsteps.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gp, gen_extra=gvars,
                             opt_g=opt_g.init(gp), disc_params=dp, disc_extra=dextra,
                             opt_d=None if opt_d is None else opt_d.init(dp))


def _jax_step(family, opt_g, opt_d):
    jgen, jdisc = _jax_models(family)
    return jsteps.build_train_step(jgen, jdisc, opt_g, opt_d, donate=False,
                                   use_gan=jdisc is not None, **STEP_KW)


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_from_a_jax_checkpoint_matches_the_jax_trainer(tmp_path, case):
    """The JAX side takes two steps and writes the payload its trainer writes;
    both trainers' ``load`` resume from that file (the JAX one through its
    ``_migrate_opt_state``), then each takes one step on the same batch."""
    family, beta1, written = RESUME_CASES[case]
    cfg = {"lr": LR, "beta1": beta1, "beta2": 0.99}
    gan = family == "p2igan"

    def jax_opt(kind):
        return (optax.adam(LR, b1=beta1, b2=0.99, eps=1e-8) if kind == "adam"
                else jsteps.make_optimizer(cfg))

    wopt = jax_opt(written)
    state = _jax_state(family, wopt, wopt if gan else None)
    step = _jax_step(family, wopt, wopt if gan else None)
    step = _o0(step, state, *map(jnp.asarray, _batch(1)))
    for i in (1, 2):
        state, _ = step(state, *map(jnp.asarray, _batch(i)))
    state = jax.device_get(state)
    payload = {"epoch": 1, "global_step": 2, "best_val": 0.25,
               "generator": {"params": state.gen_params, "extra": state.gen_extra},
               "optimizer_g": state.opt_g}
    if gan:
        payload.update(discriminator={"params": state.disc_params,
                                      "extra": state.disc_extra},
                       optimizer_d=state.opt_d)
    path = tmp_path / "latest.ckpt"
    jckpt.save_checkpoint(path, payload)

    # the JAX trainer's resume, onto a template of the current optimizer
    current = "nomu" if beta1 == 0.0 else "adam"
    jopt = jax_opt(current)
    jtrainer = SimpleNamespace(state=_jax_state(family, jopt, jopt if gan else None),
                               best_val=float("inf"),
                               mesh=create_mesh(devices=jax.devices()[:1]))
    JaxTrainer.load(jtrainer, path)
    batch = _batch(3)
    jbatch = tuple(map(jnp.asarray, batch))
    if current != written:  # else the same step (one compilation)
        step = _o0(_jax_step(family, jopt, jopt if gan else None), jtrainer.state, *jbatch)
    jnew, jm = step(jtrainer.state, *jbatch)

    # the port's
    gen = P2IGenerator(**GEN_KW) if gan else DKGenerator(length=T, visible_k=7,
                                                         shared_batch_mask=True)
    disc = P2IDiscriminator(in_channels=T) if gan else None
    port = SimpleNamespace(generator=gen, discriminator=disc,
                           opt_g=tsteps.make_optimizer(cfg, gen.parameters()),
                           opt_d=tsteps.make_optimizer(cfg, disc.parameters()) if gan else None,
                           global_step=0, start_epoch=0, best_val=float("inf"),
                           _broadcast_state=lambda: None)
    Trainer.load(port, path)
    assert (port.global_step, port.start_epoch, port.best_val) == (2, 1, 0.25)
    modules = [(gen, port.opt_g, "generator", "optimizer_g")]
    if gan:
        modules.append((disc, port.opt_d, "discriminator", "optimizer_d"))
    for module, opt, key, opt_key in modules:
        want = module_state_from_jax(module, payload[key])
        assert all(torch.equal(v, want[k]) for k, v in module.state_dict().items()), key
        adam = payload[opt_key][0]
        nu = params_from_jax(module, adam.nu)
        mu = params_from_jax(module, adam.mu) if beta1 else None
        for name, p in module.named_parameters():
            st = opt.state[p]
            assert int(st["step"]) == 2
            moment = st["nu"] if beta1 == 0.0 else st["exp_avg_sq"]
            assert torch.equal(moment, nu[name]), name
            if mu is not None:
                assert torch.equal(st["exp_avg"], mu[name]), name
            assert ("nu" in st) == (beta1 == 0.0)
    if gan:
        assert torch.equal(disc.d3d[0].weight_u, torch.from_numpy(
            np.array(state.disc_extra["spectral"]["d3d_0"]["u"])))

    tstep = tsteps.build_train_step(gen, disc, port.opt_g, port.opt_d, use_gan=gan,
                                    **STEP_KW)
    m = tstep(*map(torch.from_numpy, batch))
    np.testing.assert_allclose(float(m["rec_loss"]), float(jm["rec_loss"]), rtol=1e-4)
    for module, jparams in ((gen, jnew.gen_params), (disc, jnew.disc_params)):
        if module is None:
            continue
        want = params_from_jax(module, jparams)
        for name, p in module.named_parameters():
            if p.grad is None:  # alpha3d: unused
                continue
            g = p.grad.numpy()
            sure = np.abs(g) > 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(p.detach().numpy()[sure], want[name].numpy()[sure],
                                       rtol=0, atol=1e-2 * LR, err_msg=name)


def test_resume_refuses_a_jax_state_the_optimizer_cannot_take(tmp_path):
    """torch.optim.Adam (beta1 != 0) needs mu: a mu-free JAX state raises."""
    jopt = jsteps.make_optimizer({"lr": LR, "beta1": 0.0})
    state = jax.device_get(_jax_state("dk", jopt, None))
    path = tmp_path / "latest.ckpt"
    jckpt.save_checkpoint(path, {"epoch": 1, "global_step": 0, "generator": {
        "params": state.gen_params, "extra": {}}, "optimizer_g": state.opt_g})
    gen = DKGenerator(length=T, visible_k=7, shared_batch_mask=True)
    port = SimpleNamespace(generator=gen, discriminator=None, opt_d=None,
                           opt_g=tsteps.make_optimizer({"beta1": 0.5}, gen.parameters()),
                           global_step=0, start_epoch=0, best_val=float("inf"),
                           _broadcast_state=lambda: None)
    with pytest.raises(ValueError, match="first moment mu"):
        Trainer.load(port, path)


# -- serving ------------------------------------------------------------------


def test_run_inference_from_a_jax_checkpoint_matches_the_jax_driver(tmp_path):
    """Both drivers serve the same JAX trainer checkpoint (the generator's
    variables from the port's seeded weights) on single-gauge masks."""
    cfg = _serving_tree(tmp_path)
    state = {k: v.numpy() for k, v in torch.load(tmp_path / "gen.pt").items()}
    variables = TI.import_p2igan_generator(state)
    jckpt.save_checkpoint(tmp_path / "latest.ckpt", {
        "epoch": 3, "global_step": 30, "generator": {"params": variables["params"],
                                                     "extra": {}}})
    kw = dict(checkpoint=str(tmp_path / "latest.ckpt"), stride=T, overlap=2,
              window_batch=2, overwrite=True)
    out = run_inference(json.loads(json.dumps(cfg)), device="cpu",
                        output=str(tmp_path / "port.zarr"), **kw)
    ref = jdriver.run_inference(json.loads(json.dumps(cfg)),
                                output=str(tmp_path / "jax.zarr"), **kw)
    g, r = zarrlite.open(out, mode="r"), zarrlite.open(ref, mode="r")
    assert g.array_keys() == r.array_keys() == ["event_01", "event_02"]
    for key in g.array_keys():
        assert float(g[key][:].max()) > 1.0
        np.testing.assert_allclose(g[key][:], r[key][:], atol=1e-4 * 255.0, rtol=0)


@pytest.mark.parametrize("family", ["dk", "stdk", "simple"])
def test_every_family_serves_from_a_jax_checkpoint(tmp_path, family):
    """``load_generator`` on a JAX trainer checkpoint of each other family
    (p2igan: the driver test above) gives the JAX generator's forward; simple
    carries its BatchNorm statistics under ``extra``."""
    rng = np.random.default_rng(6)
    masks = np.zeros((2, T, HW * HW, 1), np.float32)
    masks[:, :, rng.choice(HW * HW, 9, replace=False)] = 1.0
    masks = masks.reshape(2, T, HW, HW, 1)
    masked = rng.random(masks.shape, dtype=np.float32) * masks
    if family == "simple":
        jgen = JaxSimple(base_channels=4)
        model = {"name": "simple", "in_channels": 1, "base_channels": 4}
    else:
        jgen = {"dk": JaxDK, "stdk": JaxSTDK}[family](length=T, shared_batch_mask=True)
        model = {"name": family, "in_channels": 1}
    args = (jax.random.key(2), jnp.asarray(masked), jnp.asarray(masks))
    variables = dict(_o0(jax.jit(jgen.init), *args)(*args))
    params = jax.tree.map(lambda v: np.asarray(v) + rng.normal(size=v.shape).astype(
        np.float32) * 0.05, variables.pop("params"))  # biases and BN away from init
    if family == "simple":
        variables = {"batch_stats": jax.tree.map(
            lambda v: np.abs(np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)),
            variables["batch_stats"])}
    want = np.asarray(jgen.apply({"params": params, **variables}, jnp.asarray(masked),
                                 jnp.asarray(masks)))
    path = tmp_path / "best.ckpt"
    jckpt.save_checkpoint(path, {"epoch": 1, "global_step": 5, "generator": {
        "params": params, "extra": variables}})
    cfg = {"model": model, "data": {"train": {"sample_length": T, "h": HW, "w": HW,
                                              "mask": {"type": "stis"}}}}
    gen = load_generator(cfg, path, torch.device("cpu"))
    with torch.no_grad():
        got = gen(torch.from_numpy(masked), torch.from_numpy(masks)).numpy()
    if family == "simple":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    klass = {"dk": DKGenerator, "stdk": STDKGenerator, "simple": SimpleGenerator}[family]
    assert isinstance(gen, klass)
    # bare generator variables (no trainer payload) load too, as in the JAX package
    bare = tmp_path / "bare.ckpt"
    bare.write_bytes(ser.to_bytes({"params": params, **variables}))
    state = load_generator_state(bare, gen)
    assert all(torch.equal(state[k], v) for k, v in
               load_generator_state(path, gen).items())


# -- the committed fixture, in the port alone ---------------------------------


def test_fixture_serves_and_resumes_in_the_port(tmp_path):
    """What the card does with the fixture (``chip_smoke.py``), at the
    fixture's full frame on the CPU: serve its event from the JAX checkpoint,
    bitwise the store served from the torch checkpoint the port writes after
    loading it; resume two rec-loss steps (the restored counters and nu are
    the checkpoint's)."""
    cfg = json.loads((FIXTURES / "jax_ckpt" / "config.json").read_text()
                     .replace("<root>", str(tmp_path)))
    tfake.write_train_zarr(tmp_path / "train.zarr", n_events=1, T=19, H=128, W=128,
                           window=16, stride=1, seed=0)
    tfake.write_test_zarr(tmp_path / "test.zarr", n_events=1, T=64, H=128, W=128, seed=2)
    tfake.write_gauge_mask(tmp_path / "gauges.txt", H=128, W=128, n_gauges=79, seed=1)
    ckpt = FIXTURES / "jax_ckpt" / "latest.ckpt"
    gen = load_generator(cfg, ckpt, torch.device("cpu"), fold_weights=False)
    torch.save(gen.state_dict(), tmp_path / "gen.pt")
    stores = [run_inference(json.loads(json.dumps(cfg)), checkpoint=str(c), device="cpu",
                            output=str(tmp_path / f"{name}.zarr"), window_batch=4)
              for name, c in (("jax", ckpt), ("pt", tmp_path / "gen.pt"))]
    a, b = (zarrlite.open(s, mode="r") for s in stores)
    assert a.array_keys() == ["event_01"]
    assert np.array_equal(a["event_01"][:], b["event_01"][:])
    assert np.isfinite(a["event_01"][:]).all()

    cfg["train"]["iterations"] = 4
    cfg["train"]["max_epochs"] = 2
    trainer = Trainer(cfg, device="cpu")
    trainer.load(ckpt)
    raw = load_checkpoint_raw(ckpt)
    assert (trainer.global_step, trainer.start_epoch) == (2, 1)
    nu = params_from_jax(trainer.generator, raw["optimizer_g"]["0"]["nu"])
    for name, p in trainer.generator.named_parameters():
        assert trainer.opt_g.state[p]["step"] == 2
        assert torch.equal(trainer.opt_g.state[p]["nu"], nu[name]), name
    trainer.train()
    assert trainer.global_step == 4 and np.isfinite(trainer.last_rec_loss)
