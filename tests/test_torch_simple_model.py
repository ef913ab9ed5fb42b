"""SimpleGenerator and SimpleDiscriminator of the PyTorch port vs the JAX
package (CPU, f32): base_channels 8, T=4, 16x16, B=2, inputs from numpy seeds.

Weights cross through ``simple_state_dict_from_jax`` /
``simple_disc_state_dict_from_jax`` with the BatchNorm affine and running
statistics moved away from identity. Tolerances: generator forward atol 1e-5;
running statistics after a train-mode forward rtol 1e-5 (atol 1e-6); folded
serving module rtol 1e-5, atol 1e-5 (the fold reassociates one multiply a
tap); discriminator logits rtol 2e-4 (ROADMAP).
"""

import flax.core
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2igan_tpu.models import SimpleDiscriminator as JaxDiscriminator
from p2igan_tpu.models import SimpleGenerator as JaxGenerator
from p2igan_tpu.models import torch_import as TI
from p2igan_tpu_torch.models import (SimpleDiscriminator, SimpleGenerator,
                                     build_discriminator, build_generator,
                                     build_generator_for_inference)
from p2igan_tpu_torch.models import simple as tsimple
from p2igan_tpu_torch.models.convert import (params_from_jax,
                                             simple_disc_state_dict_from_jax,
                                             simple_state_dict_from_jax)

B, T, HW, BASE = 2, 4, 16, 8
GEN_KEYS = ([f"encoder.{i}.{j}" for i in range(3)
             for j in ("0.weight", "0.bias", "1.weight", "1.bias", "1.running_mean",
                       "1.running_var")]
            + [f"decoder.{i}.{p}" for i in (0, 2, 4) for p in ("weight", "bias")])


def _inputs(seed, c=1):
    rng = np.random.default_rng(seed)
    masks = (rng.random((B, T, HW, HW, c)) < 0.3).astype(np.float32)
    frames = rng.random((B, T, HW, HW, c), dtype=np.float32)
    return frames, frames * masks, masks


def _randomize(variables, seed):
    """Biases, BatchNorm affine and running statistics away from their
    identity init, so that nothing is multiplied by one or added to zero."""
    rng = np.random.default_rng(seed)
    variables = flax.core.unfreeze(jax.tree.map(np.asarray, variables))

    def normal(ref, scale):
        return (rng.standard_normal(ref.shape) * scale).astype(np.float32)

    for name, node in variables["params"].items():
        if isinstance(node, dict):
            node["bias"] = normal(node["bias"], 0.1)
            node["bn"]["scale"] = 1.0 + normal(node["bn"]["scale"], 0.3)
            node["bn"]["bias"] = normal(node["bn"]["bias"], 0.2)
            stats = variables["batch_stats"][name]["bn"]
            stats["mean"] = normal(stats["mean"], 0.1)
            stats["var"] = np.exp(normal(stats["var"], 0.5))
        elif name.endswith("bias"):
            variables["params"][name] = normal(node, 0.1)
    return variables


def jax_generator(seed=0, in_channels=1, base=BASE):
    _, masked, masks = _inputs(1, in_channels)
    jgen = JaxGenerator(in_channels=in_channels, out_channels=in_channels,
                        base_channels=base)
    variables = jgen.init(jax.random.key(seed), jnp.asarray(masked), jnp.asarray(masks))
    return jgen, _randomize(variables, seed + 50)


def port_generator(variables, in_channels=1, base=BASE, **kw):
    gen = SimpleGenerator(in_channels=in_channels, out_channels=in_channels,
                          base_channels=base, **kw)
    gen.load_state_dict(simple_state_dict_from_jax(variables))
    return gen


def jax_discriminator(seed=0):
    frames, _, _ = _inputs(2)
    jdisc = JaxDiscriminator(base_channels=BASE)
    variables = jdisc.init(jax.random.key(seed), jnp.asarray(frames))
    return jdisc, _randomize(variables, seed + 60)


def port_discriminator(variables):
    disc = SimpleDiscriminator(base_channels=BASE)
    disc.load_state_dict(simple_disc_state_dict_from_jax(variables))
    return disc


def _assert_stats(blocks, jax_stats, names, mean_atol=1e-6):
    for block, name in zip(blocks, names):
        want = jax_stats[name]["bn"]
        np.testing.assert_allclose(block[1].running_mean.numpy(), np.asarray(want["mean"]),
                                   rtol=1e-5, atol=mean_atol, err_msg=name)
        np.testing.assert_allclose(block[1].running_var.numpy(), np.asarray(want["var"]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("in_channels", [1, 2])
def test_eval_forward_matches_jax(in_channels):
    jgen, variables = jax_generator(in_channels=in_channels)
    _, masked, masks = _inputs(3, in_channels)
    want = np.asarray(jgen.apply(variables, jnp.asarray(masked), jnp.asarray(masks)))
    gen = port_generator(variables, in_channels).eval()
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    with torch.no_grad():
        got = gen(torch.from_numpy(masked), torch.from_numpy(masks))
    assert got.shape == (B, T, HW, HW, in_channels) and got.dtype == torch.float32
    assert 0.0 < float(got.min()) and float(got.max()) < 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for k, v in gen.state_dict().items():   # eval leaves the running statistics
        assert torch.equal(v, before[k]), k


def test_train_forward_and_running_statistics_match_jax():
    """Batch statistics in the forward, and flax's update of the running ones:
    momentum 0.9 on the old value, the BIASED batch variance (torch's own
    BatchNorm3d would store the unbiased one, 0.05-0.4% off at these sizes)."""
    jgen, variables = jax_generator()
    _, masked, masks = _inputs(4)
    want, upd = jgen.apply(variables, jnp.asarray(masked), jnp.asarray(masks),
                           train=True, mutable=["batch_stats"])
    gen = port_generator(variables).train()
    got = gen(torch.from_numpy(masked), torch.from_numpy(masks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    _assert_stats(gen.encoder, upd["batch_stats"], ("enc0", "enc1", "enc2"))
    # and the update did move them, by more than the tolerance
    old = variables["batch_stats"]["enc2"]["bn"]["var"]
    assert np.abs(gen.encoder[2][1].running_var.numpy() / old - 1.0).max() > 1e-2
    # torch's unbiased estimate would have failed the comparison above
    n = B * (T // 4) * (HW // 4) ** 2
    assert n / (n - 1) - 1.0 > 1e-3


@pytest.mark.parametrize("in_channels", [1, 2])
def test_folded_serving_module_matches_unfolded_and_jax(in_channels):
    jgen, variables = jax_generator(in_channels=in_channels)
    _, masked, masks = _inputs(5, in_channels)
    jm, jk = jnp.asarray(masked), jnp.asarray(masks)
    gen = port_generator(variables, in_channels).eval()
    keys = list(gen.state_dict())
    tm, tk = torch.from_numpy(masked), torch.from_numpy(masks)
    with torch.no_grad():
        unfolded = gen(tm, tk).numpy()
    sgen, svars = jgen.fold_for_inference(variables)
    for dec2 in (True, False):
        gen.dec2_fused = dec2
        folded = gen.fold_for_inference()
        assert folded is not gen and folded.serving and not folded.training
        assert not gen.serving and list(gen.state_dict()) == keys
        assert [k for k in folded.state_dict() if "running" in k] == []
        with torch.inference_mode():
            got = folded(tm, tk).numpy()
        assert got.shape == unfolded.shape
        np.testing.assert_allclose(got, unfolded, rtol=1e-5, atol=1e-5)
        want = np.asarray(sgen.clone(dec2_pallas=dec2).apply(svars, jm, jk))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the folded weights equal the JAX fold
    folded_jax = simple_state_dict_from_jax(
        {"params": {k: (dict(v, bn={"scale": np.ones(1), "bias": np.zeros(1)})
                        if isinstance(v, dict) else v)
                    for k, v in jax.tree.map(np.asarray, svars["params"]).items()},
         "batch_stats": {f"enc{i}": {"bn": {"mean": np.zeros(1), "var": np.ones(1)}}
                         for i in range(3)}})
    for i in range(3):
        np.testing.assert_allclose(folded.encoder[i].weight.detach().numpy(),
                                   folded_jax[f"encoder.{i}.0.weight"].numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(folded.encoder[i].bias.detach().numpy(),
                                   folded_jax[f"encoder.{i}.0.bias"].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_folded_module_refuses_a_gradient():
    """Serving goes through the forward-only ops: with grad enabled they
    raise rather than return a prediction that cannot train."""
    gen = SimpleGenerator(base_channels=4, generator=torch.Generator().manual_seed(0))
    _, masked, masks = _inputs(6)
    folded = gen.fold_for_inference()
    with pytest.raises(RuntimeError, match="forward-only"):
        folded(torch.from_numpy(masked), torch.from_numpy(masks))
    assert gen(torch.from_numpy(masked), torch.from_numpy(masks)).requires_grad


@pytest.mark.parametrize("update_stats", [False, True])
def test_discriminator_matches_jax(update_stats):
    """Logits rtol 2e-4 (atol 1e-5 x max|logit|); with ``update_stats`` batch
    statistics normalise and the running ones advance as in JAX, without it
    the running ones normalise and stay."""
    jdisc, variables = jax_discriminator()
    x = np.random.default_rng(7).random((3, T, HW, HW, 1), dtype=np.float32)
    disc = port_discriminator(variables)
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    got = disc(torch.from_numpy(x), update_stats=update_stats).detach().numpy()
    if update_stats:
        want, upd = jdisc.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        _assert_stats(disc.features, upd["batch_stats"], ("f0", "f1", "f2"))
    else:
        want = jdisc.apply(variables, jnp.asarray(x), train=False)
        for k, v in disc.state_dict().items():
            assert torch.equal(v, before[k]), k
    want = np.asarray(want)
    assert got.shape == want.shape == (3, 1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * np.abs(want).max())
    # the mode follows update_stats, not the module's training flag
    disc2 = port_discriminator(variables).eval()
    again = disc2(torch.from_numpy(x), update_stats=update_stats).detach().numpy()
    np.testing.assert_array_equal(again, got)


def test_reference_keys_round_trip_through_the_jax_importer():
    _, variables = jax_generator()
    state = simple_state_dict_from_jax(variables)
    assert list(state) == GEN_KEYS
    gen = SimpleGenerator(base_channels=BASE)
    assert list(gen.state_dict()) == GEN_KEYS
    gen.load_state_dict(state)  # strict
    back = TI.import_simple_generator({k: v.numpy() for k, v in gen.state_dict().items()})
    jax.tree.map(np.testing.assert_array_equal, back, dict(variables))
    # ConvTranspose3d weights are (in, out, k, k, k); the JAX kernel (k, k, k, out, in)
    assert state["decoder.0.weight"].shape == (4 * BASE, 2 * BASE, 2, 2, 2)
    assert variables["params"]["dec0_kernel"].shape == (2, 2, 2, 2 * BASE, 4 * BASE)
    # a reference checkpoint's num_batches_tracked is accepted and ignored
    with_counter = dict(state)
    for i in range(3):
        with_counter[f"encoder.{i}.1.num_batches_tracked"] = torch.tensor(7)
    other = SimpleGenerator(base_channels=BASE)
    other.load_state_dict(with_counter)
    assert list(other.state_dict()) == GEN_KEYS
    for k, v in other.state_dict().items():
        assert torch.equal(v, state[k]), k
    with pytest.raises(RuntimeError, match="bogus"):
        SimpleGenerator(base_channels=BASE).load_state_dict(
            dict(state, **{"encoder.0.1.bogus": torch.zeros(1)}))


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_conversion_is_strict_both_ways(which):
    if which == "generator":
        _, variables = jax_generator()
        convert, module, block = simple_state_dict_from_jax, SimpleGenerator, "enc1"
    else:
        _, variables = jax_discriminator()
        convert, module, block = (simple_disc_state_dict_from_jax, SimpleDiscriminator,
                                  "f1")
    state = convert(variables)
    target = module(base_channels=BASE)
    assert set(state) == set(target.state_dict())
    named = params_from_jax(target, variables["params"])
    assert set(named) == {n for n, _ in target.named_parameters()}
    extra = {"params": dict(variables["params"], stray=np.zeros(1, np.float32)),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="unused"):
        convert(extra)
    stats = {k: {"bn": dict(v["bn"])} for k, v in variables["batch_stats"].items()}
    del stats[block]["bn"]["var"]
    with pytest.raises(KeyError, match=f"{block}/bn/var"):
        convert({"params": variables["params"], "batch_stats": stats})
    stats = {k: {"bn": dict(v["bn"], count=np.zeros(1))}
             for k, v in variables["batch_stats"].items()}
    with pytest.raises(ValueError, match="unused"):
        convert({"params": variables["params"], "batch_stats": stats})


@pytest.mark.parametrize("klass", [SimpleGenerator, SimpleDiscriminator])
def test_seeded_init_is_uniform_in_fan_in_with_zero_biases(klass):
    """U(+-1/sqrt(fan_in)) per layer (the JAX package's ``_torch_conv_init``),
    zero biases, BatchNorm at identity; a function of the generator alone."""
    a = klass(base_channels=16, generator=torch.Generator().manual_seed(3))
    b = klass(base_channels=16, generator=torch.Generator().manual_seed(3))
    c = klass(base_channels=16, generator=torch.Generator().manual_seed(4))
    fan_in = {"encoder.0.0": 54, "encoder.1.0": 27 * 16, "encoder.2.0": 27 * 32,
              "decoder.0": 8 * 32, "decoder.2": 8 * 16, "decoder.4": 27 * 16,
              "features.0.0": 27, "features.1.0": 27 * 16, "features.2.0": 27 * 32,
              "head": 64}
    seen = 0
    for (name, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(p, q), name
        layer, _, kind = name.rpartition(".")
        if layer in fan_in and kind == "weight":
            seen += 1
            bound = 1.0 / np.sqrt(fan_in[layer])
            assert not torch.equal(p, r), name
            assert float(p.abs().max()) <= bound, name
            if p.numel() >= 4000:   # a uniform's std is bound / sqrt(3)
                assert abs(float(p.std()) * np.sqrt(3) / bound - 1.0) < 0.05, name
        elif kind in ("bias", "running_mean"):
            assert float(p.abs().max()) == 0.0, name
        else:
            assert torch.equal(p, torch.ones_like(p)), name
    assert seen == (6 if klass is SimpleGenerator else 4)


def test_registry_builds_the_simple_family():
    cfg = {"model": {"name": "simple", "in_channels": 1, "base_channels": BASE}}
    for build in (build_generator, build_generator_for_inference):
        gen = build(cfg, generator=torch.Generator().manual_seed(0))
        assert type(gen) is SimpleGenerator and gen.base_channels == BASE
        assert gen.in_channels == gen.out_channels == 1 and gen.dec2_fused is None
        assert not gen.serving and not hasattr(gen, "prepare_idw")
    disc = build_discriminator(cfg, generator=torch.Generator().manual_seed(1))
    assert type(disc) is SimpleDiscriminator and disc.head.in_features == 4 * BASE
    cfg["model"].update(in_channels=2, out_channels=3, dec2_fused=False)
    gen = build_generator(cfg)
    assert (gen.in_channels, gen.out_channels, gen.dec2_fused) == (2, 3, False)
    assert gen.encoder[0][0].in_channels == 4 and gen.decoder[4].out_channels == 3
    assert build_discriminator(cfg).features[0][0].in_channels == 2
    assert isinstance(tsimple.DEC2_FUSED_DEFAULT, bool)
    # every family but p2igan pairs with the simple critic, as in the JAX registry
    for name in ("dk", "stdk", "anything"):
        assert type(build_discriminator({"model": {"name": name, "base_channels": 4}})) \
            is SimpleDiscriminator
    p2i = {"model": {"name": "p2igan"}, "data": {"train": {"sample_length": 4}}}
    assert type(build_discriminator(p2i)).__name__ == "P2IDiscriminator"


def test_more_output_channels_take_the_unfused_last_layer():
    """The fused dec2 is for one output channel; others go through F.conv3d in
    the folded module too, with the same values as the unfolded one."""
    gen = SimpleGenerator(in_channels=1, out_channels=2, base_channels=4,
                          generator=torch.Generator().manual_seed(2)).eval()
    _, masked, masks = _inputs(8)
    with torch.no_grad():
        want = gen(torch.from_numpy(masked), torch.from_numpy(masks))
        got = gen.fold_for_inference()(torch.from_numpy(masked), torch.from_numpy(masks))
    assert got.shape == (B, T, HW, HW, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
