"""DKGenerator and STDKGenerator of the PyTorch port vs the JAX package (CPU).

32x32, T=4, visible_k=7, B=2; inputs from numpy seeds; the JAX weights cross
through ``dk_state_dict_from_jax``. Forward tolerance atol 1e-4 against the
JAX scan formulation (fused_tail off) and against its fused-tail branch
(fused_tail on; on the CPU that is the plain ``mlp_tail_reference``, as the
JAX package's own CPU tests run it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2igan_tpu.models import DKGenerator as JaxDK
from p2igan_tpu.models import STDKGenerator as JaxSTDK
from p2igan_tpu.models import torch_import as TI
from p2igan_tpu_torch.config import load_config
from p2igan_tpu_torch.models import (DKGenerator, SimpleDiscriminator, SimpleGenerator,
                                     STDKGenerator, build_discriminator,
                                     build_generator, build_generator_for_inference)
from p2igan_tpu_torch.models import stdk as tstdk
from p2igan_tpu_torch.models.convert import (dk_state_dict_from_jax, params_from_jax,
                                             remap_dk_visible_columns)
from p2igan_tpu_torch.ops.wendland import time_basis_count

B, T, HW, K = 2, 4, 32, 7
FAMILIES = {"dk": (JaxDK, DKGenerator), "stdk": (JaxSTDK, STDKGenerator)}
KEYS = [f"_mlp.net.{i}.{p}" for i in (0, 2, 4, 6) for p in ("weight", "bias")]
CONFIGS = "p2igan_tpu_torch/config"


def _inputs(seed, shared=True, c=1):
    rng = np.random.default_rng(seed)
    masks = np.zeros((B, T, HW * HW, c), np.float32)
    if shared:
        masks[:, :, rng.choice(HW * HW, K, replace=False)] = 1.0
    else:
        for b in range(B):
            for t in range(T):
                masks[b, t, rng.choice(HW * HW, K, replace=False)] = 1.0
    masks = masks.reshape(B, T, HW, HW, c)
    return rng.random((B, T, HW, HW, c), dtype=np.float32) * masks, masks


def _jax_model(family, shared, fused_tail=False, seed=0):
    """A JAX generator with non-zero biases (its init zeroes them)."""
    masked, masks = _inputs(1, shared)
    jgen = FAMILIES[family][0](length=T, visible_k=K, shared_batch_mask=shared,
                               fused_tail=fused_tail)
    variables = jgen.init(jax.random.key(seed), jnp.asarray(masked), jnp.asarray(masks))
    rng = np.random.default_rng(seed + 50)
    mlp = {k: np.asarray(v) for k, v in variables["params"]["mlp"].items()}
    for name in ("b1", "b2", "b3", "b4"):
        mlp[name] = rng.normal(size=mlp[name].shape).astype(np.float32) * 0.1
    return jgen, {"params": {"mlp": mlp}}


def _port_model(family, variables, shared, **kw):
    gen = FAMILIES[family][1](length=T, visible_k=K, shared_batch_mask=shared, **kw)
    gen.load_state_dict(dk_state_dict_from_jax(variables))
    return gen


@pytest.mark.parametrize("jax_fused", [False, True])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_forward_matches_jax(family, shared, jax_fused):
    jgen, variables = _jax_model(family, shared, fused_tail=jax_fused)
    masked, masks = _inputs(2, shared)
    want = np.asarray(jgen.apply(variables, jnp.asarray(masked), jnp.asarray(masks)))
    for fused_tail in (None, False):
        gen = _port_model(family, variables, shared, fused_tail=fused_tail)
        with torch.no_grad():
            got = gen(torch.from_numpy(masked), torch.from_numpy(masks))
        assert got.shape == (B, T, HW, HW, 1) and got.dtype == torch.float32
        assert np.abs(want).max() > 0.1  # not a degenerate output
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_state_dict_keys_and_round_trip(family):
    _, variables = _jax_model(family, True)
    gen = _port_model(family, variables, True)
    assert list(gen.state_dict()) == KEYS
    feat = 139 + K if family == "dk" else 139 + time_basis_count(T) + T * K
    assert gen.state_dict()["_mlp.net.0.weight"].shape == (100, feat)
    assert gen.state_dict()["_mlp.net.6.weight"].shape == (1, 100)
    back = TI.import_dk_generator({k: v.numpy() for k, v in gen.state_dict().items()})
    jax.tree.map(np.testing.assert_array_equal, back, variables)
    # strict both ways: an extra flax leaf raises, a missing one too
    extra = {"params": {"mlp": dict(variables["params"]["mlp"], fc5=np.zeros(1))}}
    with pytest.raises(ValueError, match="unused"):
        dk_state_dict_from_jax(extra)
    missing = {"params": {"mlp": {k: v for k, v in variables["params"]["mlp"].items()
                                  if k != "b3"}}}
    with pytest.raises(KeyError, match="mlp/b3"):
        dk_state_dict_from_jax(missing)
    named = params_from_jax(gen, variables["params"])
    assert set(named) == {n for n, _ in gen.named_parameters()}


def test_full_width_feature_dims():
    assert DKGenerator().state_dict()["_mlp.net.0.weight"].shape == (100, 139 + 79)
    assert STDKGenerator().state_dict()["_mlp.net.0.weight"].shape == (100, 1447)
    assert tstdk.InpaintGenerator is STDKGenerator


@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_init_is_kaiming_normal_with_zero_biases(family):
    """std sqrt(2 / fan_in) per layer, biases zero, and the draw is a function
    of the explicit generator alone."""
    klass = FAMILIES[family][1]
    a = klass(generator=torch.Generator().manual_seed(3))
    b = klass(generator=torch.Generator().manual_seed(3))
    c = klass(generator=torch.Generator().manual_seed(4))
    for (name, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert float(p.abs().max()) == 0.0
        else:
            assert not torch.equal(p, r), name
            if p.numel() >= 10000:
                want = np.sqrt(2.0 / p.shape[1])
                assert abs(float(p.std()) / want - 1.0) < 0.05, name


@pytest.mark.parametrize("family,t_blocks,n_time", [("dk", 1, 0), ("stdk", T, None)])
def test_remap_visible_columns_equals_jax(family, t_blocks, n_time):
    _, variables = _jax_model(family, True)
    if n_time is None:
        n_time = time_basis_count(T)
    order = np.random.default_rng(5).permutation(50)[:K]
    want = TI.remap_dk_visible_columns(variables, order, 139, n_time, t_blocks)
    got = remap_dk_visible_columns(dk_state_dict_from_jax(variables), order, 139,
                                   n_time, t_blocks)
    for key, val in dk_state_dict_from_jax(want).items():
        np.testing.assert_array_equal(got[key].numpy(), val.numpy(), err_msg=key)
    with pytest.raises(ValueError, match="layout mismatch"):
        remap_dk_visible_columns(dk_state_dict_from_jax(variables), order, 138,
                                 n_time, t_blocks)


@pytest.mark.parametrize("name,klass,feat", [("dk_gauge", DKGenerator, 218),
                                             ("stdk_gauge", STDKGenerator, 1447),
                                             ("dk", DKGenerator, 218),
                                             ("stdk", STDKGenerator, 1447)])
def test_registry_builds_the_shipped_configs(name, klass, feat):
    cfg = load_config(f"{CONFIGS}/{name}.json")
    for build in (build_generator, build_generator_for_inference):
        gen = build(cfg, generator=torch.Generator().manual_seed(0))
        assert type(gen) is klass and gen.length == 16 and gen.visible_k == 79
        assert gen.shared_batch_mask  # stis masks
        assert gen._mlp.feature_dim == feat
    # under use_gan dk and stdk train against the simple critic, as in JAX
    disc = build_discriminator(cfg, generator=torch.Generator().manual_seed(1))
    assert isinstance(disc, SimpleDiscriminator)
    assert disc.head.in_features == 4 * cfg["model"]["base_channels"]


def test_registry_follows_the_jax_rules():
    """Test sample_length falls back to train, then 16; shared_batch_mask
    follows the mask the serving data uses; simple, and any unknown name,
    build the simple family."""
    base = {"model": {"name": "dk", "in_channels": 1},
            "data": {"train": {"sample_length": 4,
                               "mask": {"type": "stis", "file": "m.txt"}}}}
    assert build_generator(base).length == 4 and build_generator(base).shared_batch_mask
    assert build_generator_for_inference(base).length == 4
    base["data"]["test"] = {"sample_length": 8}
    assert build_generator_for_inference(base).length == 8
    base["data"]["train"]["mask"] = {"type": "sti", "block_sizes": [8]}
    assert not build_generator(base).shared_batch_mask
    base["data"]["test"] = {"mask": {"type": "stis", "file": "m.txt"}}
    assert build_generator_for_inference(base).shared_batch_mask
    base["data"]["test"] = {"mask": None}
    assert not build_generator_for_inference(base).shared_batch_mask
    del base["data"]["train"]["sample_length"]
    assert build_generator_for_inference(base).length == 16
    base["model"]["name"] = "stdk"
    assert isinstance(build_generator_for_inference(base), STDKGenerator)
    base["model"].update(name="simple", base_channels=4)
    assert isinstance(build_generator(base), SimpleGenerator)
    del base["model"]["name"]
    assert isinstance(build_generator_for_inference(base), SimpleGenerator)


@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_wrong_shapes_raise(family):
    gen = FAMILIES[family][1](length=T, visible_k=K)
    masked, masks = _inputs(6, c=2)
    with pytest.raises(ValueError, match="single-channel"):
        gen(torch.from_numpy(masked), torch.from_numpy(masks))
    masked, masks = _inputs(6)
    with pytest.raises(ValueError, match=f"T == {T}"):
        gen(torch.from_numpy(masked[:, :3]), torch.from_numpy(masks[:, :3]))


@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_fold_for_inference_switches_the_tail_on_and_keeps_the_weights(family):
    gen = FAMILIES[family][1](length=T, visible_k=K, fused_tail=False,
                              generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    masked, masks = (torch.from_numpy(a) for a in _inputs(7))
    with torch.no_grad():
        want = gen(masked, masks)
        folded = gen.fold_for_inference()
        got = folded(masked, masks)
    assert folded.fused_tail is True
    for k, v in folded.state_dict().items():
        assert torch.equal(v, before[k]), k
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_training_after_serving_in_one_process(family):
    """The cached bases are first built by a serving call under
    torch.inference_mode (at a size no other test uses); a training step
    afterwards must still build its graph through them."""
    from p2igan_tpu_torch.inference.driver import SlidingWindowReconstructor

    hw = 24
    rng = np.random.default_rng(9)
    masks = np.zeros((T, hw * hw, 1), np.float32)
    masks[:, rng.choice(hw * hw, K, replace=False)] = 1.0
    masks = masks.reshape(T, hw, hw, 1)
    masked = rng.random((T, hw, hw, 1), dtype=np.float32) * masks
    gen = FAMILIES[family][1](length=T, visible_k=K, shared_batch_mask=True,
                              generator=torch.Generator().manual_seed(5))
    out = SlidingWindowReconstructor(gen, stride=T, overlap=2, window_batch=2)(
        masked, masks)
    assert np.isfinite(out).all()
    preds = gen(torch.from_numpy(masked[None]), torch.from_numpy(masks[None]))
    preds.sum().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in gen.parameters())


@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_split_first_layer_equals_naive_concat(family):
    """The algebraic first-layer split against the reference formulation: the
    full feature rows ``[phi_s | (phi_t) | z]`` through the whole MLP
    (``DKMLP.forward``), pixel by pixel; atol 1e-5."""
    from p2igan_tpu_torch.ops.wendland import build_phi_space, build_phi_time

    gen = FAMILIES[family][1](length=T, visible_k=K, shared_batch_mask=True,
                              generator=torch.Generator().manual_seed(6))
    masked, masks = (torch.from_numpy(a) for a in _inputs(8))
    hw = HW * HW
    idx = torch.nonzero(masks[0, 0, :, :, 0].reshape(-1))[:, 0]
    z = masked[..., 0].reshape(B, T, hw)[:, :, idx]                  # (B, T, K)
    phi_s = torch.from_numpy(build_phi_space(HW, HW))
    phi_t = torch.from_numpy(build_phi_time(T))
    want = torch.empty(B, T, hw)
    with torch.no_grad():
        for b in range(B):
            for t in range(T):
                if family == "dk":
                    feats = torch.cat([phi_s, z[b, t].expand(hw, K)], dim=1)
                else:
                    feats = torch.cat([phi_s, phi_t[t].expand(hw, -1),
                                       z[b].reshape(-1).expand(hw, T * K)], dim=1)
                want[b, t] = gen._mlp(feats)[:, 0]
        got = gen(masked, masks)
    np.testing.assert_allclose(got.numpy().reshape(B, T, hw), want.numpy(),
                               rtol=0, atol=1e-5)
