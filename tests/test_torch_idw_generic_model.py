"""PyTorch port vs the JAX package: p2igan on masks that vary per frame
(stin, fi, nowcasting), through the generic IDW.

The same weights and numpy inputs go through both. The JAX side runs op by op
under ``jax.disable_jit()`` on its plain (XLA) IDW: jitted, XLA contracts the
distance sums into FMAs, and frames held fully observed put the observed
points on the query lattice, where every unobserved frame sees exact +-z ties.
Every sample here has at least k valid points, where the XLA path's inf for
invalid slots and the port's 1e30 penalty agree. The JAX IDW pads the queries
to its 16384-query chunk; ``small_jax_idw_chunk`` runs it in chunks of 1024
(a memory tiling: every query's result is its own), which keeps the eager CPU
run short and changes no number. Tolerances: the InputBlock
forward atol 1e-5 and its parameter gradients 1e-4 x max|gradient| (those of
``tests/test_torch_sti_ops.py``); the generator atol 1e-4, as on stis and sti.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2igan_tpu.models import P2IGenerator as JaxGenerator
from p2igan_tpu.models import torch_import as TI
from p2igan_tpu.ops import idw as jidw
from p2igan_tpu.ops import layers as jlayers
from p2igan_tpu_torch.data.masks import create_mask_np
from p2igan_tpu_torch.models import P2IGenerator
from p2igan_tpu_torch.models.p2igan import _mask_points_budget
from p2igan_tpu_torch.ops.layers import InputBlock

from test_torch_model import reference_state, torch_state
from test_torch_sti_model import _cfg

@pytest.fixture
def small_jax_idw_chunk(monkeypatch):
    """The JAX package's XLA ``idw_3d_knn`` in query chunks of 1024."""
    knn = jidw.idw_3d_knn
    monkeypatch.setattr(jidw, "idw_3d_knn", lambda *a, chunk=None, **kw: knn(
        *a, chunk=1024, **kw))


pytestmark = pytest.mark.usefixtures("small_jax_idw_chunk")

MASKS = {"stin": dict(block_sizes=[4], keep=2), "fi": dict(interval=[2]),
         "nowcasting": dict(keep=2)}


def per_frame_masks(kind, B, T, hw, seed=0, **over):
    rng = np.random.default_rng(seed)
    return np.stack([create_mask_np((T, hw, hw, 1), rng, kind, **{**MASKS[kind], **over})
                     for _ in range(B)])


def _budget(kind, T, hw, **over):
    n = _mask_points_budget({"type": kind, **MASKS[kind], **over}, hw, hw, T)
    return -(-n // 128) * 128


@pytest.mark.parametrize("kind,over", [("stin", {"keep": 4}), ("fi", {}),
                                       ("nowcasting", {})])
def test_input_block_generic_matches_jax(kind, over):
    """InputBlock(factored=False) at T=5, 32x32, batch 2: attention on every
    pixel, extract_points over the full per-frame mask, the generic IDW.
    stin's budget (4 dense frames + 81 points = 4177 -> 4224) exceeds 4096,
    so it runs the chunked path forward and its scatter backward; fi (2 dense
    frames, 2048) and nowcasting (2, 2048) the single pass and the plain
    version of kernel #10."""
    T, hw, B = 5, 32, 2
    masks = per_frame_masks(kind, B, T, hw, **over)[..., 0]       # (B, T, H, W)
    assert not np.array_equal(masks[:, 0], masks[:, -1])          # varies per frame
    max_points = _budget(kind, T, hw, **over)
    assert (max_points > 4096) == (kind == "stin")
    assert int(masks.reshape(B, -1).sum(1).max()) <= max_points
    rng = np.random.default_rng(1)
    x = (rng.random((B, T, hw, hw)).astype(np.float32) * masks)
    cot = rng.normal(size=(B, T, hw, hw)).astype(np.float32)
    x_j, m_j = (jnp.asarray(np.transpose(a, (0, 2, 3, 1))) for a in (x, masks))

    jblock = jlayers.InputBlock(factored=False, max_points=max_points, use_pallas=False)
    params = jax.tree.map(np.asarray, jblock.init(jax.random.key(0), x_j, m_j)["params"])
    for att in params.values():  # zero biases would leave the bias path untested
        att["bias"] = rng.normal(0, 0.1, att["bias"].shape).astype(np.float32)
    cot_j = jnp.asarray(np.transpose(cot, (0, 2, 3, 1)))
    with jax.disable_jit():
        want, vjp = jax.vjp(lambda p: jblock.apply({"params": p}, x_j, m_j), params)
        (jgrads,) = vjp(cot_j)
    want = np.asarray(want)

    block = InputBlock(T, max_points=max_points, factored=False)
    with torch.no_grad():
        for i, layer in enumerate(block.layers):
            layer.conv.weight.copy_(torch.from_numpy(
                np.transpose(params[f"att{i}"]["kernel"], (2, 1, 0)).copy()))
            layer.conv.bias.copy_(torch.from_numpy(params[f"att{i}"]["bias"]))
    out = block(torch.from_numpy(x), torch.from_numpy(masks))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)
    out.backward(torch.from_numpy(cot))
    for i, layer in enumerate(block.layers):
        for got, w in ((layer.conv.weight.grad.numpy(),
                        np.transpose(np.asarray(jgrads[f"att{i}"]["kernel"]), (2, 1, 0))),
                       (layer.conv.bias.grad.numpy(), np.asarray(jgrads[f"att{i}"]["bias"]))):
            assert np.abs(w).max() > 0
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_constructor_defaults_match_the_jax_class():
    """The port's P2IGenerator and InputBlock default to the JAX classes' IDW
    settings (the generic IDW): built with the same arguments, both run the
    same path."""
    tsig = inspect.signature(P2IGenerator.__init__).parameters
    for name in ("idw_factored", "idw_shared_batch_mask", "idw_max_points", "idw_k"):
        assert tsig[name].default == getattr(JaxGenerator, name), name
    bsig = inspect.signature(InputBlock.__init__).parameters
    for name in ("factored", "shared_batch_mask", "max_points", "k", "rho", "tau"):
        assert bsig[name].default == getattr(jlayers.InputBlock, name), name


@pytest.mark.parametrize("kind", ["stin", "fi", "nowcasting"])
def test_generator_matches_jax_on_per_frame_masks(kind):
    """Both classes built with the same arguments and no IDW flags (the
    defaults: the generic IDW), unfolded and folded, T=4, 16x16, base 16,
    batch 2, every sample under its own per-frame mask."""
    T, hw = 4, 16
    kw = dict(H=hw, W=hw, length=T, num_res=1, base_channels=16,
              idw_max_points=_budget(kind, T, hw))
    jgen, gen = JaxGenerator(**kw), P2IGenerator(**kw)
    assert (gen.idw_factored, gen.idw_shared_batch_mask) == (
        jgen.idw_factored, jgen.idw_shared_batch_mask) == (False, False)
    assert not gen.input.factored
    sd = reference_state(seed=4, t=T, base=16, h=hw, w=hw, num_res=1)
    variables = TI.import_p2igan_generator(sd, num_res=1)
    gen.load_state_dict(torch_state(sd))
    masks = per_frame_masks(kind, 2, T, hw, seed=5)
    masked = np.random.default_rng(6).random(masks.shape).astype(np.float32) * masks
    egen, evars = jgen.fold_for_inference(variables)
    with jax.disable_jit():
        want = np.asarray(jgen.apply(variables, jnp.asarray(masked), jnp.asarray(masks)))
        want_f = np.asarray(egen.apply(evars, jnp.asarray(masked), jnp.asarray(masks)))
    m, k = torch.from_numpy(masked), torch.from_numpy(masks)
    with torch.no_grad():
        got = gen(m, k).numpy()
        got_f = gen.fold_for_inference()(m, k).numpy()
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_f, want_f, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mask,points,factored,shared", [
    ({"type": "stin", "block_sizes": [10]}, 67968, False, False),
    ({"type": "fi", "interval": [2, 3, 4, 5, 6]}, 98304, False, False),
    ({"type": "nowcasting"}, 65536, False, False),
    ({"type": "sti", "block_sizes": [10]}, 3200, True, False),
    ({"type": "stis", "file": "/nonexistent/gauges.txt"}, 4096, True, True),
])
def test_from_config_budgets_match_jax(mask, points, factored, shared):
    """At full width (128x128, T=16) ``from_config`` builds the path and the
    point budget JAX builds, for all five mask types (an unreadable stis file
    falls back to 256 gauges a frame in both)."""
    cfg = _cfg(mask)
    gen = P2IGenerator.from_config(cfg)
    jgen = JaxGenerator.from_config(cfg)
    assert gen.idw_max_points == jgen.idw_max_points == points
    assert (gen.idw_factored, gen.idw_shared_batch_mask) == (
        jgen.idw_factored, jgen.idw_shared_batch_mask) == (factored, shared)
    assert gen.input.factored == factored and gen.input.max_points == points
