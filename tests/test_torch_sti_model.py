"""PyTorch P2IGenerator vs the JAX package's on per-sample sti masks.

The same reference-layout random state loads into both; the same numpy inputs
(every sample under its own jittered-grid mask) go through both. The JAX
generator runs op by op (``apply`` is not jitted), the arithmetic the port
follows, so tie-heavy masks are fair game. Generator tolerance: atol 1e-4
(ROADMAP), the stis tests' own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2igan_tpu.models import P2IGenerator as JaxGenerator
from p2igan_tpu.models import torch_import as TI
from p2igan_tpu.models.p2igan import _mask_points_budget as jax_points_budget
from p2igan_tpu_torch.data.masks import create_mask_np
from p2igan_tpu_torch.models import P2IGenerator, build_generator
from p2igan_tpu_torch.models.convert import state_dict_from_jax
from p2igan_tpu_torch.models.p2igan import _mask_points_budget
from p2igan_tpu_torch.ops.layers import InputBlock

from test_torch_model import BASE, GEN_KW, HW, NUM_RES, T, reference_state, torch_state

STI_KW = dict(GEN_KW, idw_max_points=T * 128, idw_factored=True,
              idw_shared_batch_mask=False)


def sti_inputs(seed=1, B=3, block=4, hw=HW, t=T):
    """B samples, each under its own frame-constant sti mask."""
    rng = np.random.default_rng(seed)
    masks = np.stack([create_mask_np((t, hw, hw, 1), rng, "sti", block_sizes=[block])
                      for _ in range(B)])
    masked = rng.random((B, t, hw, hw, 1)).astype(np.float32) * masks
    return masked, masks


@pytest.fixture(scope="module")
def jax_outputs():
    sd = reference_state()
    variables = TI.import_p2igan_generator(sd, num_res=NUM_RES)
    gen = JaxGenerator(**STI_KW)
    masked, masks = sti_inputs()
    out = np.asarray(gen.apply(variables, jnp.asarray(masked), jnp.asarray(masks)))
    egen, evars = gen.fold_for_inference(variables)
    out_f = np.asarray(egen.apply(evars, jnp.asarray(masked), jnp.asarray(masks)))
    return sd, variables, masked, masks, out, out_f


def test_sti_generator_matches_jax_unfolded_and_folded(jax_outputs):
    sd, _, masked, masks, want, want_folded = jax_outputs
    gen = P2IGenerator(**STI_KW)
    gen.load_state_dict(torch_state(sd))
    with torch.no_grad():
        got = gen(torch.from_numpy(masked), torch.from_numpy(masks)).numpy()
        got_f = gen.fold_for_inference()(torch.from_numpy(masked),
                                         torch.from_numpy(masks)).numpy()
    assert np.abs(want).max() > 0.05  # a non-degenerate output
    assert not np.array_equal(masks[0], masks[1])  # the samples do differ
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_f, want_folded, atol=1e-4, rtol=0)


def test_sti_generator_sample_is_independent_of_its_batch(jax_outputs):
    """Every sample selects from its own gauges: a sample's output does not
    depend on what else is in the batch (bitwise on the CPU's plain path for
    the IDW; the convolutions after it pick their algorithm by batch size
    and agree to 1e-5)."""
    sd, _, masked, masks, _, _ = jax_outputs
    gen = P2IGenerator(**STI_KW)
    gen.load_state_dict(torch_state(sd))
    m, k = torch.from_numpy(masked), torch.from_numpy(masks)
    with torch.no_grad():
        whole = gen(m, k)
        dense = gen.input(m[:, :, :, :, 0], k[:, :, :, :, 0])
        for b in range(m.shape[0]):
            assert torch.equal(gen.input(m[b:b + 1, :, :, :, 0], k[b:b + 1, :, :, :, 0]),
                               dense[b:b + 1])
            np.testing.assert_allclose(gen(m[b:b + 1], k[b:b + 1]).numpy(),
                                       whole[b:b + 1].numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="prepared"):
        gen(m, k, idw_prepared=gen.prepare_idw(k[0, 0, :, :, 0]))


def test_convert_needs_nothing_new_for_sti(jax_outputs):
    """``input.att{i}`` keys are the shared-mask generator's: the JAX
    variables of an sti generator convert with the same code."""
    sd, variables, *_ = jax_outputs
    back = state_dict_from_jax(variables)
    assert set(back) == set(P2IGenerator(**STI_KW).state_dict()) == set(sd)
    for key, v in sd.items():
        np.testing.assert_array_equal(back[key].numpy(), v, err_msg=key)


def _cfg(mask, hw=128, t=16, test_mask=None):
    data = {"train": {"data_root": "unused.zarr", "w": hw, "h": hw,
                      "sample_length": t, "mask": mask}}
    if test_mask is not None:
        data["test"] = {"data_root": "unused", "w": hw, "h": hw, "mask": test_mask}
    return {"model": {"name": "p2igan", "in_channels": 1, "base_channels": 4 * t},
            "data": data}


@pytest.mark.parametrize("mask,points,slots", [
    ({"type": "sti", "block_sizes": [10]}, 3200, 256),   # 16 x 14 x 14 = 3136
    ({"type": "sti", "block_sizes": [4]}, 17536, 1152),  # 16 x 33 x 33 = 17424
    ({"type": "sti"}, 17536, 1152),                      # the default block size
    ({}, 17536, 1152),                                   # the default mask type
])
def test_from_config_builds_sti_and_sizes_the_budget_as_jax(mask, points, slots):
    cfg = _cfg(mask)
    gen = P2IGenerator.from_config(cfg)
    jgen = JaxGenerator.from_config(cfg)
    assert gen.idw_factored and not gen.idw_shared_batch_mask
    assert (jgen.idw_factored, jgen.idw_shared_batch_mask) == (True, False)
    assert gen.idw_max_points == jgen.idw_max_points == points
    assert InputBlock.gauge_budget(gen.idw_max_points, gen.length) == slots
    assert not gen.input.shared_batch_mask
    assert type(build_generator(cfg)).__name__ == "P2IGenerator"
    for mtype in ("sti", "stin", "fi", "nowcasting"):
        m = {**mask, "type": mtype}
        assert _mask_points_budget(m, 128, 128, 16) == jax_points_budget(m, 128, 128, 16)


def test_from_config_other_mask_types_still_name_the_generic_idw():
    """A denser test split raises the budget; a mask that varies per frame
    builds the generic IDW, as in JAX."""
    cfg = _cfg({"type": "sti", "block_sizes": [10]}, test_mask={"block_sizes": [4]})
    assert P2IGenerator.from_config(cfg).idw_max_points == 17536
    for mtype in ("stin", "fi", "nowcasting"):
        gen = P2IGenerator.from_config(_cfg({"type": mtype}))
        assert not gen.idw_factored and not gen.input.factored
