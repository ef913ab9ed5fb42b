"""PyTorch P2IGenerator vs the JAX package's, on one torch-layout state.

The same reference-layout random state loads into JAX through
``torch_import.import_p2igan_generator`` and into the port through
``load_state_dict``; the same numpy inputs (a shared stis-style gauge mask)
go through both. Generator tolerance: atol 1e-4 (ROADMAP).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2igan_tpu.models import P2IGenerator as JaxGenerator
from p2igan_tpu.models import torch_import as TI
from p2igan_tpu_torch.models import (P2IGenerator, build_discriminator,
                                     build_generator_for_inference)
from p2igan_tpu_torch.models.convert import state_dict_from_jax
from p2igan_tpu_torch.ops.doconv import make_d_diag
from p2igan_tpu_torch.ops.layers import InputBlock
from p2igan_tpu_torch.training.checkpoint import (load_generator_state,
                                                  resolve_checkpoint)

T, BASE, HW, NUM_RES = 4, 16, 16, 1
GEN_KW = dict(H=HW, W=HW, length=T, num_res=NUM_RES, base_channels=BASE,
              idw_max_points=128)


def reference_state(seed=0, t=T, base=BASE, h=HW, w=HW, num_res=NUM_RES):
    """Reference-layout state_dict (key names and shapes of the torch repo)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def add(name, shape, scale=0.05):
        sd[name] = rng.normal(0, scale, shape).astype(np.float32)

    for i in range(2):
        add(f"input.layers.{i}.conv.weight", (t, t, 1), 0.3)
        add(f"input.layers.{i}.conv.bias", (t,))
    add("Convsin.0.main.0.W", (base, t // 4, 9), 0.3)
    add("Convsin.0.main.0.D", (t, 9, 9))
    add("ConvsOut.0.main.0.W", (t, base // 4, 1), 0.3)
    for k, ch in enumerate([base, base * 2, base * 4, base * 8]):
        for i in range(num_res):
            for j in (0, 1):
                add(f"Decoder.{k}.layers.{i}.main.{j}.main.0.W", (ch, ch, 9))
                add(f"Decoder.{k}.layers.{i}.main.{j}.main.0.D", (ch, 9, 9))
    for k, (cin, cout, hh, ww) in enumerate(
            [(base * 2, base, h, w), (base * 4, base * 2, h // 2, w // 2),
             (base * 8, base * 4, h // 4, w // 4)]):
        add(f"UP.{k}.pos", (1, 1, hh, ww), 1.0)
        add(f"UP.{k}.proj.weight", (cout, cin, 1, 1), 0.2)
        add(f"UP.{k}.proj.bias", (cout,))
    return sd


def shared_mask_inputs(seed=1, B=2, n_gauges=11):
    rng = np.random.default_rng(seed)
    flat = np.zeros((HW * HW,), np.float32)
    flat[rng.choice(HW * HW, n_gauges, replace=False)] = 1.0
    masks = np.broadcast_to(flat.reshape(1, 1, HW, HW, 1),
                            (B, T, HW, HW, 1)).astype(np.float32)
    masked = rng.random((B, T, HW, HW, 1)).astype(np.float32) * masks
    return masked, masks


def torch_state(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_outputs():
    sd = reference_state()
    variables = TI.import_p2igan_generator(sd, num_res=NUM_RES)
    gen = JaxGenerator(idw_factored=True, idw_shared_batch_mask=True, **GEN_KW)
    masked, masks = shared_mask_inputs()
    out = np.asarray(gen.apply(variables, jnp.asarray(masked), jnp.asarray(masks)))
    egen, evars = gen.fold_for_inference(variables)
    out_f = np.asarray(egen.apply(evars, jnp.asarray(masked), jnp.asarray(masks)))
    return sd, variables, masked, masks, out, out_f


def test_generator_matches_jax_unfolded_and_folded(jax_outputs):
    sd, _, masked, masks, want, want_folded = jax_outputs
    gen = P2IGenerator(**GEN_KW)
    gen.load_state_dict(torch_state(sd))
    with torch.no_grad():
        got = gen(torch.from_numpy(masked), torch.from_numpy(masks)).numpy()
        folded = gen.fold_for_inference()
        got_f = folded(torch.from_numpy(masked), torch.from_numpy(masks)).numpy()
    assert got.shape == masked.shape
    assert np.abs(want).max() > 0.05  # a non-degenerate output
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_f, want_folded, atol=1e-4, rtol=0)
    # the folded state has the reference eval layout: plain OIHW kernels
    fsd = folded.state_dict()
    assert fsd["Convsin.0.main.0.W"].shape == (BASE, T // 4, 3, 3)
    assert "Convsin.0.main.0.D" not in fsd


def test_hoisted_idw_selection_matches_inline(jax_outputs):
    sd, _, masked, masks, _, _ = jax_outputs
    gen = P2IGenerator(**GEN_KW)
    gen.load_state_dict(torch_state(sd))
    m, k = torch.from_numpy(masked), torch.from_numpy(masks)
    with torch.no_grad():
        prep = gen.prepare_idw(k[0, 0, :, :, 0])
        np.testing.assert_array_equal(gen(m, k, idw_prepared=prep).numpy(),
                                      gen(m, k).numpy())
    over = torch.ones(HW, HW)  # 256 gauges > the 128-slot budget
    with pytest.raises(ValueError, match="observed gauges"):
        gen.prepare_idw(over)


def test_state_dict_from_jax_round_trips(jax_outputs):
    sd, variables, *_ = jax_outputs
    back = state_dict_from_jax(variables)
    assert set(back) == set(sd)
    for key, v in sd.items():
        assert back[key].dtype == torch.float32
        np.testing.assert_array_equal(back[key].numpy(), v, err_msg=key)
    # strict accounting: a missing leaf and an extra leaf both raise
    params = {k: dict(v) for k, v in variables["params"].items()}
    del params["UP_0"]["pos"]
    with pytest.raises(KeyError, match="UP_0/pos"):
        state_dict_from_jax({"params": params})
    params = {k: dict(v) for k, v in variables["params"].items()}
    params["UP_0"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unused"):
        state_dict_from_jax({"params": params})


def test_reference_state_loads_with_and_without_d_diag(jax_outputs):
    sd = jax_outputs[0]
    plain = P2IGenerator(**GEN_KW)
    plain.load_state_dict(torch_state(sd))
    with_diag = dict(torch_state(sd))
    for key in sd:
        if key.endswith(".D"):
            ch, mn, dm = sd[key].shape
            with_diag[key[:-1] + "D_diag"] = torch.from_numpy(make_d_diag(ch, 3, 3, dm))
    gen = P2IGenerator(**GEN_KW)
    gen.load_state_dict(with_diag)  # strict
    for (k1, v1), (k2, v2) in zip(plain.state_dict().items(),
                                  gen.state_dict().items()):
        assert k1 == k2 and torch.equal(v1, v2)
    bad = dict(with_diag)
    bad["Convsin.0.main.0.D_diag"] = bad["Convsin.0.main.0.D_diag"] * 2
    with pytest.raises(RuntimeError, match="D_diag"):
        P2IGenerator(**GEN_KW).load_state_dict(bad)


def test_seeded_init_is_reproducible():
    a = P2IGenerator(**GEN_KW, generator=torch.Generator().manual_seed(3))
    b = P2IGenerator(**GEN_KW, generator=torch.Generator().manual_seed(3))
    for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(v, w), k
    assert set(a.state_dict()) == set(reference_state())


def test_unported_paths_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="generic IDW"):
        InputBlock(4, factored=False)
    # the per-sample factored block (sti masks) is ported: it builds, and
    # refuses a hoisted selection, which only a shared mask can use
    block = InputBlock(4, factored=True, shared_batch_mask=False, max_points=128)
    with pytest.raises(ValueError, match="prepared"):
        block(torch.zeros(1, 4, 8, 8), torch.zeros(1, 4, 8, 8), prepared=(None,) * 3)
    # simple is ported: the registry builds it, by name and as the default
    for cfg in ({"model": {"name": "simple", "base_channels": 4}},
                {"model": {"base_channels": 4}}):
        assert type(build_generator_for_inference(cfg)).__name__ == "SimpleGenerator"
    with pytest.raises(NotImplementedError, match="disc_branch3d_dtype"):
        build_discriminator({"model": {"name": "p2igan",
                                       "disc_branch3d_dtype": "bfloat16"}})
    ckpt = tmp_path / "latest.ckpt"
    ckpt.write_bytes(b"\x80")
    assert resolve_checkpoint(tmp_path) == ckpt
    with pytest.raises(NotImplementedError, match="state_dict_from_jax"):
        load_generator_state(ckpt)
    pt = tmp_path / "g.pt"
    torch.save({"generator": {"x": torch.ones(2)}}, pt)
    assert torch.equal(load_generator_state(resolve_checkpoint(tmp_path, pt))["x"],
                       torch.ones(2))
