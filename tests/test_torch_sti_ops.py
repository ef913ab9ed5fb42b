"""PyTorch port vs the JAX package: the factored IDW on per-sample masks (sti).

Inputs come from numpy seeds. The JAX side runs on the CPU twice: through its
plain (XLA) path op by op (``use_pallas=False``, not jitted: a jitted program
contracts ``dx*dx + dy*dy`` into an FMA and flips exact gauge ties, and an sti
mask, a jittered grid, is full of them), and through its Pallas kernels in
interpret mode, as ``tests/test_pallas.py`` runs them. The port runs its plain
PyTorch versions (CPU tensors).

Tolerances: the gauge selection (gd2, gsel, gauge_pix) bitwise; forward values
atol 1e-6 against the XLA path (its weighted sum may contract into an FMA);
atol 1e-5 against the interpreted Pallas kernels (they gather with one-hot
matmuls and run under jit); gradients 1e-5 x max|gradient| (sums over HW pixels
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p2igan_tpu.ops import idw as jidw
from p2igan_tpu.ops import layers as jlayers
from p2igan_tpu.ops.pallas import idw_factored_kernel as jkern
from p2igan_tpu_torch.data.masks import create_mask_np
from p2igan_tpu_torch.ops import idw as tidw
from p2igan_tpu_torch.ops import idw_factored_kernel as tkern
from p2igan_tpu_torch.ops.layers import InputBlock

H = W = 16
G = 128


def _sti(rng, bs, h=H, w=W):
    return create_mask_np((1, h, w, 1), rng, "sti", block_sizes=[bs])[0, :, :, 0]


def _random(rng, n, h=H, w=W):
    flat = np.zeros((h * w,), np.float32)
    flat[rng.choice(h * w, n, replace=False)] = 1.0
    return flat.reshape(h, w)


def _mask_batch(seed=0):
    """Six samples of one size with different gauge sets: jittered grids of
    two block sizes (16 and 64 gauges, tie-heavy), random gauges, fewer than
    k, and an empty mask."""
    rng = np.random.default_rng(seed)
    return np.stack([_sti(rng, 4), _sti(rng, 2), _sti(rng, 4), _random(rng, 13),
                     _random(rng, 2), np.zeros((H, W), np.float32)])


def _jax_prepare(mask, k=4):
    return jidw.factored_prepare_full(jnp.asarray(mask), G, k=k, use_pallas=False)


@pytest.mark.parametrize("k", [4, 3])
def test_batched_prepare_matches_jax_per_mask(k):
    """One batched call == JAX mask by mask (the JAX package vmaps it), and ==
    the port's own single-mask calls: all three results bitwise."""
    masks = _mask_batch()
    gd2, gsel, gpix = tidw.factored_prepare_full(torch.from_numpy(masks), G, k=k)
    assert gd2.shape == gsel.shape == (len(masks), H * W, k)
    assert gpix.shape == (len(masks), G)
    for b, mask in enumerate(masks):
        want = _jax_prepare(mask, k)
        for got, w in zip((gd2[b], gsel[b], gpix[b]), want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        one = tidw.factored_prepare_full(torch.from_numpy(mask), G, k=k)
        for got, o in zip((gd2[b], gsel[b], gpix[b]), one):
            assert torch.equal(got, o)


def test_gauge_geometry_truncates_and_pads_like_jax():
    """More gauges than slots: the first max_gauges in pixel order stay (JAX's
    static nonzero); fewer: padding slots sit at pixel HW-1 with a 1e30
    penalty. A budget above HW (tiny masks) pads too."""
    rng = np.random.default_rng(5)
    mask = _random(rng, 40, 8, 8)
    for budget in (16, 128):
        qx, qy, gx, gy, pen, gpix = tidw.gauge_geometry(torch.from_numpy(mask), budget)
        (obs,) = np.nonzero(mask.reshape(-1))
        n = min(len(obs), budget)
        np.testing.assert_array_equal(gpix.numpy()[:n], obs[:n])
        np.testing.assert_array_equal(gpix.numpy()[n:], 63)
        np.testing.assert_array_equal(pen.numpy(), np.where(np.arange(budget) < n, 0, 1e30)
                                      .astype(np.float32))
        np.testing.assert_array_equal(
            gx.numpy()[:n], (obs[:n] % 8).astype(np.float32) / np.float32(7))
        np.testing.assert_array_equal(
            gy.numpy()[:n], (obs[:n] // 8).astype(np.float32) / np.float32(7))
        want = jidw.factored_prepare_full(jnp.asarray(mask), budget, use_pallas=False)
        got = tidw.factored_prepare_full(torch.from_numpy(mask), budget)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


@pytest.mark.parametrize("D,k", [(16, 4), (4, 4), (1, 4), (4, 3)])
def test_factored_apply_gauges_per_sample_matches_jax(D, k):
    """#5: every sample combines from its own selection. Against the XLA path
    atol 1e-6, against the interpreted Pallas kernel atol 1e-5."""
    rng = np.random.default_rng(D * 10 + k)
    masks = _mask_batch(seed=D)
    B = len(masks)
    vals = rng.normal(size=(B, D, G)).astype(np.float32)
    gd2, gsel, _ = tidw.factored_prepare_full(torch.from_numpy(masks), G, k=k)
    got = tidw.factored_apply_gauges(gd2, gsel, torch.from_numpy(vals), (H, W),
                                     k=k).numpy()
    assert got.shape == (B, D, H, W)
    np.testing.assert_array_equal(got[-1], 0.0)  # the empty mask
    for b, mask in enumerate(masks):
        jgd2, jgsel, _ = _jax_prepare(mask, k)
        want = np.asarray(jidw.factored_apply_gauges(
            jgd2, jgsel, jnp.asarray(vals[b]), (H, W), k=k, use_pallas=False))
        np.testing.assert_allclose(got[b], want, atol=1e-6, rtol=0, err_msg=str(b))
        with pltpu.force_tpu_interpret_mode():
            kern = np.asarray(jidw.factored_apply_gauges(
                jgd2, jgsel, jnp.asarray(vals[b]), (H, W), k=k, use_pallas=True))
        np.testing.assert_allclose(got[b], kern, atol=1e-5, rtol=0, err_msg=str(b))
        # the single-window call is the batched call's row
        one = tidw.factored_apply_gauges(gd2[b], gsel[b], torch.from_numpy(vals[b]),
                                         (H, W), k=k)
        np.testing.assert_array_equal(one.numpy(), got[b])


def test_per_sample_combine_equals_shared_combine_on_a_shared_mask():
    """With one mask for all samples the per-sample combine (#5) gives what
    the multi-window combine (#2) gives, bit for bit: one selection code."""
    rng = np.random.default_rng(2)
    mask = _sti(rng, 4)
    vals = torch.from_numpy(rng.normal(size=(3, 16, G)).astype(np.float32))
    gd2, gsel, _ = tidw.factored_prepare_full(torch.from_numpy(mask), G)
    shared = tidw.factored_apply_gauges_batch(gd2, gsel, vals, (H, W))
    per = tidw.factored_apply_gauges(gd2.expand(3, -1, -1), gsel.expand(3, -1, -1),
                                     vals, (H, W))
    assert torch.equal(shared, per)


@pytest.mark.parametrize("D", [16, 4])
def test_combine_table_gradient_matches_jax(D):
    """#6: d_table from a cotangent, per sample, against the interpreted
    Pallas backward kernel and against jax.grad of the XLA path; and autograd
    through the port's Function gives the same as the direct call."""
    rng = np.random.default_rng(7 + D)
    masks = _mask_batch(seed=3)[:4]
    B = len(masks)
    cot = rng.normal(size=(B, D, H * W)).astype(np.float32)
    gd2, gsel, _ = tidw.factored_prepare_full(torch.from_numpy(masks), G)
    gd2_t = gd2.transpose(1, 2).contiguous()
    gsel_t = gsel.transpose(1, 2).contiguous()
    got = tkern.combine_table_bwd(gd2_t, gsel_t, torch.from_numpy(cot), G, 4).numpy()
    tables = torch.zeros((B, D, G), requires_grad=True)
    out = tkern.combine_table(gd2_t, gsel_t, tables, 4)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(tables.grad.numpy(), got)
    dz2 = jnp.asarray(jidw.frame_dz2_np(D))
    for b, mask in enumerate(masks):
        jgd2, jgsel, _ = _jax_prepare(mask)
        with pltpu.force_tpu_interpret_mode():
            kern = np.asarray(jkern.factored_combine_table_bwd_pallas(
                jgd2.T, jgsel.T, jnp.asarray(cot[b]), dz2, G=G, k=4, D=D))
        xla = np.asarray(jax.grad(lambda t: jnp.sum(jidw.factored_apply_gauges(
            jgd2, jgsel, t, (H, W), use_pallas=False).reshape(D, -1) * cot[b]))(
                jnp.zeros((D, G), jnp.float32)))
        tol = 1e-5 * max(np.abs(xla).max(), 1e-30)
        np.testing.assert_allclose(got[b], xla, atol=tol, rtol=0, err_msg=str(b))
        np.testing.assert_allclose(got[b], kern, atol=tol, rtol=0, err_msg=str(b))
    # padding slots and unselected gauges get no gradient
    n_obs = (masks.reshape(B, -1) > 0).sum(1)
    for b in range(B):
        np.testing.assert_array_equal(got[b][:, n_obs[b]:], 0.0)


@pytest.mark.parametrize("name", ["sti4", "sti2", "rng13", "fewer_than_k", "empty"])
@pytest.mark.parametrize("D", [16, 4, 1])
def test_idw_3d_factored_matches_jax(name, D):
    """#7: the dense-field op, forward (XLA path atol 1e-6, interpreted Pallas
    kernel atol 1e-5) and its gradient to the field (1e-5 x max)."""
    rng = np.random.default_rng(11)
    mask = {"sti4": lambda: _sti(rng, 4), "sti2": lambda: _sti(rng, 2),
            "rng13": lambda: _random(rng, 13), "fewer_than_k": lambda: _random(rng, 2),
            "empty": lambda: np.zeros((H, W), np.float32)}[name]()
    values = rng.normal(size=(D, H, W)).astype(np.float32)
    cot = rng.normal(size=(D, H, W)).astype(np.float32)
    field = torch.from_numpy(values).requires_grad_(True)
    out = tidw.idw_3d_factored(torch.from_numpy(mask), field, G)
    assert out.shape == (D, H, W) and out.grad_fn is not None
    want = np.asarray(jidw.idw_3d_factored(jnp.asarray(mask), jnp.asarray(values), G,
                                           use_pallas=False))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-6, rtol=0)
    gd2, gpix = jidw.factored_prepare(jnp.asarray(mask), G, use_pallas=False)
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(jidw.factored_apply(gd2, gpix, jnp.asarray(values),
                                              use_pallas=True))
    np.testing.assert_allclose(out.detach().numpy(), kern, atol=1e-5, rtol=0)
    if name == "empty":
        np.testing.assert_array_equal(out.detach().numpy(), 0.0)
    out.backward(torch.from_numpy(cot))
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(jidw.factored_apply(
        gd2, gpix, v, use_pallas=False) * cot))(jnp.asarray(values)))
    np.testing.assert_allclose(field.grad.numpy(), jgrad, rtol=0,
                               atol=1e-5 * max(np.abs(jgrad).max(), 1e-30))
    # the prepared pair is JAX's
    tgd2, tgpix = tidw.factored_prepare(torch.from_numpy(mask), G)
    np.testing.assert_array_equal(tgd2.numpy(), np.asarray(gd2))
    np.testing.assert_array_equal(tgpix.numpy(), np.asarray(gpix))


def test_combine_dense_gradient_is_the_plain_versions():
    """The dense combine differentiates through its plain version, to the
    candidate values only: gd2 is fixed geometry and gets no gradient."""
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(_sti(rng, 4))
    gd2, gpix = tidw.factored_prepare(mask, G)
    gd2_t = gd2.t().contiguous().requires_grad_(True)
    cvals_t = torch.from_numpy(rng.normal(size=(4 * 4, H * W)).astype(np.float32))
    cvals_t.requires_grad_(True)
    out = tkern.combine_dense(gd2_t, cvals_t, 4)
    ref = tkern.combine_dense_reference(gd2_t.detach(), cvals_t, 4)
    assert torch.equal(out, ref)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    d_gd2, d_cvals = torch.autograd.grad(out, (gd2_t, cvals_t), g, allow_unused=True)
    (want,) = torch.autograd.grad(ref, cvals_t, g)
    assert d_gd2 is None and torch.equal(d_cvals, want)
    assert float(d_cvals.abs().max()) > 0


def _pruned_combine(gd2_t, cvals_t, k):
    """The combine over the PRUNED candidate set the CUDA kernels walk: per
    query z the kf frames of ``pruned_frame_table``, candidates frame-major,
    k rounds of lowest-index first-min extraction."""
    D = cvals_t.shape[0] // k
    HW = gd2_t.shape[1]
    sel, fd2 = tkern.pruned_frame_table(D, k)
    kf = sel.shape[1]
    bigd = tidw._sqrt_rn(torch.tensor(1e30))
    col = torch.arange(kf * k, dtype=torch.int32)[:, None].expand(kf * k, HW)
    rows = []
    for z in range(D):
        cd = tidw._sqrt_rn(gd2_t.repeat(kf, 1) + fd2[z][:, None])
        cd = torch.where(cd < bigd, cd, bigd)
        src = (sel[z].long()[:, None] * k + torch.arange(k)[None, :]).reshape(-1)
        cv = cvals_t[src]
        w_sum = torch.zeros(HW)
        wv = torch.zeros(HW)
        for _ in range(k):
            d_min = cd.amin(dim=0)
            idx = tkern.first_min_index(cd, d_min[None, :], col, dim=0)
            hit = col == idx[None, :]
            v = torch.where(hit, cv, torch.zeros_like(cv)).sum(0)
            invd = 1.0 / (d_min + 0.05)
            w = torch.where(d_min < bigd, invd * invd, torch.zeros_like(invd))
            w_sum = w_sum + w
            wv = wv + w * v
            cd = torch.where(hit, bigd, cd)
        rows.append(wv / (w_sum + 1e-12))
    return torch.stack(rows)


@pytest.mark.parametrize("D,k", [(16, 4), (16, 3), (5, 4)])
def test_frame_pruning_is_exact_on_sti_masks(D, k):
    """Counterpart of tests/test_pallas.py::
    test_factored_combine_frame_pruning_matches_full: the pruned candidate
    set the kernels read from ``pruned_frame_table`` gives bit for bit what all
    D frames give, on tie-rich jittered grids (symmetric +-z ties at every
    interior frame, integer-offset gauge ties)."""
    for seed in range(3):
        rng = np.random.default_rng(seed)
        mask = torch.from_numpy(_sti(rng, 4 if seed else 2))
        gd2, gpix = tidw.factored_prepare(mask, G, k=k)
        values = torch.from_numpy(rng.normal(size=(D, H * W)).astype(np.float32))
        cvals_t = values[:, gpix.long()].permute(0, 2, 1).reshape(D * k, H * W)
        full = tkern.combine_dense_reference(gd2.t(), cvals_t, k)
        assert torch.equal(_pruned_combine(gd2.t().contiguous(), cvals_t, k), full)


def _jax_input_block(shared, D, x, masks, seed=0):
    block = jlayers.InputBlock(factored=True, shared_batch_mask=shared,
                               max_points=D * G, use_pallas=False)
    variables = block.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(masks))
    # zero-initialised biases would leave the bias path untested
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(seed)
    for att in params.values():
        att["bias"] = rng.normal(0, 0.1, att["bias"].shape).astype(np.float32)
    return block, {"params": params}


def _load_block(block: InputBlock, params):
    with torch.no_grad():
        for i, layer in enumerate(block.layers):
            att = params[f"att{i}"]
            layer.conv.weight.copy_(torch.from_numpy(
                np.transpose(np.asarray(att["kernel"]), (2, 1, 0)).copy()))
            layer.conv.bias.copy_(torch.from_numpy(np.asarray(att["bias"])))


def test_input_block_per_sample_matches_jax():
    """InputBlock(factored, not shared) with carried weights on a batch whose
    samples carry different sti masks: forward atol 1e-5 (two attention
    layers before the combine), and the gradient to the attention weights
    1e-4 x max (as the generator's gradients in tests/test_torch_gan.py)."""
    D = 4
    rng = np.random.default_rng(9)
    mask_xy = _mask_batch(seed=9)[:4]
    B = len(mask_xy)
    masks = np.broadcast_to(mask_xy[:, :, :, None], (B, H, W, D)).copy()
    x = rng.random((B, H, W, D)).astype(np.float32) * masks
    cot = rng.normal(size=(B, H, W, D)).astype(np.float32)
    jblock, jvars = _jax_input_block(False, D, x, masks)
    want = np.asarray(jblock.apply(jvars, jnp.asarray(x), jnp.asarray(masks)))
    jgrads = jax.grad(lambda p: jnp.sum(jblock.apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(masks)) * cot))(jvars["params"])

    block = InputBlock(D, max_points=D * G, factored=True, shared_batch_mask=False)
    _load_block(block, jvars["params"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    mt = torch.from_numpy(masks).permute(0, 3, 1, 2).contiguous()
    out = block(xt, mt)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)
    out.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    for i, layer in enumerate(block.layers):
        w = np.transpose(np.asarray(jgrads[f"att{i}"]["kernel"]), (2, 1, 0))
        b = np.asarray(jgrads[f"att{i}"]["bias"])
        np.testing.assert_allclose(layer.conv.weight.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
        np.testing.assert_allclose(layer.conv.bias.grad.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())


def test_input_block_per_sample_equals_shared_on_a_shared_mask():
    """Counterpart of tests/test_idw_factored.py::
    test_shared_batch_mask_inputblock_equivalence: when the samples do share a
    mask both blocks give the same field, here bit for bit."""
    D, B = 4, 3
    rng = np.random.default_rng(1)
    mask = _random(rng, 10)
    masks = torch.from_numpy(np.broadcast_to(mask[None, None], (B, D, H, W)).copy())
    x = torch.from_numpy(rng.random((B, D, H, W)).astype(np.float32)) * masks
    a = InputBlock(D, max_points=D * G, factored=True, shared_batch_mask=False)
    b = InputBlock(D, max_points=D * G, factored=True, shared_batch_mask=True)
    a.layers[0].reset_parameters(torch.Generator().manual_seed(0))
    a.layers[1].reset_parameters(torch.Generator().manual_seed(1))
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        assert torch.equal(a(x, masks), b(x, masks))
