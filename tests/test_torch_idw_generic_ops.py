"""PyTorch port vs the JAX package: the generic IDW of masks that vary per frame.

Inputs come from numpy seeds. The JAX side runs on the CPU through its Pallas
kernels in interpret mode (``pltpu.force_tpu_interpret_mode()``, as
``tests/test_pallas.py`` runs them) and through its XLA ``idw_3d_knn``; the
port runs its plain PyTorch versions (CPU tensors), which follow the Pallas
kernels' arithmetic.

Tolerances: ``extract_points`` bitwise against JAX run op by op (jitted, XLA
turns the division by W-1 into a reciprocal multiply); forward values atol
1e-5 (the interpreted kernels run under jit, where sums may contract into an
FMA), with the selection itself identical (chunked sel_idx equal, and a flipped
selection on the tie-heavy lattice would move a value by O(0.1)); w_norm atol
1e-6; gradients 1e-5 x max|gradient| (sums over the queries in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p2igan_tpu.ops import idw as jidw
from p2igan_tpu.ops.pallas import idw_kernel as jkern
from p2igan_tpu_torch.ops import idw as tidw
from p2igan_tpu_torch.ops import idw_kernel as tkern


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("max_points", [40, 700, 3000])
def test_extract_points_matches_jax(max_points):
    """Slots in flat t-major order, coordinates idx/(N-1), values times valid,
    and truncation at ``max_points`` (40 and 700 drop points of the 1049
    observed, 3000 leaves empty slots): bitwise what JAX's static nonzero
    gather gives, sample by sample and as one batch."""
    rng = np.random.default_rng(0)
    D, H, W = 5, 17, 23
    masks = (rng.random((3, D, H, W)) < 0.6).astype(np.float32)
    masks[2] = 0.0  # an empty mask
    vals = rng.normal(size=(3, D, H, W)).astype(np.float32)
    bp, bv, bvalid = tidw.extract_points(_t(masks), _t(vals), max_points)
    for b in range(3):
        jp, jv, jvalid = (np.asarray(a) for a in jidw.extract_points(
            jnp.asarray(masks[b]), jnp.asarray(vals[b]), max_points))
        tp, tv, tvalid = tidw.extract_points(_t(masks[b]), _t(vals[b]), max_points)
        assert np.array_equal(tp.numpy().view(np.int32), jp.view(np.int32))
        assert np.array_equal(tv.numpy().view(np.int32), jv.view(np.int32))
        assert np.array_equal(tvalid.numpy(), jvalid)
        assert torch.equal(bp[b], tp) and torch.equal(bv[b], tv)
        assert torch.equal(bvalid[b], tvalid)
    assert int(bvalid[0].sum()) == min(max_points, int(masks[0].sum()))
    assert not bool(bvalid[2].any()) and float(bv[2].abs().max()) == 0.0


def test_extract_points_is_differentiable_in_the_values():
    rng = np.random.default_rng(1)
    mask = _t((rng.random((2, 3, 4, 5)) < 0.5).astype(np.float32))
    vals = _t(rng.normal(size=(2, 3, 4, 5)).astype(np.float32)).requires_grad_(True)
    _, v, valid = tidw.extract_points(mask, vals, 30)
    v.sum().backward()
    assert torch.equal(vals.grad, (mask > 0).to(torch.float32) *
                       (torch.cumsum((mask > 0).reshape(2, -1), 1) <= 30)
                       .reshape(mask.shape).to(torch.float32))


def _lattice(rng, P, D=2, H=17, W=17):
    """Points on the power-of-two lattice of tests/test_pallas.py:201-231
    (spacing 1/16), duplicates included: every distance is exact, and the k-th
    neighbour is decided by genuine ties."""
    iz, iy, ix = rng.integers(0, D, P), rng.integers(0, H, P), rng.integers(0, W, P)
    return np.stack([ix / (W - 1), iy / (H - 1), iz / (D - 1)], -1).astype(np.float32)


def _case(kind, P, n_valid, seed=0):
    rng = np.random.default_rng(seed)
    pts = (_lattice(rng, P) if kind == "lattice"
           else rng.random((P, 3)).astype(np.float32))
    vals = rng.normal(size=(P,)).astype(np.float32)
    valid = np.arange(P) < n_valid
    return pts, vals, valid


def _pallas(pts, vals, valid, shape):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jkern.idw_3d_knn_pallas(
            jnp.asarray(pts), jnp.asarray(vals), jnp.asarray(valid), shape))


def _port(pts, vals, valid, shape):
    return tidw.idw_3d_knn(_t(pts), _t(vals), _t(valid), shape).numpy()


SHAPE = (2, 17, 17)


@pytest.mark.parametrize("kind,P,n_valid", [
    ("random", 40, 33),          # single pass
    ("lattice", 300, 263),       # single pass, ties everywhere
    ("lattice", 4596, 4559),     # chunked, ties everywhere
    ("random", 4200, 4100),      # chunked
])
def test_forward_matches_pallas_and_xla(kind, P, n_valid):
    pts, vals, valid = _case(kind, P, n_valid)
    want = _pallas(pts, vals, valid, SHAPE)
    xla = np.asarray(jidw.idw_3d_knn(jnp.asarray(pts), jnp.asarray(vals),
                                     jnp.asarray(valid), SHAPE, k=4, chunk=512))
    got = _port(pts, vals, valid, SHAPE)
    assert got.shape == SHAPE and np.abs(want).max() > 0.1
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(got - xla).max() < 1e-5
    # the selection itself, against the TPU chunked kernel's merge (any P)
    with pltpu.force_tpu_interpret_mode():
        _, (jsel, jw) = jkern._idw_forward_chunked(
            jnp.asarray(pts), jnp.asarray(vals), jnp.asarray(valid), SHAPE, 4, 2.0,
            0.05, 512)
    pts4, pv = tkern.prep_points(_t(pts)[None], _t(vals)[None], _t(valid)[None])
    out, (sel, w_norm) = tkern.idw_knn_chunked_reference(pts4, pv, SHAPE)
    assert np.array_equal(sel[0].numpy(), np.asarray(jsel))
    np.testing.assert_allclose(w_norm[0].numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    single, _ = tkern.idw_knn_single_reference(pts4, pv, SHAPE)
    assert torch.equal(single, out)  # the two plain versions: one arithmetic


@pytest.mark.parametrize("P", [300, 4200])
@pytest.mark.parametrize("n_valid", [2, 0])
def test_fewer_than_k_valid_and_empty_match_the_interpreted_kernel(P, n_valid):
    """Fewer than k valid points, and none: the invalid slots carry a 1e30
    penalty and stay selectable with weight ~1e-30 (the XLA fallback's inf
    would drop them), so the port is held to the interpreted Pallas kernel."""
    pts, vals, valid = _case("random", P, n_valid, seed=3)
    vals = vals * valid  # extract_points zeroes the values of empty slots
    want = _pallas(pts, vals, valid, SHAPE)
    got = _port(pts, vals, valid, SHAPE)
    assert np.abs(got - want).max() < 1e-5
    if n_valid == 0:
        assert not got.any()
    else:
        assert np.abs(got).max() > 0.1


@pytest.mark.parametrize("P", [300, 4200])
def test_gradients_match_jax_grad_of_the_pallas_op(P):
    """d_values against ``jax.grad`` of ``idw_3d_knn_pallas`` (at P <= 4096 its
    kernel #10 recomputes the selection, above it JAX scatters the chunked
    forward's): the port scatters the forward's own selection on both ranges
    (:func:`scatter_selection`, index_add_ on the CPU)."""
    shape = (2, 8, 8)
    pts, vals, valid = _case("lattice" if P == 300 else "random", P, P - 20, seed=5)
    cot = np.random.default_rng(6).normal(size=shape).astype(np.float32)

    def loss(v):
        return jnp.sum(jkern.idw_3d_knn_pallas(jnp.asarray(pts), v, jnp.asarray(valid),
                                               shape) * cot)

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(loss)(jnp.asarray(vals)))
    v = _t(vals).requires_grad_(True)
    out = tidw.idw_3d_knn(_t(pts), v, _t(valid), shape)
    assert out.grad_fn is not None
    out.backward(_t(cot))
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("P", [300, 4200])
def test_batch_dispatch_and_linearity(P, monkeypatch):
    """A batch is the samples one by one; P <= 4096 takes the single pass and
    a larger P the chunked path (the JAX package's split); the op is exactly
    linear in the values, so <dv, v> == <g, f(v)> for the backward of either."""
    shape = (2, 8, 8)
    rng = np.random.default_rng(7)
    pts = _t(rng.random((2, P, 3)).astype(np.float32))
    vals = _t(rng.normal(size=(2, P)).astype(np.float32)).requires_grad_(True)
    valid = _t(np.stack([np.arange(P) < P - 9, np.arange(P) < P // 2]))
    calls = []
    for name in ("idw_knn_single", "idw_knn_chunked"):
        fn = getattr(tkern, name)
        monkeypatch.setattr(tkern, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    out = tidw.idw_3d_knn(pts, vals, valid, shape)
    assert calls == ["idw_knn_single" if P <= tkern.P_SINGLE_PASS_MAX else "idw_knn_chunked"]
    for b in range(2):
        one = tidw.idw_3d_knn(pts[b], vals[b].detach(), valid[b], shape)
        assert torch.equal(one, out[b].detach())
    g = _t(rng.normal(size=(2,) + shape).astype(np.float32))
    out.backward(g)
    lhs = float((vals.grad.double() * vals.detach().double()).sum())
    rhs = float((g.double() * out.detach().double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(rhs)


def test_plain_backward_equals_autograd_of_the_plain_forward():
    """The plain version of #10 (w * (g / (sum w + 1e-12)) into the selected
    points) against autograd of the plain forward, and the chunked scatter
    against both."""
    shape = (2, 8, 8)
    rng = np.random.default_rng(8)
    pts4, pv = tkern.prep_points(_t(rng.random((1, 150, 3)).astype(np.float32)),
                                 _t(rng.normal(size=(1, 150)).astype(np.float32)),
                                 _t(np.arange(150)[None] < 140))
    g = _t(rng.normal(size=(1, 128)).astype(np.float32))
    v = pv.clone().requires_grad_(True)
    with torch.enable_grad():
        (want,) = torch.autograd.grad(
            tkern._forward_plain(pts4, v, shape, 4, 2.0, 0.05, False)[0], v, g)
    got = tkern.idw_knn_bwd_reference(pts4, g, shape)
    _, (sel, w_norm) = tkern.idw_knn_chunked_reference(pts4, pv, shape)
    scat = tkern.scatter_selection(sel, w_norm, g, pts4.shape[1])
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    assert float((scat - want).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("kind,P,n_valid", [("lattice", 300, 300), ("random", 1000, 2)])
def test_single_pass_scatter_matches_jax_grad_of_the_pallas_op(kind, P, n_valid):
    """The P <= 4096 backward is now a scatter of the forward's saved
    selection (``scatter_selection``, kernel #10 on the card, ``index_add_``
    here) and still equals ``jax.grad`` of ``idw_3d_knn_pallas``, whose single
    pass kernel #10 recomputes the selection: ties everywhere, and fewer than
    k valid points (every query then takes invalid slots of weight ~1e-30),
    per sample of a batch of two, atol 1e-5 x max|gradient|. The same scatter
    equals the recomputing plain version of #10, ``idw_knn_bwd_reference``."""
    shape = (2, 8, 8)
    cases = [_case(kind, P, n_valid, seed=s) for s in (11, 12)]
    cots = np.random.default_rng(13).normal(size=(2,) + shape).astype(np.float32)
    pts4, pv = tkern.prep_points(_t(np.stack([c[0] for c in cases])),
                                 _t(np.stack([c[1] * c[2] for c in cases])),
                                 _t(np.stack([c[2] for c in cases])))
    out, (sel, w_norm) = tkern.idw_knn_single(pts4, pv, shape, with_sel=True)
    g = _t(cots.reshape(2, -1))
    got = tkern.scatter_selection(sel, w_norm, g, pts4.shape[1])
    recomputed = tkern.idw_knn_bwd_reference(pts4, g, shape)
    for b, (pts, vals, valid) in enumerate(cases):
        def loss(v):
            return jnp.sum(jkern.idw_3d_knn_pallas(jnp.asarray(pts), v,
                                                   jnp.asarray(valid), shape) * cots[b])

        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax.grad(loss)(jnp.asarray(vals * valid)))
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got[b, :P].numpy(), want, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(got[b].numpy(), recomputed[b].numpy(), rtol=0,
                                   atol=1e-6 * scale)
    assert not bool(got[:, P:].any())  # padding slots: never selected here
