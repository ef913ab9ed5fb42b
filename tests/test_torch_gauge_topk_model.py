"""A numpy model of #1's one-pass selection (``csrc/gauge_topk.cu``), held bit
for bit against the plain version (``gauge_topk_reference``: k rounds of
first-min, a taken slot set to 1e30) and against the JAX package's un-jitted
selection (``p2igan_tpu/ops/idw.py`` ``factored_prepare_full`` with
``use_pallas=False``, under ``jax.disable_jit()``).

The kernel computes each (pixel, slot) distance once, ((dx*dx) + (dy*dy)) +
penalty rounded at every step, walks the slots in ascending order and keeps
the k best (distance, slot) sorted, inserting on a strict ``<`` so that among
equal distances the lower slot stays ahead. That is the first k of the
(distance, slot) order, which is what the rounds take while valid slots
(distance < 1e30) remain. With m < k valid slots the rounds go on: every
slot then holds 1e30 (a padding slot's d2 + 1e30 rounds to 1e30 exactly, a
taken one is set to it), so each later round gives 1e30 and the lowest slot
holding it, the lowest of the taken slots and the padding slots. The one
pass holds the m taken slots and the lowest padding slots, so the rule is:
every place whose distance is 1e30 takes the lowest slot of the list (slot
0 where the valid slots come first, as ``gauge_geometry`` lays them out).
numpy's float32 subtract, product and add round to nearest, as the kernel's
``__f*_rn`` intrinsics do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2igan_tpu.ops import idw as jidw
from p2igan_tpu_torch.data.masks import create_mask_np
from p2igan_tpu_torch.ops import idw as tidw
from p2igan_tpu_torch.ops import idw_factored_kernel as K
from p2igan_tpu_torch.ops.idw import gauge_geometry

BIG = np.float32(1e30)
H = W = 32


def model_distances(qx, qy, gx, gy, pen):
    """d[p, g] = ((dx*dx) + (dy*dy)) + pen[g], each step rounded in float32."""
    dx = (qx[:, None] - gx[None, :]).astype(np.float32)
    dy = (qy[:, None] - gy[None, :]).astype(np.float32)
    return ((dx * dx + dy * dy).astype(np.float32) + pen[None, :]).astype(np.float32)


def model_one_pass(qx, qy, gx, gy, pen, k):
    """(gd2 (k, HW), gsel (k, HW)): one walk over the slots in ascending order,
    the k best kept sorted by a strict-``<`` insertion, then every place at
    1e30 given the lowest slot of the list."""
    d = model_distances(*(np.asarray(a, np.float32) for a in (qx, qy, gx, gy, pen)))
    hw, G = d.shape
    bd = np.full((hw, k), np.inf, np.float32)
    bi = np.zeros((hw, k), np.int32)
    for g in range(G):
        dg = d[:, g]
        # top down, so that place j reads place j - 1 before it changes
        for j in range(k - 1, -1, -1):
            up = dg < bd[:, j - 1] if j > 0 else np.zeros(hw, bool)
            here = ~up & (dg < bd[:, j])
            if j > 0:
                bd[:, j] = np.where(up, bd[:, j - 1], np.where(here, dg, bd[:, j]))
                bi[:, j] = np.where(up, bi[:, j - 1], np.where(here, g, bi[:, j]))
            else:
                bd[:, j] = np.where(here, dg, bd[:, j])
                bi[:, j] = np.where(here, g, bi[:, j])
    low = bi.min(axis=1, keepdims=True)
    bi = np.where(bd >= BIG, low, bi).astype(np.int32)
    return bd.T.copy(), bi.T.copy()


def _random(rng, n, h=H, w=W):
    flat = np.zeros((h * w,), np.float32)
    flat[rng.choice(h * w, n, replace=False)] = 1.0
    return flat.reshape(h, w)


def _grid(h=H, w=W):
    m = np.zeros((h, w), np.float32)
    m[2::4, 1::4] = 1.0  # a regular grid: distance ties everywhere
    return m


def _sti(rng, block, h=H, w=W):
    return create_mask_np((1, h, w, 1), rng, "sti", block_sizes=[block])[0, :, :, 0]


# (name, mask maker, slots, h, w)
CASES = [
    ("0 gauges", lambda rng: np.zeros((H, W), np.float32), 128, H, W),
    ("1 gauge", lambda rng: _random(rng, 1), 128, H, W),
    ("2 gauges", lambda rng: _random(rng, 2), 128, H, W),
    ("3 gauges", lambda rng: _random(rng, 3), 128, H, W),
    ("grid", lambda rng: _grid(), 128, H, W),
    ("random 79", lambda rng: _random(rng, 79), 128, H, W),
    ("sti block 10", lambda rng: _sti(rng, 10, 128, 128), 256, 128, 128),
    ("sti block 4", lambda rng: _sti(rng, 4), 256, H, W),
]


def _case(name, seed=0):
    _, make, slots, h, w = next(c for c in CASES if c[0] == name)
    return make(np.random.default_rng(seed)), slots


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [4, 3, 1])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_one_pass_model_is_the_plain_rounds_bitwise(name, k):
    mask, slots = _case(name)
    args = gauge_geometry(torch.from_numpy(mask), slots)[:5]
    gd2, gsel = model_one_pass(*(a.numpy() for a in args), k)
    rd2, rsel = K.gauge_topk_reference(*args, k=k)
    _same(gd2, rd2.numpy())
    _same(gsel, rsel.numpy())


@pytest.mark.parametrize("k", [4, 3, 1])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_one_pass_model_is_the_jax_selection_bitwise(name, k, monkeypatch):
    """Through both packages' ``factored_prepare_full``: the port's with the
    model in place of its top-k, JAX's un-jitted selection; both reorder each
    pixel's k places by slot with the same compare-swap network."""
    mask, slots = _case(name)

    def model_topk(qx, qy, gx, gy, penalty, k):
        return tuple(torch.from_numpy(a) for a in
                     model_one_pass(qx.numpy(), qy.numpy(), gx.numpy(), gy.numpy(),
                                    penalty.numpy(), k))

    monkeypatch.setattr(K, "gauge_topk", model_topk)
    got = tidw.factored_prepare_full(torch.from_numpy(mask), slots, k=k)
    with jax.disable_jit():
        want = jidw.factored_prepare_full(jnp.asarray(mask), slots, k=k, use_pallas=False)
    for g, w in zip(got, want):
        _same(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("valid", [(5,), (9, 2), (7, 3, 30), ()])
def test_one_pass_rule_when_valid_slots_do_not_come_first(valid):
    """Slots laid out by hand, the valid ones (penalty 0) among padding slots:
    a place at 1e30 takes the lowest of the taken and the padding slots, which
    is then not slot 0 of the valid ones alone, and the rule still is the
    rounds'."""
    rng = np.random.default_rng(len(valid))
    G, k = 40, 4
    q = np.linspace(0, 1, 16, dtype=np.float32)
    qx, qy = np.tile(q, 16), np.repeat(q, 16)
    gx = rng.random(G).astype(np.float32)
    gy = rng.random(G).astype(np.float32)
    pen = np.full(G, BIG, np.float32)
    pen[list(valid)] = 0.0
    args = [torch.from_numpy(a) for a in (qx, qy, gx, gy, pen)]
    gd2, gsel = model_one_pass(qx, qy, gx, gy, pen, k)
    rd2, rsel = K.gauge_topk_reference(*args, k=k)
    _same(gd2, rd2.numpy())
    _same(gsel, rsel.numpy())


def test_one_pass_model_batched_masks_equal_single_masks():
    """The batched plain version (one mask a sample, as the sti paths call it)
    mask by mask equals the model: a mixed batch of 0-3 gauges and full masks."""
    rng = np.random.default_rng(3)
    masks = np.stack([_random(rng, n) for n in (0, 1, 2, 3)] + [_sti(rng, 4), _grid()])
    args = gauge_geometry(torch.from_numpy(masks), 128)[:5]
    rd2, rsel = K.gauge_topk_reference(*args, k=4)
    for b in range(len(masks)):
        gd2, gsel = model_one_pass(args[0].numpy(), args[1].numpy(),
                                   *(a[b].numpy() for a in args[2:]), 4)
        _same(gd2, rd2[b].numpy())
        _same(gsel, rsel[b].numpy())
