"""A numpy model of the dense-field combine's walk (#7 ``combine_dense``,
``csrc/combine_dense.cu``), held bit for bit against its plain version.

The kernel gives a block 32 pixels (a warp's lanes, the last block's lanes
past HW dead) and ceil(D / span) warps: warp y fills rows y, y + Y, ... of
each of its pixels' distance tables (``distinct_frame_table``: d[j][s] =
min(sqrt(gd2[s] + vals[j]), 1e15)), and after the block's barrier walks the
query frames [y * span, (y + 1) * span) of its lane's pixel, the last warp
fewer where span does not divide D: the k rounds of first-min over the
frame's kf*k candidates read through the map (z, pruned frame) -> j, the
values from rows sel[z][fi] * k + s of cvals, acc += w_r * v_r round by
round, then / (w_sum + 1e-12). The model holds that the table is whole, that
every (z, pixel) is written exactly once, and that the result equals
``combine_dense_reference`` (every frame, no pruning, a sqrt for every
candidate) bit for bit, at spans that do not divide D, an HW that fills no
whole block, on tie-heavy sti grids, fewer gauges than k and no gauge.
numpy's float32 add, sqrt, division and product round to nearest, as the
kernel's ``__f*_rn`` intrinsics do.
"""

import functools

import numpy as np
import pytest
import torch

from p2igan_tpu_torch.ops import idw_factored_kernel as K
from p2igan_tpu_torch.ops.idw import factored_prepare
from test_torch_sti_select_model import _sti, model_distances, model_rounds

H, W = 17, 29  # HW = 493: the last block of 32 pixels has 13 live lanes
G = 128


def model_walk(gd2_t, cvals_t, k, span):
    """#7 as the kernel walks it: (D, HW) float32."""
    D, HW = cvals_t.shape[0] // k, gd2_t.shape[1]
    sel, vals, vmap, kf, nv, span = (v.numpy() if isinstance(v, torch.Tensor) else v
                                     for v in K.dense_plan(D, k, "cpu", span))
    lanes = K.DENSE_LANES
    warps = -(-D // span)
    blocks = -(-HW // lanes)
    p = np.arange(blocks * lanes)                      # every lane of every block
    live = p < HW
    g2 = np.zeros((p.size, k), np.float32)
    g2[live] = gd2_t.T
    table = np.full((p.size, nv, k), np.nan, np.float32)
    for y in range(warps):                             # each warp its rows
        rows = np.arange(y, nv, warps)
        table[:, rows, :] = model_distances(g2, vals[rows])
    assert not np.isnan(table).any()
    out = np.zeros((D, HW), np.float32)
    visits = np.zeros((D, HW), np.int64)
    for y in range(warps):
        for z in range(y * span, min(D, (y + 1) * span)):
            cand = table[live][:, vmap[z], :].reshape(HW, kf * k)
            c, w, denom = model_rounds(cand, k)
            v = cvals_t[sel[z][c // k] * k + c % k, np.arange(HW)[:, None]]
            acc = np.zeros(HW, np.float32)
            for r in range(k):
                acc = (acc + (w[:, r] * v[:, r]).astype(np.float32)).astype(np.float32)
            out[z] = (acc / denom).astype(np.float32)
            visits[z] += 1
    assert (visits == 1).all()
    return out


@functools.lru_cache(maxsize=None)
def case(kind, D, k):
    """(gd2_t (k, HW), cvals_t (D*k, HW), the plain version's output)."""
    rng = np.random.default_rng(sum(map(ord, kind)) + 10 * D + k)
    m = {"block4": lambda: _sti(rng, H, W, 4),
         "block1": lambda: _sti(rng, H, W, 1),
         "two": lambda: np.pad(np.eye(2, dtype=np.float32), ((5, H - 7), (3, W - 5))),
         "empty": lambda: np.zeros((H, W), np.float32)}[kind]()
    gd2, _ = factored_prepare(torch.from_numpy(m), G, k=k)
    gd2_t = gd2.t().contiguous()
    cvals_t = torch.from_numpy(rng.normal(size=(D * k, H * W)).astype(np.float32))
    want = K.combine_dense_reference(gd2_t, cvals_t, k).numpy()
    return gd2_t.numpy(), cvals_t.numpy(), want


@pytest.mark.parametrize("span", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", ["block4", "block1", "two", "empty"])
@pytest.mark.parametrize("D", [16, 5, 4, 1])
@pytest.mark.parametrize("k", [4, 3, 1])
def test_walk_model_is_the_plain_combine_bitwise(k, D, kind, span):
    gd2_t, cvals_t, want = case(kind, D, k)
    got = model_walk(gd2_t, cvals_t, k, span)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if kind == "empty":
        assert not got.any()


def test_the_grids_tie():
    """The sti grids do what they are for: pixels whose k-th and (k+1)-th
    candidate distances are equal floats, decided by the lowest index."""
    gd2_t, _, _ = case("block1", 16, 4)
    vals = K.distinct_frame_table(16, 4)[0].numpy()
    d = model_distances(gd2_t.T, vals).reshape(gd2_t.shape[1], -1)
    d.sort(axis=1)
    assert (d[:, 3] == d[:, 4]).sum() > 10


@pytest.mark.parametrize("D,k,span,want", [
    (16, 4, 1, 1), (16, 4, 2, 2), (5, 3, 4, 4), (32, 2, 1, 2), (64, 1, 1, 4)])
def test_dense_plan_keeps_a_block_within_its_warps(D, k, span, want):
    *_, nv, got = K.dense_plan(D, k, "cpu", span)
    assert got == want and -(-D // got) <= K.DENSE_MAX_WARPS
    assert nv == K.distinct_frame_table(D, k)[0].numel()


def test_dense_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="candidates exceed"):
        K.dense_plan(16, 8, "cpu")                  # kf*k = 72 beyond the taken mask
