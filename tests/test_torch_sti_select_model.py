"""A numpy model of the per-sample combines' selection (#5 ``combine_table``,
#6 ``combine_table_bwd``; ``csrc/idw_select.cuh``: ``distance_table``,
``select_from_table``), held bit for bit against the plain versions.

The pruned frames' squared z-distances take only nv distinct values over all
(z, frame) (``distinct_frame_table``: 13 at D=16, k=4). The kernels compute
each pixel's nv*k candidate distances d[j][s] = min(sqrt(gd2[s] + vals[j]),
1e15) once and run every query frame's k rounds of first-min over its kf*k
candidates through the map (z, pruned frame) -> j. The same float inputs give
the same sqrt bits, so this must equal, bit for bit, both the plain version
(``combine_table_reference``: every frame, no pruning, a sqrt for every
candidate) and a per-candidate brute force over the pruned frames. The masks
are tie-heavy sti grids (blocks 10, 4 and 1), fewer gauges than k, no gauge,
and a case whose slots tie at the rounded sqrt while their squared distances
differ (so that the slots do not ascend in gd2 and the tie comes apart once
fd2 is added: a merge of per-frame lists assumed ascending would go wrong
there, the full first-min does not). numpy's float32 add, sqrt, division and
product round to nearest, as the kernels' ``__f*_rn`` intrinsics do.
"""

import numpy as np
import pytest
import torch

from p2igan_tpu_torch.data.masks import create_mask_np
from p2igan_tpu_torch.ops import idw_factored_kernel as K
from p2igan_tpu_torch.ops.idw import factored_prepare_full
from test_torch_fixed_sum import fixed_scatter

BIGD = np.float32(1e15)
TAU = np.float32(0.05)
G = 128


def model_distances(g2, vals):
    """d[p, j, s] = min(sqrt(g2[p, s] + vals[j]), 1e15), once a pixel; NaN caps."""
    with np.errstate(invalid="ignore"):
        d = np.sqrt((g2[:, None, :] + vals[None, :, None]).astype(np.float32))
    return np.where(d < BIGD, d, BIGD).astype(np.float32)


def model_rounds(cand, k):
    """k rounds of first-min over (HW, kf*k) candidate distances (lowest flat
    candidate on ties; a taken candidate counts as 1e15). Returns the chosen
    candidates, the weights (HW, k) and the denominator w_sum + 1e-12."""
    hw = cand.shape[0]
    rows = np.arange(hw)
    taken = np.zeros(cand.shape, bool)
    w_sum = np.zeros(hw, np.float32)
    picks, ws = [], []
    for _ in range(k):
        cd = np.where(taken, BIGD, cand)
        c = np.argmin(cd, axis=1)                # first occurrence: lowest candidate
        best = cd[rows, c]
        taken[rows, c] = True
        invd = np.float32(1.0) / (best + TAU).astype(np.float32)
        w = np.where(best < BIGD, (invd * invd).astype(np.float32), np.float32(0.0))
        w_sum = (w_sum + w).astype(np.float32)
        picks.append(c)
        ws.append(w.astype(np.float32))
    denom = (w_sum + np.float32(1e-12)).astype(np.float32)
    return np.stack(picks, 1), np.stack(ws, 1), denom


def model_selection(gd2_t, gsel_t, D, k, through_map=True):
    """(targets frame * G + slot, w_norm, w, denom), each (D, HW, k) (denom (D,
    HW)), of one sample: through the distance table and the map, or (brute
    force) a sqrt for every pruned candidate of every z."""
    g2, gs = gd2_t.T.astype(np.float32), gsel_t.T
    sel, fd2 = (t.numpy() for t in K.pruned_frame_table(D, k))
    vals, vmap = (t.numpy() for t in K.distinct_frame_table(D, k))
    kf = sel.shape[1]
    hw = g2.shape[0]
    dist = model_distances(g2, vals)
    offs, wns, wrs, dens = [], [], [], []
    for z in range(D):
        if through_map:
            cand = dist[:, vmap[z], :].reshape(hw, kf * k)
        else:
            with np.errstate(invalid="ignore"):
                cand = np.sqrt((np.tile(g2, (1, kf)) + fd2[z][None, :]).astype(np.float32))
            cand = np.where(cand < BIGD, cand, BIGD).astype(np.float32)
        c, w, denom = model_rounds(cand, k)
        offs.append(sel[z][c // k] * G + np.take_along_axis(gs, c % k, axis=1))
        wns.append((w / denom[:, None]).astype(np.float32))
        wrs.append(w)
        dens.append(denom)
    return np.stack(offs), np.stack(wns), np.stack(wrs), np.stack(dens)


def model_combine(gd2_t, gsel_t, table, k):
    """#5 of one sample: acc += w_r * v_r round by round, then / denom."""
    D = table.shape[0]
    off, _, w, denom = model_selection(gd2_t, gsel_t, D, k)
    v = table.reshape(-1)[off]
    acc = np.zeros(denom.shape, np.float32)
    for r in range(k):
        acc = (acc + (w[..., r] * v[..., r]).astype(np.float32)).astype(np.float32)
    return (acc / denom).astype(np.float32)


def _sti(rng, H, W, block):
    return create_mask_np((1, H, W, 1), rng, "sti", block_sizes=[block])[0, :, :, 0]


def tied_gauges(k, hw=48):
    """gd2/gsel (1, k, hw) whose first two slots tie at the rounded sqrt with
    the larger squared distance first (the lower slot id wins the tie), so
    gd2 does not ascend in the slot, and for which the tie comes apart after
    + fd2 at D=16; the other slots lie farther out."""
    vals = K.distinct_frame_table(16, 4)[0].numpy()
    rng = np.random.default_rng(3)
    rows = []
    while len(rows) < hw:
        a = np.float32(rng.uniform(1e-3, 2e-2))
        b = np.nextafter(a, np.float32(1), dtype=np.float32)
        if np.sqrt(a) != np.sqrt(b):
            continue
        apart = np.sqrt((a + vals).astype(np.float32)) != np.sqrt((b + vals).astype(np.float32))
        if apart.any():
            far = np.sort(rng.uniform(5e-2, 1e-1, k - 2).astype(np.float32))
            rows.append(np.concatenate([[b, a], far])[:k])
    gd2 = np.stack(rows, 1).astype(np.float32)[None]
    gsel = np.broadcast_to(np.arange(k, dtype=np.int32)[:, None], (k, hw))[None].copy()
    return torch.from_numpy(gd2), torch.from_numpy(gsel)


def case_inputs(kind, k):
    """(gd2_t, gsel_t) (1, k, HW) of one mask kind, on the CPU path."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "tie":
        return tied_gauges(k)
    m = {"block10": lambda: _sti(rng, 40, 30, 10),
         "block4": lambda: _sti(rng, 24, 20, 4),
         "block1": lambda: _sti(rng, 12, 10, 1),
         "two": lambda: np.pad(np.eye(2, dtype=np.float32), ((5, 13), (3, 15))),
         "empty": lambda: np.zeros((16, 20), np.float32)}[kind]()
    gd2, gsel, _ = factored_prepare_full(torch.from_numpy(m)[None], G, k=k)
    return gd2.transpose(1, 2).contiguous(), gsel.transpose(1, 2).contiguous()


KINDS = ["block10", "block4", "block1", "two", "empty", "tie"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("D", [16, 5, 4, 1])
@pytest.mark.parametrize("k", [4, 3])
def test_selection_model_is_the_plain_combine_bitwise(kind, D, k):
    gd2_t, gsel_t = case_inputs(kind, k)
    rng = np.random.default_rng(D * 10 + k)
    table = rng.normal(size=(1, D, G)).astype(np.float32)
    want = K.combine_table_reference(gd2_t, gsel_t, torch.from_numpy(table), k)[0].numpy()
    got = model_combine(gd2_t[0].numpy(), gsel_t[0].numpy(), table[0], k)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    mapped = model_selection(gd2_t[0].numpy(), gsel_t[0].numpy(), D, k)
    brute = model_selection(gd2_t[0].numpy(), gsel_t[0].numpy(), D, k, through_map=False)
    for a, b in zip(mapped, brute):
        assert np.array_equal(a, b)
    if kind == "empty":
        assert not got.any()


def test_the_tie_comes_apart_and_slots_do_not_ascend():
    """The "tie" case does what it is for: gd2 descends between the two tied
    slots, and adding some fd2 value separates their distances."""
    gd2_t, _ = tied_gauges(4)
    g2 = gd2_t[0].numpy()
    assert (g2[0] > g2[1]).all() and (np.sqrt(g2[0]) == np.sqrt(g2[1])).all()
    vals = K.distinct_frame_table(16, 4)[0].numpy()
    d = model_distances(g2.T, vals)
    assert (d[:, :, 0] != d[:, :, 1]).any(axis=1).all()


@pytest.mark.parametrize("D", [1, 2, 4, 5, 8, 16, 32, 64])
@pytest.mark.parametrize("k", [1, 3, 4, 8])
def test_distinct_table_is_the_pruned_table(D, k):
    """vals ascend without repeats, and vals[vmap] repeated over the k slots is
    ``pruned_frame_table``'s fd2 bit for bit."""
    sel, fd2 = K.pruned_frame_table(D, k)
    vals, vmap = K.distinct_frame_table(D, k)
    assert vals.dtype == torch.float32 and vmap.dtype == torch.int32
    assert vmap.shape == sel.shape
    assert bool((vals[1:] > vals[:-1]).all())
    rebuilt = vals[vmap.long()].repeat_interleave(k, dim=1)
    assert torch.equal(rebuilt.view(torch.int32), fd2.view(torch.int32))
    if (D, k) == (16, 4):
        assert vals.numel() == 13


@pytest.mark.parametrize("D,k,tile,match", [
    (16, 8, 0, "candidates exceed"),               # kf*k = 72 beyond the taken mask
    (16, 4, 210 * 1024, "bytes of shared memory"),  # the tile beside 52 distances a pixel
])
def test_sample_table_refuses_what_a_block_cannot_hold(D, k, tile, match):
    with pytest.raises(ValueError, match=match):
        K.sample_table("combine_table", D, k, "cpu", tile)
    assert K.sample_table("combine_table", 16, 4, "cpu")[5] == 13
    # without the tables a pixel, the backward's largest shipped tile fits
    assert K.sample_table("combine_table_bwd", 16, 4, "cpu", 8 * 16 * 1152, table=False)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("D,k", [(16, 4), (5, 3)])
def test_fixed_point_backward_model(kind, D, k):
    """#6's exact arithmetic: the model's terms w_norm * g through
    ``fixed_scatter`` equal ``combine_table_bwd_fixed_reference`` (the plain
    selection's terms, summed in PyTorch) bit for bit, and that stays within
    1e-5 x max|plain| of the plain backward (float32 sums)."""
    gd2_t, gsel_t = case_inputs(kind, k)
    hw = gd2_t.shape[2]
    g = np.random.default_rng(D + k).normal(size=(1, D, hw)).astype(np.float32)
    off, wn, _, _ = model_selection(gd2_t[0].numpy(), gsel_t[0].numpy(), D, k)
    gb = np.broadcast_to(g[0][:, :, None], wn.shape)
    want = fixed_scatter(wn.ravel(), gb.ravel(), off.ravel(), D * G, D * hw)
    got = K.combine_table_bwd_fixed_reference(gd2_t, gsel_t, torch.from_numpy(g), G, k)
    assert np.array_equal(got[0].numpy().ravel().view(np.int32), want.view(np.int32))
    plain = K.combine_table_bwd_reference(gd2_t, gsel_t, torch.from_numpy(g), G, k)
    assert float((got - plain).abs().max()) <= 1e-5 * max(float(plain.abs().max()), 1e-30)
