"""The cell search of the generic IDW k-NN (kernel #9, ``csrc/idw_knn_cells.cu``).

The card sorts a sample's points into cells and lets each query visit only the
cells whose lower bound is not strictly above its k-th distance. Here, on the
CPU:

* the plain cell build (:func:`cell_build_reference`, which ``chip_smoke.py``
  holds the card's build against) is checked against a per-point numpy
  statement of the same rules;
* a CPU model of the kernel's search (the same tiles, cells, block and query
  lower bounds with the kernel's rounded operations, bands of growing bound,
  the lexicographic entry test, the invalid set last in index order) is held
  **equal** to the brute-force plain version ``_select_chunks``: distances and
  indices, bit for bit, on adversarial inputs.

No tolerance anywhere: the search is exact by construction, so any
difference is a fault.
"""

import numpy as np
import pytest
import torch

from p2igan_tpu_torch.ops import idw_kernel as IK
from p2igan_tpu_torch.ops.idw import _sqrt_rn, extract_points

TILE = 16          # csrc/idw_knn_cells.cu kTileX, kTileY
STAGE = 1024       # kStage: the invalid set's chunk
INT_MAX = 2 ** 31 - 1


def _f32(v):
    return np.float32(v)


def _gap(q_lo, q_hi, b_lo, b_hi):
    return torch.where(b_lo > q_hi, b_lo - q_hi,
                       torch.where(q_lo > b_hi, q_lo - b_hi, torch.zeros_like(q_lo)))


def _box_bound(q_lo, q_hi, lo, hi):
    """knn_box_bound: float32 round-to-nearest in knn_distance's order."""
    g = [_gap(q_lo[..., a], q_hi[..., a], lo[..., a], hi[..., a]) for a in range(3)]
    return _sqrt_rn(((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]) + lo[..., 3])


def _distance(q, p):
    """knn_distance of queries q (n, 3) to points p (m, 4): (n, m)."""
    dx, dy, dz = (q[:, a:a + 1] - p[None, :, a] for a in range(3))
    return _sqrt_rn(((dx * dx + dy * dy) + dz * dz) + p[None, :, 3])


def _merge(ld, li, d, i, k):
    """The k lexicographically least (d, index) of a list and candidates."""
    ad = torch.cat([ld, d], 1)
    ai = torch.cat([li, i.expand(d.shape[0], -1)], 1)
    o = torch.argsort(ai, dim=1, stable=True)
    ad, ai = ad.gather(1, o), ai.gather(1, o)
    o = torch.argsort(ad, dim=1, stable=True)[:, :k]
    return ad.gather(1, o), ai.gather(1, o)


def search_model(pts4, out_shape, k, stats=None):
    """(d (B, Q, k), idx (B, Q, k)) by the kernel's search, sample by sample and
    tile by tile (16 x 16 queries of one frame)."""
    D, H, W = out_shape
    B = pts4.shape[0]
    dims = IK.cell_dims(D, H, W)
    C = dims[0] * dims[1] * dims[2] + 1
    count, start, order, lo, hi = IK.cell_build_reference(pts4, dims)
    lx, ly, lz = IK._grid_axes(D, H, W, "cpu")
    delta = _f32(0.25) / _f32(dims[2])
    inf = float("inf")
    d_all = torch.empty((B, D * H * W, k))
    i_all = torch.empty((B, D * H * W, k), dtype=torch.int64)
    for b in range(B):
        spts = pts4[b][order[b].long()]
        sidx = order[b].long()
        nonempty = count[b, :C - 1] > 0
        for z in range(D):
            for y0 in range(0, H, TILE):
                for x0 in range(0, W, TILE):
                    ys = torch.arange(y0, min(H, y0 + TILE))
                    xs = torch.arange(x0, min(W, x0 + TILE))
                    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
                    q = torch.stack([lx[gx.reshape(-1)], ly[gy.reshape(-1)],
                                     lz[z].expand(gx.numel())], 1)
                    rows = (z * H + gy.reshape(-1)) * W + gx.reshape(-1)
                    ld = torch.full((q.shape[0], k), inf)
                    li = torch.full((q.shape[0], k), INT_MAX, dtype=torch.int64)
                    lbb = _box_bound(q.amin(0), q.amax(0), lo[b, :C - 1], hi[b, :C - 1])
                    lbb = torch.where(nonempty, lbb, inf)
                    done = -inf
                    while True:
                        wmax = float(ld[:, k - 1].max())
                        rest = lbb[lbb > done]
                        umin = float(rest.min()) if rest.numel() else inf
                        if umin == inf or umin > wmax:
                            break
                        T = min(_f32(wmax), _f32(umin) + delta)
                        for c in torch.nonzero((lbb > done) & (lbb <= T)).flatten().tolist():
                            if float(lbb[c]) > float(ld[:, k - 1].max()):
                                continue  # dropped by the block
                            need = _box_bound(q, q, lo[b, c], hi[b, c]) <= ld[:, k - 1]
                            if not bool(need.any()):
                                continue
                            s, n = int(start[b, c]), int(count[b, c])
                            if stats is not None:
                                stats["pairs"] += int(need.sum()) * n
                            ld[need], li[need] = _merge(
                                ld[need], li[need], _distance(q[need], spts[s:s + n]),
                                sidx[None, s:s + n], k)
                        done = float(T)
                    s, n = int(start[b, C - 1]), int(count[b, C - 1])
                    lb_inv = _box_bound(q, q, lo[b, C - 1], hi[b, C - 1])
                    for base in range(s, s + n, STAGE):
                        m = min(STAGE, s + n - base)
                        first = int(sidx[base])
                        wd, wi = ld[:, k - 1], li[:, k - 1]
                        need = ~((lb_inv > wd) | ((lb_inv == wd) & (first > wi)))
                        if not bool(need.any()):
                            break
                        ld[need], li[need] = _merge(
                            ld[need], li[need], _distance(q[need], spts[base:base + m]),
                            sidx[None, base:base + m], k)
                    d_all[b, rows], i_all[b, rows] = ld, li
    return d_all, i_all


def brute_force(pts4, out_shape, k):
    grid = IK._grid(*out_shape, "cpu")
    d, i = [], []
    for b in range(pts4.shape[0]):
        parts = list(IK._select_chunks(pts4[b], grid, k))
        d.append(torch.cat([p[2] for p in parts]))
        i.append(torch.cat([p[3] for p in parts]))
    return torch.stack(d), torch.stack(i)


def _lattice(mask, P):
    """prep_points of the observed voxels of (B, D, H, W) masks, budget P."""
    m = torch.from_numpy(mask.astype(np.float32))
    pts, vals, valid = extract_points(m, m, P)
    return IK.prep_points(pts, vals, valid)[0]


def _points(rows, n_valid=None):
    """prep_points of (B, P, 3) coordinates, the first n_valid slots valid."""
    pts = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32))
    B, P, _ = pts.shape
    valid = torch.arange(P)[None].expand(B, -1) < (P if n_valid is None else n_valid)
    return IK.prep_points(pts, torch.zeros(B, P), valid)[0]


SHAPE = (4, 24, 24)


def _case(name):
    rng = np.random.default_rng(7)
    D, H, W = SHAPE
    if name == "z ties":       # frames 0 and 2 dense: frame 1 sees exact +-z ties
        mask = np.zeros((1, D, H, W))
        mask[:, [0, 2]] = 1.0
        return _lattice(mask, 1200)
    if name == "xy ties":      # every other pixel of every frame: four-way ties
        mask = np.zeros((1, D, H, W))
        mask[:, :, ::2, ::2] = 1.0
        return _lattice(mask, 640)
    if name == "fi-like":      # fi's pattern on a small grid: dense frames 0 and 3
        mask = np.zeros((2, D, H, W))
        mask[0, [0, 3]] = 1.0
        mask[1, 1] = 1.0
        mask[1, 3, ::5, ::3] = 1.0
        return _lattice(mask, 1300)
    if name == "2 valid":
        return _points(rng.random((2, 300, 3)), n_valid=2)
    if name == "empty":
        return _points(rng.random((1, 300, 3)), n_valid=0)
    if name == "one cell":     # every point inside one cell
        return _points(0.3 + 0.01 * rng.random((1, 400, 3)))
    if name == "outside [0, 1]":
        return _points(rng.random((2, 500, 3)) * 2.0 - 0.5)
    if name == "duplicates":   # each coordinate three times, at different indices
        base = rng.random((1, 100, 3))
        return _points(np.concatenate([base, base[:, ::-1], base], axis=1))
    if name == "rounded tie":
        # query (x 15, y 12, z 1) has three near points and, 4th, a tie of two
        # at one float32 distance: point 1 in its own cell (visited first) and
        # point 0 alone in the next cell along x. Point 0's exact distance is
        # above the rounded one, so only a bound rounded as knn_distance rounds
        # lets its cell in, and the lower index wins the tie as in the brute
        # force; a bound taken more exactly (in float64) drops it.
        lx, ly, lz = IK._grid_axes(*SHAPE, "cpu")
        q = np.array([lx[15], ly[12], lz[1]], np.float32)
        by = np.float32(0.52305317)
        rows = [[np.float32(0.6679461), by, q[2]], [np.float32(0.6364018), by, q[2]],
                q + [0.001, 0, 0], q + [0, 0.002, 0], q + [-0.003, 0, 0]]
        return _points(np.array(rows, np.float32)[None])
    raise KeyError(name)


CASES = ["z ties", "xy ties", "fi-like", "2 valid", "empty", "one cell",
         "outside [0, 1]", "duplicates", "rounded tie"]


@pytest.mark.parametrize("name", CASES)
def test_search_model_equals_brute_force(name):
    """The kernel's search, modelled on the CPU, selects exactly what the
    brute-force plain version selects: distances bitwise and indices equal
    (so out, sel_idx and w_norm follow bit for bit)."""
    pts4 = _case(name)
    stats = {"pairs": 0}
    d, i = search_model(pts4, SHAPE, 4, stats)
    want_d, want_i = brute_force(pts4, SHAPE, 4)
    assert torch.equal(i, want_i)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))
    if name in ("z ties", "xy ties"):  # the lattice prunes: far fewer pairs
        Q = SHAPE[0] * SHAPE[1] * SHAPE[2]
        assert stats["pairs"] < 0.25 * Q * pts4.shape[1]


def test_search_model_k_and_non_square_grid():
    """k = 1 and k = 8 (the kernel's limits) on a grid whose tiles and cells
    do not divide it, with random points and the lattice together."""
    shape = (3, 19, 37)
    rng = np.random.default_rng(3)
    mask = (rng.random((1,) + shape) < 0.3).astype(np.float32)
    pts4 = torch.cat([_lattice(mask, 700), _points(rng.random((1, 700, 3)))])
    for k in (1, 8):
        d, i = search_model(pts4, shape, k)
        want_d, want_i = brute_force(pts4, shape, k)
        assert torch.equal(i, want_i)
        assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))


def _cell_numpy(p, dims):
    """A slot's cell, one point at a time."""
    CZ, CY, CX = dims
    if p[3] != 0:
        return CZ * CY * CX

    def axis(v, n):
        f = np.floor(np.float32(v) * np.float32(n))
        return int(min(max(f, 0.0), n - 1)) if not np.isnan(f) else 0

    return (axis(p[2], CZ) * CY + axis(p[1], CY)) * CX + axis(p[0], CX)


@pytest.mark.parametrize("name", ["fi-like", "2 valid", "outside [0, 1]", "one cell"])
def test_cell_build_reference(name):
    """Counts, starts, the order (a permutation, ascending within a cell),
    member cells and tight boxes with the least penalty, against a per-point
    numpy statement of the rules."""
    pts4 = _case(name)
    dims = IK.cell_dims(*SHAPE)
    C = dims[0] * dims[1] * dims[2] + 1
    count, start, order, lo, hi = IK.cell_build_reference(pts4, dims)
    B, Pp, _ = pts4.shape
    assert count.shape == start.shape == (B, C) and order.shape == (B, Pp)
    for b in range(B):
        p = pts4[b].numpy()
        cells = np.array([_cell_numpy(row, dims) for row in p])
        want_count = np.bincount(cells, minlength=C)
        assert np.array_equal(count[b].numpy(), want_count)
        assert np.array_equal(start[b].numpy(), np.cumsum(want_count) - want_count)
        o = order[b].numpy()
        assert np.array_equal(np.sort(o), np.arange(Pp))
        for c in range(C):
            members = o[start[b, c]:start[b, c] + count[b, c]]
            assert np.all(cells[members] == c) and np.all(np.diff(members) > 0)
            if len(members):
                assert np.array_equal(lo[b, c].numpy(), p[members].min(0))
                assert np.array_equal(hi[b, c, :3].numpy(), p[members, :3].max(0))
            else:
                assert np.all(np.isinf(lo[b, c].numpy()))
        assert int(count[b, C - 1]) == int((p[:, 3] != 0).sum())


def test_cell_dims():
    assert IK.cell_dims(16, 128, 128) == (16, 16, 16)
    assert IK.cell_dims(4, 24, 24) == (4, 3, 3)
    assert IK.cell_dims(16, 256, 256) == (16, 16, 16)
    for shape in [(64, 512, 512), (200, 16, 16), (1, 1, 1)]:
        CZ, CY, CX = IK.cell_dims(*shape)
        assert CZ * CY * CX <= IK.MAX_CELLS


def test_cpu_tensors_take_the_plain_build():
    pts4 = _case("2 valid")
    dims = IK.cell_dims(*SHAPE)
    for a, b in zip(IK.idw_cell_build(pts4, dims), IK.cell_build_reference(pts4, dims)):
        assert torch.equal(a, b)
