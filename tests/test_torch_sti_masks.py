"""The port's torch mask generators (functions of a ``torch.Generator``).

Their random streams are PyTorch's, not JAX's or numpy's, so no mask equals
its counterpart's; they are held to the invariants ``tests/test_masks.py``
holds the JAX package's generators to.
"""

import numpy as np
import pytest
import torch

from p2igan_tpu.data import masks as JM
from p2igan_tpu_torch.data import masks as M


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("H,W,bs", [(16, 16, 4), (32, 32, 8), (10, 14, 4), (128, 128, 10)])
def test_sti_one_pixel_per_block(H, W, bs):
    """Exactly one observed pixel in every block, edge blocks (smaller)
    included; frame-constant; float32 0/1."""
    m = M.sti_mask(_gen(), 4, H, W, 1, block_size=bs)
    assert m.shape == (4, H, W, 1) and m.dtype == torch.float32
    assert set(np.unique(m.numpy())) <= {0.0, 1.0}
    mat = m[0, :, :, 0].numpy()
    for h0 in range(0, H, bs):
        for w0 in range(0, W, bs):
            assert mat[h0:h0 + bs, w0:w0 + bs].sum() == 1
    assert (m == m[0:1]).all()


def test_sti_positions_vary_within_blocks_and_between_draws():
    gen = _gen(1)
    a = M.sti_mask(gen, 1, 64, 64, block_size=4)
    b = M.sti_mask(gen, 1, 64, 64, block_size=4)
    assert not torch.equal(a, b)
    ys, xs = np.nonzero(a[0, :, :, 0].numpy())
    assert len(set(ys % 4)) == 4 and len(set(xs % 4)) == 4  # every offset drawn


@pytest.mark.parametrize("interval", [(2, 5), (3,)])
def test_fi(interval):
    m = M.fi_mask(_gen(2), 12, 8, 8, 1, interval=interval)
    assert m.shape == (12, 8, 8, 1)
    per_frame = m.reshape(12, -1)
    assert ((per_frame == 0).all(1) | (per_frame == 1).all(1)).all()
    on = np.nonzero(per_frame[:, 0].numpy())[0]
    assert on[0] == 0 and (np.diff(on)[0] - 1) in interval
    assert len(set(np.diff(on))) == 1


def test_nowcasting():
    m = M.nowcasting_mask(8, 4, 4, 1, keep=3)
    assert (m[:3] == 1).all() and (m[3:] == 0).all()
    assert M.create_mask(_gen(), (8, 4, 4, 1), "nowcasting", keep=3).equal(m)


def test_stin_keeps_frames_and_is_sti_elsewhere():
    m = M.stin_mask(_gen(3), 8, 16, 16, 1, block_size=4, keep=2)
    assert (m[:2] == 1).all()
    assert (m[2:] == m[2:3]).all()
    assert m[2].sum() == 16
    assert (M.stin_mask(_gen(), 4, 16, 16, keep=4) == 1).all()  # keep >= T


def test_stis_broadcasts_the_fixed_mask():
    mat = torch.zeros(8, 6)
    mat[2, 3] = mat[5, 1] = 1
    m = M.create_mask(_gen(), (5, 8, 6, 2), "stis", mask_matrix=mat)
    assert m.shape == (5, 8, 6, 2) and m.dtype == torch.float32
    assert (m == mat[None, :, :, None]).all()
    with pytest.raises(ValueError, match="mask_matrix"):
        M.create_mask(_gen(), (5, 8, 6, 2), "stis")
    with pytest.raises(ValueError, match="Invalid mask type"):
        M.create_mask(_gen(), (5, 8, 6, 2), "nope")


@pytest.mark.parametrize("mask_type", ["sti", "stin", "fi"])
def test_create_mask_is_deterministic_under_one_seed(mask_type):
    kw = dict(block_sizes=[4, 8], keep=2, interval=[1, 2, 3])
    a = M.create_mask(_gen(7), (6, 16, 16, 1), mask_type, **kw)
    b = M.create_mask(_gen(7), (6, 16, 16, 1), mask_type, **kw)
    assert torch.equal(a, b)
    others = [M.create_mask(_gen(s), (6, 16, 16, 1), mask_type, **kw) for s in range(8)]
    assert any(not torch.equal(a, o) for o in others)


def test_dispatcher_draws_a_block_size():
    """Counterpart of tests/test_masks.py::test_jax_dispatcher_multi_blocksize:
    16 or 4 observed pixels a frame at 16x16; both sizes come up."""
    counts = {int(M.create_mask(_gen(s), (4, 16, 16, 1), "sti",
                                block_sizes=[4, 8])[0].sum()) for s in range(16)}
    assert counts == {16, 4}


@pytest.mark.parametrize("H,W,bs", [(128, 128, 10), (128, 128, 4), (16, 16, 4),
                                    (10, 14, 4), (32, 32, 8), (7, 5, 8)])
def test_numpy_sti_draw_is_the_jax_packages_stream(H, W, bs):
    """The loaders' numpy sti mask is drawn in one vectorized call; it equals
    the JAX package's per-cell loop mask for mask, and leaves the generator in
    the same state (what is drawn after it is the same too), so both packages'
    loaders ship the same batches under one seed."""
    for seed in range(20):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(M._sti_matrix_np(a, H, W, bs),
                                      JM._sti_matrix_np(b, H, W, bs))
        assert a.bit_generator.state == b.bit_generator.state
    for mask_type in ("sti", "stin"):
        a, b = np.random.default_rng(3), np.random.default_rng(3)
        kw = dict(mask_type=mask_type, block_sizes=[bs, 2 * bs], keep=1)
        np.testing.assert_array_equal(M.create_mask_np((3, H, W, 1), a, **kw),
                                      JM.create_mask_np((3, H, W, 1), b, **kw))
