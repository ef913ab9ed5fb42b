"""Numpy models of the index plans of ``csrc/enc0_conv.cu`` (#14) and
``csrc/decode_mask.cu`` (#11), held to what the kernels must do.

The kernels run only on a card; their plans (which block computes which
output, which ring slot holds which slice, which copy fills which float of a
slot, which element and mask entry a thread takes) are plain integer
arithmetic, mirrored here line by line from the CUDA sources and checked at
small and odd shapes. The kernels' values are checked on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

from p2igan_tpu_torch.ops.enc0_conv import shared_bytes

# -- #14: csrc/enc0_conv.cu ----------------------------------------------------

LANES, PX, TY, TH, PH, THREADS, STAGES, COL0 = 32, 4, 8, 16, 18, 256, 4, 4
TW = LANES * PX  # tile width: 4 pixels a thread, LANES columns apart


def cdiv(a, b):
    return -(-a // b)


def slot_geometry(cin):
    """``Slot<CIN>``: row pitch, chunks a row, chunks a slot, rounds, floats a
    row that are read (tile columns -1 .. 32)."""
    pitch = TW * cin + 8
    chunks = PH * (pitch // 4)
    return pitch, pitch // 4, chunks, cdiv(chunks, THREADS), (TW + 2) * cin


def enc0_launch(B, T, H, W, sms):
    """``launch``: tiles, frame spans and blocks of one call."""
    tiles_x, tiles_y = cdiv(W, TW), cdiv(H, TH)
    tiles = B * tiles_x * tiles_y
    want = sms // tiles
    splits_max = 1 if want < 1 else min(want, T)
    span = cdiv(T, splits_max)
    splits = cdiv(T, span)
    return tiles_x, tiles_y, splits, span, tiles * splits


def enc0_blocks(B, T, H, W, sms):
    """(b, h0, w0, t_lo, t_hi) of each block, as the kernel decodes blockIdx.x."""
    tiles_x, tiles_y, splits, span, blocks = enc0_launch(B, T, H, W, sms)
    for bid in range(blocks):
        part = bid % splits
        bid //= splits
        txi = bid % tiles_x
        bid //= tiles_x
        tyi = bid % tiles_y
        b = bid // tiles_y
        t_lo, t_hi = part * span, min(T, part * span + span)
        assert t_lo < t_hi  # the kernel has no guard for an empty span
        yield b, tyi * TH, txi * TW, t_lo, t_hi


WALK_CASES = [(1, 1, 16, 32), (3, 1, 16, 32), (2, 3, 37, 45), (1, 3, 128, 128),
              (2, 16, 21, 70), (8, 16, 128, 128), (1, 17, 128, 128), (2, 11, 96, 128),
              (3, 9, 40, 70), (1, 16, 128, 128), (4, 13, 128, 128)]


@pytest.mark.parametrize("B,T,H,W", WALK_CASES)
@pytest.mark.parametrize("sms", [132, 4])
def test_enc0_walk_covers_every_output_once(B, T, H, W, sms):
    count = np.zeros((B, T, H + TH, W + TW), np.int32)  # room for ragged tiles
    ty, tx, p = np.arange(TY), np.arange(LANES), np.arange(PX)
    cols = (tx[:, None] + LANES * p[None, :]).ravel()  # lane tx owns columns tx + 32 p
    for b, h0, w0, t_lo, t_hi in enc0_blocks(B, T, H, W, sms):
        rows = np.concatenate([h0 + ty, h0 + ty + TY])
        for t in range(t_lo, t_hi):
            count[b, t, rows[:, None], w0 + cols[None, :]] += 1
    assert (count[:, :, :H, :W] == 1).all()
    tiles = B * cdiv(W, TW) * cdiv(H, TH)
    _, _, splits, span, blocks = enc0_launch(B, T, H, W, sms)
    # the walk is split only when the tiles leave SMs without a block, into
    # no more spans than make up for it
    assert (splits > 1) == (sms // tiles >= 2 and T > 1)
    assert splits <= max(1, sms // tiles)
    assert blocks == tiles * splits and (splits - 1) * span < T <= splits * span


def ring_walk(T, t_lo, t_hi):
    """The ring of one block: yields (t, dt, content of the slot frame t reads
    as tap dt), where a slot holds a slice index or "zero"; asserts that no
    copy lands in a slot the frame in flight reads."""
    slots = [None] * STAGES
    pending = []

    def load(s):
        pending.append(((s + STAGES) & (STAGES - 1), s if 0 <= s < T else "zero"))

    for s in range(t_lo - 1, t_lo + 2):
        load(s)
    for t in range(t_lo, t_hi):
        for slot, content in pending:  # __pipeline_wait_prior(0), __syncthreads
            slots[slot] = content
        pending.clear()
        reading = {(t + dt - 1 + STAGES) & (STAGES - 1) for dt in range(3)}
        if t + 2 <= t_hi:
            load(t + 2)
            assert pending[-1][0] not in reading
        for dt in range(3):
            yield t, dt, slots[(t + dt - 1 + STAGES) & (STAGES - 1)]


@pytest.mark.parametrize("B,T,H,W", [(3, 1, 16, 32), (2, 3, 16, 32), (2, 16, 16, 32),
                                     (1, 16, 128, 128), (1, 17, 128, 128),
                                     (2, 11, 96, 128)])
def test_enc0_ring_holds_each_tap_slice_or_zeros(B, T, H, W):
    seen = np.zeros((B, T), np.int32)
    for b, h0, w0, t_lo, t_hi in enc0_blocks(B, T, H, W, 132):
        for t, dt, content in ring_walk(T, t_lo, t_hi):
            s = t + dt - 1
            assert content == (s if 0 <= s < T else "zero"), (t_lo, t_hi, t, dt)
            if dt == 1 and (h0, w0) == (0, 0):
                seen[b, t] += 1
    assert (seen == 1).all()


def plan_copies(cin, H, W, h0, w0):
    """``plan_copies`` for all 256 threads at once: (src, dst, in) arrays of
    shape (rounds, 256); ``c < kChunks`` folded into ``in``."""
    pitch, per_row, chunks, rounds, _ = slot_geometry(cin)
    c = np.arange(THREADS)[None, :] + THREADS * np.arange(rounds)[:, None]
    row, k = c // per_row, c % per_row
    h, g = h0 + row - 1, w0 * cin - COL0 + 4 * k
    inside = (c < chunks) & (h >= 0) & (h < H) & (g >= 0) & (g + 4 <= W * cin)
    return h * W * cin + g, row * pitch + 4 * k, inside, c < chunks


def slot_of_vec(plane, cin, H, W, h0, w0):
    """A slot filled by the 16-byte copies; (floats, times each was written)."""
    pitch, _, _, _, _ = slot_geometry(cin)
    slot = np.full(PH * pitch, np.nan, np.float32)
    writes = np.zeros(PH * pitch, np.int32)
    src, dst, inside, valid = plan_copies(cin, H, W, h0, w0)
    for s, d, i in zip(src[valid], dst[valid], inside[valid]):
        slot[d:d + 4] = plane[s:s + 4] if i else 0.0
        writes[d:d + 4] += 1
    return slot.reshape(PH, pitch), writes.reshape(PH, pitch)


def slot_of_scalar(plane, cin, H, W, h0, w0):
    """A slot filled by the 4-byte copies of the fallback path."""
    pitch, _, _, _, used = slot_geometry(cin)
    slot = np.full(PH * pitch, np.nan, np.float32)
    writes = np.zeros(PH * pitch, np.int32)
    e = np.arange(PH * used)  # every thread's e = tid, tid + 256, ...
    row, f = e // used, e % used
    h, g = h0 + row - 1, (w0 - 1) * cin + f
    inside = (h >= 0) & (h < H) & (g >= 0) & (g < W * cin)
    d = row * pitch + COL0 - cin + f
    slot[d] = np.where(inside, plane[np.where(inside, h * W * cin + g, 0)], 0.0)
    np.add.at(writes, d, 1)
    return slot.reshape(PH, pitch), writes.reshape(PH, pitch)


COPY_CASES = [(cin, H, W) for cin in (1, 2, 3, 4)
              for H, W in ((5, 4), (16, 32), (21, 44), (17, 64), (3, 70), (9, 33))]


@pytest.mark.parametrize("cin,H,W", COPY_CASES)
def test_enc0_copies_fill_each_haloed_tile_once(cin, H, W):
    rng = np.random.default_rng(cin * 1000 + H * 10 + W)
    x = rng.standard_normal((H, W, cin)).astype(np.float32) + 2.0  # no zeros inside
    padded = np.zeros((H + TH + 2, W + TW + 2, cin), np.float32)
    padded[1:H + 1, 1:W + 1] = x
    pitch = slot_geometry(cin)[0]
    read = COL0 - cin + np.arange((TW + 2) * cin)  # floats of tile columns -1 .. 32
    paths = [slot_of_scalar] + ([slot_of_vec] if W * cin % 4 == 0 else [])
    for fill in paths:
        for h0 in range(0, H, TH):
            for w0 in range(0, W, TW):
                slot, writes = fill(x.reshape(-1), cin, H, W, h0, w0)
                want = padded[h0:h0 + PH, w0:w0 + TW + 2].reshape(PH, -1)
                assert np.array_equal(slot[:, read], want), (fill.__name__, h0, w0)
                assert (writes[:, read] == 1).all(), (fill.__name__, h0, w0)
                if fill is slot_of_vec:  # every chunk of the slot written once
                    assert (writes == 1).all()
                assert (writes <= 1).all() and pitch % 4 == 0


def test_enc0_shared_bytes_is_the_kernel_layout():
    """``shared_bytes`` counts the weights and bias at 32-channel padding and
    the ring of ``Slot<CIN>``; at Cin 1-4 and the widths the models use, a
    block fits an SM."""
    for cin in (1, 2, 3, 4):
        pitch = slot_geometry(cin)[0]
        for cout in (8, 40, 64):
            pad = cdiv(cout, 32) * 32
            assert shared_bytes(cin, cout) == 4 * ((27 * cin + 1) * pad + STAGES * PH * pitch)
            assert shared_bytes(cin, cout) + 1024 <= 228 * 1024


# -- #11: csrc/decode_mask.cu --------------------------------------------------
#
# The kernel's plan (its device time is 0.62-0.74 of the bound, its
# call ahead of the elementwise chain's: PERF.md, #11): a grid-stride loop
# of items of 4 elements (a 4-byte load, two 16-byte stores) or of 1, and the
# frame-constant mask's row from the item index. The wrapper passes n, the
# plane (n for a full mask) and T (1 for a full mask).

def decode_vec4(n, plane, frames_ptr, mask_ptr, mask_bytes):
    """The wrapper's choice of the 4-wide path."""
    return (n % 4 == 0 and plane % 4 == 0 and frames_ptr % 4 == 0
            and mask_ptr % (16 if mask_bytes == 4 else 4) == 0)


def decode_cover(n, plane, T, vec4, frame_const, max_blocks=65535):
    """Every (element, mask entry) the launch's threads take, in the order of
    the kernel's grid-stride loop: counts over the elements and the mask index
    of each (``mask_index`` on the item, times the width, plus the lane)."""
    width = 4 if vec4 else 1
    items, plane_i = n // width, plane // width
    blocks = min(cdiv(items, THREADS), max_blocks)
    stride = blocks * THREADS
    count = np.zeros(n, np.int32)
    mask_at = np.full(n, -1, np.int64)
    for gtid in range(stride):
        i = np.arange(gtid, items, stride)
        m = (i // (T * plane_i)) * plane_i + i % plane_i if frame_const else i
        for q in range(width):
            np.add.at(count, i * width + q, 1)
            mask_at[i * width + q] = m * width + q
    return count, mask_at


@pytest.mark.parametrize("B,T,plane", [(2, 3, 16 * 5), (3, 2, 4 * 7 + 4), (2, 3, 35),
                                       (1, 2, 16 * 30), (12, 16, 4 * 25 + 4), (4, 5, 1)])
@pytest.mark.parametrize("frame_const", [True, False])
@pytest.mark.parametrize("max_blocks", [65535, 1])
def test_decode_paths_cover_every_element_once(B, T, plane, frame_const, max_blocks):
    """Each element once, on the 4-wide and the 1-wide path; the mask entry
    of element (b, t, offset) is b * plane + offset for a frame-constant mask
    (its own index for a full one), with the grid capped to one block too."""
    n = B * T * plane
    b, off = np.divmod(np.arange(n), T * plane)
    want = b * plane + off % plane if frame_const else np.arange(n)
    # the wrapper's arguments: a full mask is one plane of n, T = 1
    args = (plane, T) if frame_const else (n, 1)
    for vec4 in (True, False):
        if vec4 and not decode_vec4(n, args[0], 0, 0, 1):
            continue
        count, mask_at = decode_cover(n, *args, vec4, frame_const, max_blocks)
        assert (count == 1).all(), vec4
        assert np.array_equal(mask_at, want), vec4


def test_decode_vec4_choice():
    """The 4-wide path for planes of 16 k and 4 k + 4 from aligned pointers;
    the 1-wide path for odd planes, a frame pointer 1 byte off, or a float32
    mask off 16 bytes; a frame pointer 4 bytes off keeps the 4-wide path."""
    assert decode_vec4(12 * 16 * 16384, 16384, 0x1000, 0x2000, 1)
    assert decode_vec4(3 * 5 * 60, 60, 0x1000, 0x2000, 4)
    assert not decode_vec4(2 * 3 * 35, 35, 0x1000, 0x2000, 1)
    assert decode_vec4(6 * 256, 256, 0x1004, 0x2000, 1)
    assert not decode_vec4(6 * 256, 256, 0x1001, 0x2000, 1)
    assert not decode_vec4(6 * 256, 256, 0x1000, 0x2004, 4)
