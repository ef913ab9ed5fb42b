"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``; each test skips without a GPU. The repository's conftest
imports jax, which the GPU machine lacks, so run these there with

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from p2igan_tpu_torch.ops import idw_factored_kernel as K
from p2igan_tpu_torch.ops.decode_mask import (decode_normalize_mask,
                                              decode_normalize_mask_reference)
from p2igan_tpu_torch.ops.idw import factored_prepare_full, gauge_geometry
from p2igan_tpu_torch.ops.pool_dup import (maxpool2_duplicate,
                                           maxpool2_duplicate_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mask(kind, H, W, rng):
    m = np.zeros((H, W), np.float32)
    if kind == "grid":
        m[2::4, 1::4] = 1.0
    elif kind == "empty":
        pass
    else:
        m.reshape(-1)[rng.choice(H * W, int(kind), replace=False)] = 1.0
    return m


@pytest.mark.parametrize("kind", ["79", "grid", "2", "empty"])
@pytest.mark.parametrize("H,W,k", [(32, 32, 4), (20, 13, 3), (16, 16, 1)])
def test_gauge_topk_kernel_bitwise(dev, kind, H, W, k):
    mask = torch.from_numpy(_mask(kind, H, W, np.random.default_rng(0))).to(dev)
    args = gauge_geometry(mask, 128)[:5]
    gd2, gsel = K.gauge_topk(*args, k=k)
    rd2, rsel = K.gauge_topk_reference(*args, k=k)
    assert torch.equal(gsel, rsel)
    assert torch.equal(gd2.view(torch.int32), rd2.view(torch.int32))


@pytest.mark.parametrize("kind", ["79", "grid"])
def test_card_path_equals_cpu_path_bitwise(dev, kind):
    """Gauge selection and combine on the card (kernels) equal the plain CPU
    path bit for bit, so the card breaks every distance tie as the JAX
    reference does on the CPU."""
    rng = np.random.default_rng(2)
    mask = torch.from_numpy(_mask(kind, 48, 40, rng))
    tables = torch.from_numpy(rng.normal(size=(5, 16, 128)).astype(np.float32))
    outs = []
    for d in ("cpu", dev):
        gd2, gsel, gpix = factored_prepare_full(mask.to(d), 128)
        out = K.combine_table_multi(gd2.t().contiguous(), gsel.t().contiguous(),
                                    tables.to(d), 4)
        outs.append([t.cpu() for t in (gd2, gsel, gpix, out)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# the shared-mask combine (#2) and its backward (#4), (D, N, k): D=16, k=4
# selects on registers (kf=5), the others at run time (kf = 4, 1, 3, 3, 1)
MULTI_FWD_CASES = [(16, 8, 4), (4, 3, 4), (1, 1, 4), (16, 70, 3), (16, 12, 4), (4, 3, 3),
                   (1, 2, 3)]
MULTI_BWD_CASES = [(16, 12, 4), (4, 3, 4), (16, 40, 3), (1, 1, 4), (4, 3, 3), (1, 2, 3)]
MULTI_KINDS = ["79", "grid", "2"]
# mask shapes (H, W): 851 pixels fill no block of either kernel
MULTI_FWD_SHAPE, MULTI_BWD_SHAPE, MULTI_ODD_SHAPE = (24, 40), (40, 24), (23, 37)


def _multi_inputs(dev, kind, shape, k, seed):
    """gd2_t, gsel_t (k, HW) of one mask on the card, and the rng after it."""
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(_mask(kind, *shape, rng)).to(dev)
    gd2, gsel, _ = factored_prepare_full(mask, 128, k=k)
    return gd2.t().contiguous(), gsel.t().contiguous(), rng


@pytest.mark.parametrize("kind", MULTI_KINDS)
@pytest.mark.parametrize("D,N,k", MULTI_FWD_CASES)
def test_combine_table_multi_kernel(dev, kind, D, N, k):
    rng = np.random.default_rng(1)
    mask = torch.from_numpy(_mask(kind, *MULTI_FWD_SHAPE, rng)).to(dev)
    gd2, gsel, _ = factored_prepare_full(mask, 128, k=k)
    tables = torch.from_numpy(rng.normal(size=(N, D, 128)).astype(np.float32)).to(dev)
    args = (gd2.t().contiguous(), gsel.t().contiguous(), tables, k)
    got = K.combine_table_multi(*args)
    want = K.combine_table_multi_reference(*args)
    # same selection and the same per-round arithmetic: bitwise equal
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        float((got - want).abs().max())


def test_kernel_wrappers_validate_and_count(dev):
    x = torch.randn(2, 4, 8, 8, device=dev)
    before = maxpool2_duplicate.launches
    maxpool2_duplicate(x)
    assert maxpool2_duplicate.launches == before + 1
    with pytest.raises(ValueError):
        maxpool2_duplicate(x[:, :, :7])  # odd H
    with pytest.raises(ValueError):
        maxpool2_duplicate(x.transpose(2, 3))  # not contiguous
    with pytest.raises(TypeError):
        maxpool2_duplicate(x.double())
    q = torch.zeros(16, device=dev)
    with pytest.raises(ValueError):
        K.gauge_topk(q, q, q[:4], q[:4], q[:4], k=9)


@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("shape", [(8, 64, 128, 128), (12, 64, 128, 128), (12, 256, 32, 32),
                                   (3, 5, 6, 10), (2, 3, 8, 6), (1, 1, 2, 2),
                                   (2, 40000, 2, 4), (1, 70000, 16, 128)])
def test_pool_dup_kernel_bitwise(dev, shape, offset):
    """Bitwise equal to max_pool2d -> repeat_interleave, NaN and +-0 included:
    the 16-byte form (W % 4 == 0, 16-byte aligned), the 8-byte form (rows of
    6 or 10 or 2, or an input offset by two floats), the training batch,
    many small planes a block, and more planes than grid.z holds (one plane
    a block: the launch splits them over grid.x)."""
    n = int(np.prod(shape))
    x = torch.randn(n + offset, device=dev)[offset:].view(shape)
    x.view(-1)[::7] = 0.0
    x.view(-1)[1::11] = -0.0
    x.view(-1)[3::101] = float("nan")
    got, want = maxpool2_duplicate(x), maxpool2_duplicate_reference(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kind", MULTI_KINDS)
@pytest.mark.parametrize("D,N,k", MULTI_BWD_CASES)
def test_combine_table_multi_bwd_kernel(dev, kind, D, N, k):
    """Kernel #4 against its plain version (autograd of the unpruned plain
    combine): max abs error <= 1e-5 x max|plain|, because the kernel sums in
    64-bit fixed point and the plain version in float32 in autograd's order.
    The fixed-point sum is order-free: a second launch, and launches whose
    tile budget holds one window or every window at the widest row (every
    slot; a block's own row is narrower, so a round takes one or more), give
    the same bits."""
    rng = np.random.default_rng(5)
    mask = torch.from_numpy(_mask(kind, *MULTI_BWD_SHAPE, rng)).to(dev)
    gd2, gsel, _ = factored_prepare_full(mask, 128, k=k)
    g = torch.from_numpy(rng.normal(size=(N, D, 40 * 24)).astype(np.float32)).to(dev)
    args = (gd2.t().contiguous(), gsel.t().contiguous(), g, 128, k)
    before = K.combine_table_multi_bwd.launches
    got = K.combine_table_multi_bwd(*args)
    want = K.combine_table_multi_bwd_reference(*args)
    assert K.combine_table_multi_bwd.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for tile_bytes in (None, 0, 8 * K.bwd_widest_row(D, 128, k) * N):
        again = K.combine_table_multi_bwd(*args, tile_bytes=tile_bytes)
        assert torch.equal(again.view(torch.int32), got.view(torch.int32)), tile_bytes


@pytest.mark.parametrize("kind", MULTI_KINDS)
@pytest.mark.parametrize("D,N,k", MULTI_BWD_CASES)
@pytest.mark.parametrize("shape", [MULTI_BWD_SHAPE, MULTI_ODD_SHAPE])
def test_combine_table_multi_bwd_kernel_is_its_fixed_model(dev, kind, D, N, k, shape):
    """Kernel #4 bit for bit its fixed-point model
    (``combine_table_multi_bwd_fixed_reference``: the plain selection's terms
    summed in 64-bit fixed point), on the register rounds and the run-time
    ones, on a mask whose pixels fill no block, and with a NaN and an
    infinity in the cotangent (each reaches exactly the targets it touches)."""
    gd2_t, gsel_t, rng = _multi_inputs(dev, kind, shape, k, 8)
    hw = shape[0] * shape[1]
    g = torch.from_numpy(rng.normal(size=(N, D, hw)).astype(np.float32)).to(dev)
    g[0, 0, hw // 2] = float("nan")
    g[-1, -1, hw - 1] = float("inf")
    got = K.combine_table_multi_bwd(gd2_t, gsel_t, g, 128, k)
    want = K.combine_table_multi_bwd_fixed_reference(gd2_t, gsel_t, g, 128, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        int((got.view(torch.int32) != want.view(torch.int32)).sum())


@pytest.mark.parametrize("kind", MULTI_KINDS)
@pytest.mark.parametrize("D,N,k", MULTI_FWD_CASES)
def test_combine_table_multi_kernel_odd_shape(dev, kind, D, N, k):
    """Kernel #2 bitwise its plain version on a mask of 851 pixels, which
    fills no block."""
    gd2_t, gsel_t, rng = _multi_inputs(dev, kind, MULTI_ODD_SHAPE, k, 9)
    tables = torch.from_numpy(rng.normal(size=(N, D, 128)).astype(np.float32)).to(dev)
    got = K.combine_table_multi(gd2_t, gsel_t, tables, k)
    want = K.combine_table_multi_reference(gd2_t, gsel_t, tables, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("shape,mshape", [
    ((12, 16, 128, 128, 1), (12, 1, 128, 128, 1)),   # frame-constant, 4-wide
    ((12, 16, 128, 128, 1), (12, 16, 128, 128, 1)),  # full mask
    ((2, 3, 5, 7, 1), (2, 1, 5, 7, 1)),               # odd plane: 1-wide path
])
@pytest.mark.parametrize("mdtype", [np.uint8, np.float32, np.bool_])
def test_decode_normalize_mask_kernel_bitwise(dev, shape, mshape, mdtype):
    """Kernel #11 against the host pipeline's numpy decode: bitwise."""
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, size=shape, dtype=np.uint8)
    mask = (rng.random(mshape) < 0.3).astype(mdtype)
    video, masked = decode_normalize_mask(torch.from_numpy(u8).to(dev),
                                          torch.from_numpy(mask).to(dev))
    host = u8.astype(np.float32) / 255.0
    want = host * mask.astype(np.float32)
    assert np.array_equal(video.cpu().numpy().view(np.int32), host.view(np.int32))
    assert np.array_equal(masked.cpu().numpy().view(np.int32), want.view(np.int32))
    plain = decode_normalize_mask_reference(torch.from_numpy(u8).to(dev),
                                            torch.from_numpy(mask).to(dev))
    assert np.array_equal(plain[0].cpu().numpy().view(np.int32), host.view(np.int32))


# (frames, mask, mask dtype, bytes the frames start past an allocation): the
# 4-wide path (planes of 16 k and 4 k + 4, a frame pointer 4 bytes off) and
# the 1-wide path (an odd plane, a frame pointer 1 byte off)
DECODE_CASES = [((12, 16, 128, 128, 1), (12, 1, 128, 128, 1), np.uint8, 0),
                ((3, 5, 12, 5, 1), (3, 1, 12, 5, 1), np.uint8, 0),
                ((3, 5, 12, 5, 1), (3, 5, 12, 5, 1), np.float32, 0),
                ((2, 3, 5, 7, 1), (2, 1, 5, 7, 1), np.float32, 0),
                ((2, 3, 16, 16, 1), (2, 1, 16, 16, 1), np.uint8, 4),
                ((2, 3, 16, 16, 1), (2, 3, 16, 16, 1), np.float32, 4),
                ((2, 3, 16, 16, 1), (2, 1, 16, 16, 1), np.uint8, 1),
                ((4, 16, 32, 32, 1), (4, 16, 32, 32, 1), np.uint8, 0)]
DECODE_VEC4 = [True, True, True, False, True, True, False, True]


@pytest.mark.parametrize("case,vec4", list(zip(DECODE_CASES, DECODE_VEC4)))
def test_decode_normalize_mask_kernel_paths_bitwise(dev, case, vec4):
    """Kernel #11 on its 4-wide and 1-wide paths, against the numpy decode:
    bitwise, and the same bits across two launches."""
    shape, mshape, mdtype, offset = case
    rng = np.random.default_rng(11 + offset)
    u8 = rng.integers(0, 256, size=shape, dtype=np.uint8)
    mask = (rng.random(mshape) < 0.3).astype(mdtype)
    frames = torch.empty(u8.size + offset, dtype=torch.uint8, device=dev)[offset:]
    frames = frames.view(shape).copy_(torch.from_numpy(u8))
    mask_d = torch.from_numpy(mask).to(dev)
    # the wrapper's choice of path (ops/decode_mask.py)
    plane = u8.size // (shape[0] * shape[1]) if mshape[1] == 1 else u8.size
    align = 16 if mask_d.dtype == torch.float32 else 4
    assert vec4 == (plane % 4 == 0 and frames.data_ptr() % 4 == 0
                    and mask_d.data_ptr() % align == 0)
    video, masked = decode_normalize_mask(frames, mask_d)
    again = decode_normalize_mask(frames, mask_d)
    host = u8.astype(np.float32) / 255.0
    want = host * mask.astype(np.float32)
    assert np.array_equal(video.cpu().numpy().view(np.int32), host.view(np.int32))
    assert np.array_equal(masked.cpu().numpy().view(np.int32), want.view(np.int32))
    assert torch.equal(again[0], video) and torch.equal(again[1], masked)


def test_gradients_through_both_functions(dev):
    """combine_table_multi and maxpool2_duplicate carry autograd on the card:
    their gradients equal the plain versions' (the combine within 1e-5 x max,
    the pool bitwise)."""
    rng = np.random.default_rng(7)
    mask = torch.from_numpy(_mask("79", 32, 32, rng)).to(dev)
    gd2, gsel, _ = factored_prepare_full(mask, 128)
    gd2_t, gsel_t = gd2.t().contiguous(), gsel.t().contiguous()
    tables = torch.randn(6, 16, 128, device=dev, requires_grad=True)
    plain = tables.detach().clone().requires_grad_(True)
    out = K.combine_table_multi(gd2_t, gsel_t, tables, 4)
    assert type(out.grad_fn).__name__ == "_CombineTableMultiBackward"
    w = torch.randn_like(out)
    (out * w).sum().backward()
    (K.combine_table_multi_reference(gd2_t, gsel_t, plain, 4) * w).sum().backward()
    assert float((tables.grad - plain.grad).abs().max()) <= \
        1e-5 * float(plain.grad.abs().max())

    x = torch.randn(4, 8, 16, 16, device=dev)
    x.view(-1)[::3] = 0.0  # ties
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    y = maxpool2_duplicate(xa)
    assert type(y.grad_fn).__name__ == "_MaxPool2DuplicateBackward"
    gy = torch.randn_like(y)
    y.backward(gy)
    maxpool2_duplicate_reference(xb).backward(gy)
    assert torch.equal(xa.grad, xb.grad)


# -- the per-sample (sti) factored IDW: batched #1, #5, #6, #7 ------------------

def _sti_masks(rng, B, H, W, bs):
    """B jittered grids (one gauge a block) plus a 2-gauge and an empty mask."""
    from p2igan_tpu_torch.data.masks import create_mask_np

    ms = [create_mask_np((1, H, W, 1), rng, "sti", block_sizes=[bs])[0, :, :, 0]
          for _ in range(B - 2)]
    return np.stack(ms + [_mask("2", H, W, rng), _mask("empty", H, W, rng)])


@pytest.mark.parametrize("H,W,bs,G,k", [(32, 32, 4, 128, 4), (40, 24, 2, 512, 4),
                                        (20, 13, 4, 128, 3)])
def test_batched_gauge_topk_equals_single_masks_and_cpu(dev, H, W, bs, G, k):
    """One launch for B masks: bitwise what B single-mask launches give, what
    the plain version gives, and what the CPU path gives (gd2, gsel and the
    slot pixels), so the card breaks every tie as the CPU does."""
    masks = torch.from_numpy(_sti_masks(np.random.default_rng(0), 5, H, W, bs))
    before = K.gauge_topk.launches
    got = factored_prepare_full(masks.to(dev), G, k=k)
    assert K.gauge_topk.launches == before + 1
    cpu = factored_prepare_full(masks, G, k=k)
    for a, b in zip(got, cpu):
        assert torch.equal(a.cpu(), b)
    for i in range(masks.shape[0]):
        one = factored_prepare_full(masks[i].to(dev), G, k=k)
        for a, b in zip(got, one):
            assert torch.equal(a[i], b)
    args = gauge_geometry(masks.to(dev), G)[:5]
    gd2, gsel = K.gauge_topk(*args, k=k)
    rd2, rsel = K.gauge_topk_reference(*args, k=k)
    assert torch.equal(gsel, rsel)
    assert torch.equal(gd2.view(torch.int32), rd2.view(torch.int32))


@pytest.mark.parametrize("k", [4, 3])
def test_batched_gauge_topk_mixes_masks_of_fewer_than_k_gauges(dev, k):
    """Masks of 0, 1, 2 and 3 gauges between full sti masks at G=256 in one
    launch: the one pass's fewer-than-k rule (every place at 1e30 takes the
    lowest slot of its list) gives the plain rounds' gd2 and gsel bit for bit,
    mask by mask."""
    from p2igan_tpu_torch.data.masks import create_mask_np

    rng = np.random.default_rng(4)
    full = [create_mask_np((1, 128, 128, 1), rng, "sti", block_sizes=[10])[0, :, :, 0]
            for _ in range(3)]
    few = [_mask(str(n), 128, 128, rng) if n else _mask("empty", 128, 128, rng)
           for n in (0, 1, 2, 3)]
    masks = torch.from_numpy(np.stack([few[0], full[0], few[1], few[2], full[1], few[3],
                                       full[2]])).to(dev)
    args = gauge_geometry(masks, 256)[:5]
    gd2, gsel = K.gauge_topk(*args, k=k)
    rd2, rsel = K.gauge_topk_reference(*args, k=k)
    assert torch.equal(gsel, rsel)
    assert torch.equal(gd2.view(torch.int32), rd2.view(torch.int32))
    assert int((gd2[0] == K.BIG).sum()) == k * 128 * 128     # no gauge: every place
    assert int(gsel[0].max()) == 0 and int(gsel[2, 1:].max()) == 0


# (D, G, k) of the per-sample combine cases (#5, #6); G=1152 takes block-1
# masks (every pixel a gauge, 960 of them), the others block 4
STI_FWD_CASES = [(16, 128, 4), (16, 1152, 4), (4, 256, 4), (1, 128, 4), (16, 128, 3)]
STI_BWD_CASES = [(16, 128, 4), (16, 1152, 4), (4, 256, 4), (16, 128, 3)]


def _sti_selection(rng, G, k, d):
    """(gd2_t, gsel_t) (4, k, 960) on device ``d`` of 4 masks of 40 x 24: jittered
    grids (block 1 at G=1152, else 4), a 2-gauge and an empty mask."""
    masks = torch.from_numpy(_sti_masks(rng, 4, 40, 24, 1 if G == 1152 else 4)).to(d)
    gd2, gsel, _ = factored_prepare_full(masks, G, k=k)
    return gd2.transpose(1, 2).contiguous(), gsel.transpose(1, 2).contiguous()


@pytest.mark.parametrize("D,G,k", STI_FWD_CASES)
def test_combine_table_kernel_bitwise(dev, D, G, k):
    """Kernel #5 against its plain version (all D frames, no pruning) and
    against the CPU path: bitwise, the same selection and per-round sums."""
    rng = np.random.default_rng(1)
    bs = 1 if G == 1152 else 4   # block 1: every pixel a gauge, 960 of them
    masks = torch.from_numpy(_sti_masks(rng, 4, 40, 24, bs))
    tables = torch.from_numpy(rng.normal(size=(4, D, G)).astype(np.float32))
    outs = {}
    for d in ("cpu", dev):
        gd2, gsel, _ = factored_prepare_full(masks.to(d), G, k=k)
        args = (gd2.transpose(1, 2).contiguous(), gsel.transpose(1, 2).contiguous(),
                tables.to(d), k)
        before = K.combine_table.launches
        outs[str(d)] = K.combine_table(*args)
        assert K.combine_table.launches == before + (d != "cpu")
    want = K.combine_table_reference(*args)
    got = outs[str(dev)]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        float((got - want).abs().max())
    assert torch.equal(got.cpu(), outs["cpu"])
    assert float(got[-1].abs().max()) == 0.0  # the empty mask


@pytest.mark.parametrize("D,G,k", STI_BWD_CASES)
def test_combine_table_bwd_kernel(dev, D, G, k):
    """Kernel #6 against its plain version (autograd of the unpruned plain
    combine): max abs error <= 1e-5 x max|plain| (64-bit fixed-point sums
    against float32 ones in autograd's order), and bitwise equal across two
    launches (the fixed-point sum is order-free). Through autograd the output
    carries a grad_fn and the table receives that gradient."""
    rng = np.random.default_rng(5)
    bs = 1 if G == 1152 else 4
    masks = torch.from_numpy(_sti_masks(rng, 4, 40, 24, bs)).to(dev)
    gd2, gsel, _ = factored_prepare_full(masks, G, k=k)
    gd2_t, gsel_t = gd2.transpose(1, 2).contiguous(), gsel.transpose(1, 2).contiguous()
    g = torch.from_numpy(rng.normal(size=(4, D, 40 * 24)).astype(np.float32)).to(dev)
    before = K.combine_table_bwd.launches
    got = K.combine_table_bwd(gd2_t, gsel_t, g, G, k)
    want = K.combine_table_bwd_reference(gd2_t, gsel_t, g, G, k)
    assert K.combine_table_bwd.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    again = K.combine_table_bwd(gd2_t, gsel_t, g, G, k)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    tables = torch.randn(4, D, G, device=dev, requires_grad=True)
    out = K.combine_table(gd2_t, gsel_t, tables, k)
    assert type(out.grad_fn).__name__ == "_CombineTableBackward"
    out.backward(g)
    assert float((tables.grad - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(ValueError, match="shared memory"):
        K.combine_table_bwd(gd2_t, gsel_t, g, 100000, k)


def _fixed_scatter_of_terms(gd2_t, gsel_t, g, G, k):
    """d_tables as the fixed-point sum model of ``tests/test_torch_fixed_sum.py``
    (``fixed_scatter``, one sample a row) gives it for the plain selection's
    terms w_norm * g."""
    from test_torch_fixed_sum import fixed_scatter

    B, D, HW = g.shape
    off, wnorm = K.combine_table_terms_reference(gd2_t, gsel_t, D, G, k)
    gb = g[:, :, None, :].expand(B, D, k, HW)
    rows = [fixed_scatter(wnorm[b].cpu().numpy().ravel(), gb[b].cpu().numpy().ravel(),
                          off[b].cpu().numpy().ravel(), D * G, D * HW) for b in range(B)]
    return torch.from_numpy(np.stack(rows)).view(B, D, G)


def _same_bits(a, b):
    return torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.parametrize("D,G,k", STI_BWD_CASES)
def test_combine_table_bwd_is_the_fixed_point_sum_of_the_plain_terms(dev, D, G, k):
    """Kernel #6 bitwise equal to the fixed-point sum (``fixed_scatter``) of the
    plain selection's terms, and to the same model in PyTorch on the card."""
    rng = np.random.default_rng(11)
    gd2_t, gsel_t = _sti_selection(rng, G, k, dev)
    g = torch.from_numpy(rng.normal(size=(4, D, 960)).astype(np.float32)).to(dev)
    got = K.combine_table_bwd(gd2_t, gsel_t, g, G, k)
    assert _same_bits(got, _fixed_scatter_of_terms(gd2_t, gsel_t, g, G, k))
    assert _same_bits(got, K.combine_table_bwd_fixed_reference(gd2_t, gsel_t, g, G, k))


@pytest.mark.parametrize("G", [128, 1152])
def test_combine_table_bwd_one_gauge(dev, G):
    """A one-gauge mask: every pixel's k rounds pick frames of slot 0, so the 32
    lanes of a warp add into one tile entry at once (the same-address
    atomics). Bitwise the fixed-point model, within 1e-5 x max|plain| of the
    plain version, at one strip a block (G=128: direct distances) and at four
    (G=1152: the distance tables); the last strip is ragged (HW = 4000)."""
    m = np.zeros((2, 50, 80), np.float32)
    m[0, 20, 30] = m[1, 0, 79] = 1.0
    gd2, gsel, _ = factored_prepare_full(torch.from_numpy(m).to(dev), G, k=4)
    gd2_t, gsel_t = gd2.transpose(1, 2).contiguous(), gsel.transpose(1, 2).contiguous()
    g = torch.from_numpy(np.random.default_rng(12).normal(
        size=(2, 16, 4000)).astype(np.float32)).to(dev)
    got = K.combine_table_bwd(gd2_t, gsel_t, g, G, 4)
    assert _same_bits(got, K.combine_table_bwd_fixed_reference(gd2_t, gsel_t, g, G, 4))
    want = K.combine_table_bwd_reference(gd2_t, gsel_t, g, G, 4)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float(got[:, :, 1:].abs().max()) == 0.0   # only slot 0 holds a gauge


def test_combine_table_bwd_non_finite_cotangent(dev):
    """A NaN and an infinity of each sign in the cotangent reach exactly the
    tile entries their pixels' selections touch (NaN wins, +inf and -inf
    together give NaN), bitwise the fixed-point model (``fixed_scatter``);
    every other entry stays finite. Block-4 masks: every round is a gauge."""
    from p2igan_tpu_torch.data.masks import create_mask_np

    rng = np.random.default_rng(13)
    masks = np.stack([create_mask_np((1, 40, 24, 1), rng, "sti", block_sizes=[4])[0, :, :, 0]
                      for _ in range(2)])
    gd2, gsel, _ = factored_prepare_full(torch.from_numpy(masks).to(dev), 128, k=4)
    gd2_t, gsel_t = gd2.transpose(1, 2).contiguous(), gsel.transpose(1, 2).contiguous()
    g = torch.from_numpy(rng.normal(size=(2, 16, 960)).astype(np.float32))
    g[0, 3, 100], g[0, 9, 500], g[1, 0, 7], g[1, 15, 959] = (
        float("nan"), float("inf"), float("-inf"), float("inf"))
    g = g.to(dev)
    got = K.combine_table_bwd(gd2_t, gsel_t, g, 128, 4)
    assert _same_bits(got, _fixed_scatter_of_terms(gd2_t, gsel_t, g, 128, 4))
    off, _ = K.combine_table_terms_reference(gd2_t, gsel_t, 16, 128, 4)
    touched = torch.zeros(2, 16 * 128, dtype=torch.bool)
    for b, z, p in ((0, 3, 100), (0, 9, 500), (1, 0, 7), (1, 15, 959)):
        touched[b, off[b, z, :, p].cpu()] = True
    assert torch.equal(~torch.isfinite(got.cpu().view(2, -1)), touched)


@pytest.mark.parametrize("kind", ["79", "grid", "2", "empty"])
@pytest.mark.parametrize("D,k", [(16, 4), (4, 4), (1, 4), (16, 3), (5, 4), (13, 4), (16, 1)])
@pytest.mark.parametrize("H,W", [(24, 40), (17, 29)])
def test_combine_dense_kernel_bitwise(dev, kind, D, k, H, W):
    """Kernel #7 (through idw_3d_factored) against its plain version and the
    CPU path: bitwise, and across two calls; its gradient (autograd of the
    plain version on the card) reaches the field and equals the CPU path's
    within 1e-5 x max. D = 5 and 13 end a warp's span of frames short; 17 x
    29 pixels fill no whole block."""
    from p2igan_tpu_torch.ops.idw import factored_prepare, idw_3d_factored

    rng = np.random.default_rng(3)
    mask = torch.from_numpy(_mask(kind, H, W, rng))
    values = torch.from_numpy(rng.normal(size=(D, H, W)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(D, H, W)).astype(np.float32))
    outs, grads = {}, {}
    for d in ("cpu", dev):
        field = values.to(d).detach().requires_grad_(True)
        before = K.combine_dense.launches
        out = idw_3d_factored(mask.to(d), field, 128, k=k)
        assert K.combine_dense.launches == before + (d != "cpu")
        assert type(out.grad_fn).__name__ != "NoneType"
        out.backward(cot.to(d))
        outs[str(d)], grads[str(d)] = out.detach().cpu(), field.grad.cpu()
    assert torch.equal(outs["cpu"], outs[str(dev)])
    scale = max(float(grads["cpu"].abs().max()), 1e-30)
    assert float((grads["cpu"] - grads[str(dev)]).abs().max()) <= 1e-5 * scale
    gd2, gpix = factored_prepare(mask.to(dev), 128, k=k)
    cvals_t = values.to(dev).reshape(D, -1)[:, gpix.long()].permute(0, 2, 1) \
        .reshape(D * k, -1).contiguous()
    gd2_t = gd2.t().contiguous()
    got = K.combine_dense(gd2_t, cvals_t, k)
    again = K.combine_dense(gd2_t, cvals_t, k)
    want = K.combine_dense_reference(gd2_t, cvals_t, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_sti_wrappers_validate(dev):
    gd2 = torch.zeros(2, 4, 64, device=dev)
    gsel = torch.zeros(2, 4, 64, device=dev, dtype=torch.int32)
    tables = torch.zeros(2, 16, 128, device=dev)
    with pytest.raises(ValueError):
        K.combine_table(gd2[:1], gsel, tables, 4)           # batch mismatch
    with pytest.raises(TypeError):
        K.combine_table(gd2, gsel.float(), tables, 4)
    with pytest.raises(ValueError):
        K.combine_table(gd2.transpose(1, 2), gsel, tables, 4)  # not contiguous
    with pytest.raises(ValueError):
        K.combine_table(gd2, gsel.cpu(), tables, 4)          # mixed devices
    with pytest.raises(ValueError):
        K.combine_dense(gd2[0], torch.zeros(63, 64, device=dev), 4)  # D*k rows
    with pytest.raises(ValueError):
        K.combine_table_bwd(gd2, gsel, torch.zeros(2, 16, 32, device=dev), 128, 4)


def test_sti_generator_gradients_on_the_card(dev):
    """A small per-sample generator forward and backward on the card: every
    parameter gets a gradient (the combine's Function carries it back to the
    attention blocks) and input.* match the CPU path within 1e-4 x max."""
    from p2igan_tpu_torch.models import P2IGenerator

    rng = np.random.default_rng(8)
    masks = np.broadcast_to(_sti_masks(rng, 4, 32, 32, 4)[:, None, :, :, None],
                            (4, 4, 32, 32, 1)).copy()
    frames = rng.random((4, 4, 32, 32, 1)).astype(np.float32)
    grads = {}
    for d in ("cpu", dev):
        gen = P2IGenerator(H=32, W=32, length=4, num_res=1, base_channels=16,
                           idw_max_points=512, idw_factored=True,
                           idw_shared_batch_mask=False,
                           generator=torch.Generator().manual_seed(0), device=d)
        m = torch.from_numpy(masks).to(d)
        f = torch.from_numpy(frames).to(d)
        before = (K.gauge_topk.launches, K.combine_table.launches,
                  K.combine_table_bwd.launches)
        (gen(f * m, m) - f).abs().mean().backward()
        after = (K.gauge_topk.launches, K.combine_table.launches,
                 K.combine_table_bwd.launches)
        assert tuple(a - b for a, b in zip(after, before)) == ((0,) * 3 if d == "cpu"
                                                               else (1,) * 3)
        grads[str(d)] = {n: p.grad.cpu() for n, p in gen.named_parameters()}
        assert all(p.grad is not None for p in gen.parameters())
    for name, g in grads["cpu"].items():
        if name.startswith("input."):
            assert float(g.abs().max()) > 0
            assert float((g - grads[str(dev)][name]).abs().max()) <= \
                1e-4 * float(g.abs().max()), name


# -- the fused DK/STDK MLP tail (csrc/dk_mlp_tail.cu, dk_mlp_tail_bwd.cu) ------

def _tail_inputs(HW, J, h, dev, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev).to(dtype)

    s = np.sqrt(2.0 / h)
    return (arr(HW, h), arr(J, h), arr(h, h, scale=s), arr(h, scale=0.1),
            arr(h, h, scale=s), arr(h, scale=0.1), arr(h, scale=s), arr(1)[0])


# ragged pixel tiles (HW not a multiple of 128 or 64), a hidden width below
# the thread grid's 104 columns, and the models' own h = 100; then the edges
# of the backward's tiling: h not a multiple of 8 (nor of 4: no float4 loads),
# h = 104 (no padding), one pixel past a 64-pixel block, and J = 1
TAIL_SHAPES = [(256, 6, 100), (1000, 5, 100), (77, 3, 40), (130, 2, 102), (64, 1, 8),
               (65, 4, 97), (200, 3, 104), (300, 1, 100)]


@pytest.mark.parametrize("HW,J,h", TAIL_SHAPES)
def test_mlp_tail_kernel_matches_plain(dev, HW, J, h):
    from p2igan_tpu_torch.ops import dk_mlp_kernel as M

    args = _tail_inputs(HW, J, h, dev)
    before = M.mlp_tail_fused.launches
    out = M.mlp_tail_fused(*args)
    torch.cuda.synchronize()
    assert M.mlp_tail_fused.launches == before + 1
    want = M.mlp_tail_reference(*(a.double() for a in args))
    assert out.shape == (J, HW) and out.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((out.double() - want).abs().max()) <= 1e-5 * scale


# and ranges of (tile, j) units that cross pixel tiles: more units than SMs
ORDER_SHAPES = TAIL_SHAPES + [(1500, 12, 100), (2000, 20, 24)]


@pytest.mark.parametrize("HW,J,h", ORDER_SHAPES)
def test_mlp_tail_kernel_is_its_order_model_bitwise(dev, HW, J, h):
    """#12 bit for bit the numpy model of its arithmetic
    (``tests/test_torch_dk_tail_order.py``): sequential fmaf sums, the fc4
    dot's 13 partials in fixed order. #13's relu masks rely on that order."""
    from test_torch_dk_tail_order import tail_model

    from p2igan_tpu_torch.ops import dk_mlp_kernel as M

    args = _tail_inputs(HW, J, h, dev)
    got = M.mlp_tail_fused(*args).cpu().numpy()
    want = tail_model(*(a.cpu().numpy() for a in args))
    differ = got.view(np.uint32) != want.view(np.uint32)
    assert not differ.any(), f"{int(differ.sum())} of {differ.size} outputs differ"


def test_mlp_tail_repeats_bitwise_at_full_width(dev):
    """At the models' pixel count and J = 192 (every SM a range of units)."""
    from p2igan_tpu_torch.ops import dk_mlp_kernel as M

    args = _tail_inputs(16384, 192, 100, dev, seed=6)
    first, second = M.mlp_tail_fused(*args), M.mlp_tail_fused(*args)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.parametrize("HW,J,h", TAIL_SHAPES)
def test_mlp_tail_bwd_kernel_matches_plain(dev, HW, J, h):
    """The eight gradients against float64 autograd of the plain version:
    1e-4 x max|plain| (the sums over J * HW terms run in another order)."""
    from p2igan_tpu_torch.ops import dk_mlp_kernel as M

    args = [a.requires_grad_(True) for a in _tail_inputs(HW, J, h, dev)]
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((J, HW))
                         .astype(np.float32)).to(dev)
    before = M.mlp_tail_bwd.launches
    out = M.mlp_tail_fused(*args)
    got = torch.autograd.grad(out, args, g)
    torch.cuda.synchronize()
    assert M.mlp_tail_bwd.launches == before + 1
    args64 = [a.detach().double().requires_grad_(True) for a in args]
    want = torch.autograd.grad(M.mlp_tail_reference(*args64), args64, g.double())
    names = ("dphi", "doff", "dfc2", "db2", "dfc3", "db3", "dfc4", "db4")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a.double() - b).abs().max()) <= 1e-4 * scale, name


def test_mlp_tail_bwd_repeats_bitwise(dev):
    """Within a block the tensor-core products run in a fixed order and the
    partials are summed in block order, so two runs agree bit for bit."""
    from p2igan_tpu_torch.ops import dk_mlp_kernel as M

    phi, off, fc2, b2, fc3, b3, fc4, _ = _tail_inputs(700, 9, 100, dev)
    g = torch.ones((9, 700), device=dev)
    first = M.mlp_tail_bwd(phi, off, g, fc2, b2, fc3, b3, fc4)
    second = M.mlp_tail_bwd(phi, off, g, fc2, b2, fc3, b3, fc4)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_mlp_tail_bwd_repeats_bitwise_at_full_width(dev):
    """The same at the models' pixel count (256 blocks, every SM busy)."""
    from p2igan_tpu_torch.ops import dk_mlp_kernel as M

    phi, off, fc2, b2, fc3, b3, fc4, _ = _tail_inputs(16384, 16, 100, dev, seed=3)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((16, 16384))
                         .astype(np.float32)).to(dev)
    first = M.mlp_tail_bwd(phi, off, g, fc2, b2, fc3, b3, fc4)
    second = M.mlp_tail_bwd(phi, off, g, fc2, b2, fc3, b3, fc4)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_mlp_tail_bwd_near_zero_preactivations(dev):
    """The relu masks come from the kernel's recomputed forward. With many
    pre-activations near zero and some exactly zero
    (``test_torch_tf32x3.near_zero_tail_inputs``) the gradients still agree
    with float64 autograd of the plain version, 1e-4 x max|plain|: the
    recompute keeps float32 accuracy, so no mask flips against float64."""
    from test_torch_tf32x3 import near_zero_tail_inputs

    from p2igan_tpu_torch.ops import dk_mlp_kernel as M

    args = [torch.from_numpy(a).to(dev) for a in near_zero_tail_inputs()]
    got = M.mlp_tail_bwd(*args)
    want = M.mlp_tail_bwd_reference(*(a.double() for a in args))
    torch.cuda.synchronize()
    names = ("dphi", "doff", "dfc2", "db2", "dfc3", "db3", "dfc4")
    for name, a, b in zip(names, got, want):
        scale = float(b.abs().max())
        assert scale > 0, name
        assert float((a.double() - b).abs().max()) <= 1e-4 * scale, name


def test_mlp_tail_rejects_what_the_kernel_does_not_take(dev):
    from p2igan_tpu_torch.ops import dk_mlp_kernel as M

    args = list(_tail_inputs(64, 2, 100, dev))
    ones = torch.ones((2, 64), device=dev)
    big = _tail_inputs(64, 2, 120, dev)                        # h > 104
    with pytest.raises(ValueError):
        M.mlp_tail_fused(*big)
    with pytest.raises(ValueError):
        M.mlp_tail_bwd(*big[:2], ones, *big[2:7])
    wide = _tail_inputs(64, 2, 104, dev)                       # the widest both take
    assert M.mlp_tail_fused(*wide).shape == (2, 64)
    assert M.mlp_tail_bwd(*wide[:2], ones, *wide[2:7])[0].shape == (64, 104)
    with pytest.raises(ValueError):
        M.mlp_tail_fused(args[0], args[1][:, :50], *args[2:])  # shapes
    cpu = [a.cpu() for a in args]
    with pytest.raises(ValueError):
        M.mlp_tail_fused(args[0], cpu[1], *args[2:])           # mixed devices


@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_dk_generators_through_the_kernels_match_the_plain_tail(dev, family):
    """Model level, on the card: forward and every parameter's gradient
    through the kernel pair (weights reach it as transposed views) equal the
    plain tail's on the same device: 1e-5 and 1e-4 x max|plain|."""
    from p2igan_tpu_torch.models import DKGenerator, STDKGenerator
    from p2igan_tpu_torch.ops import dk_mlp_kernel as M

    klass = DKGenerator if family == "dk" else STDKGenerator
    rng = np.random.default_rng(12)
    b, t, hw, k = 3, 4, 40, 7
    masks = np.zeros((b, t, hw * hw, 1), np.float32)
    masks[:, :, rng.choice(hw * hw, k, replace=False)] = 1.0
    masks = torch.from_numpy(masks.reshape(b, t, hw, hw, 1)).to(dev)
    frames = torch.from_numpy(rng.random((b, t, hw, hw, 1), dtype=np.float32)).to(dev)
    weight = torch.from_numpy(rng.standard_normal((b, t, hw, hw, 1))
                              .astype(np.float32)).to(dev)
    gen = klass(length=t, visible_k=k, shared_batch_mask=True, device=dev,
                generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for m in gen._mlp.net:
            if hasattr(m, "bias"):
                m.bias.normal_(std=0.1)
    results = {}
    for fused in (None, False):
        gen.fused_tail = fused
        gen.zero_grad(set_to_none=True)
        before = (M.mlp_tail_fused.launches, M.mlp_tail_bwd.launches)
        out = gen(frames * masks, masks)
        (out * weight).sum().backward()
        torch.cuda.synchronize()
        launched = (M.mlp_tail_fused.launches - before[0],
                    M.mlp_tail_bwd.launches - before[1])
        assert launched == ((1, 1) if fused is None else (0, 0))
        results[fused] = (out.detach(), {n: p.grad.clone()
                                         for n, p in gen.named_parameters()})
    (out_k, grads_k), (out_p, grads_p) = results[None], results[False]
    assert float((out_k - out_p).abs().max()) <= 1e-5 * float(out_p.abs().max())
    for name, want in grads_p.items():
        scale = float(want.abs().max())
        assert scale > 0, name
        assert float((grads_k[name] - want).abs().max()) <= 1e-4 * scale, name


# -- the simple family's fused convolutions (csrc/enc0_conv.cu, dec2_stencil.cu) --

def _held(got, want):
    """rtol 1e-5, atol 5e-6. The CPU tests hold these functions to the JAX
    package's atol 1e-6; on the card the kernel and cuDNN sum in different
    orders, and over millions of outputs that difference reaches 1.4e-6 at
    outputs near zero (each side is as far from a float64 result)."""
    assert got.shape == want.shape
    excess = (got - want).abs() - (5e-6 + 1e-5 * want.abs())
    assert float(excess.max()) <= 0.0, float((got - want).abs().max())


def _init_like(rng, shape, fan_in, dev):
    """U(+-1/sqrt(fan_in)), the models' init: outputs of order one."""
    bound = 1.0 / np.sqrt(fan_in)
    return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32)).to(dev)


# odd sizes and ragged tiles, T=1 and T=3 windows, B>1 so that every window's
# temporal edge is hit, Cin 1..4, Cout off the 32-channel pass; then walks
# split into spans of frames (one-window batches; T not a multiple of the
# span), 16-byte copies with W off the tile and 4-byte ones (W * Cin % 4 != 0)
ENC0_SHAPES = [(2, 4, 16, 16, 2, 16), (3, 3, 37, 45, 3, 40), (4, 1, 16, 33, 1, 8),
               (2, 5, 17, 64, 4, 64), (1, 16, 128, 128, 2, 64), (1, 17, 128, 128, 1, 40),
               (2, 11, 96, 128, 4, 64), (1, 3, 128, 128, 2, 64), (2, 6, 20, 50, 2, 64),
               (1, 5, 19, 31, 2, 40), (3, 9, 40, 70, 3, 64), (4, 13, 128, 128, 2, 64)]


@pytest.mark.parametrize("b,t,h,w,cin,cout", ENC0_SHAPES)
def test_enc0_kernel_matches_plain(dev, b, t, h, w, cin, cout):
    from p2igan_tpu_torch.ops import enc0_conv as E

    rng = np.random.default_rng(b + t + h + w + cin + cout)
    x = torch.from_numpy(rng.standard_normal((b, t, h, w, cin)).astype(np.float32)).to(dev)
    k = _init_like(rng, (3, 3, 3, cin, cout), 27 * cin, dev)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1).to(dev)
    before = E.enc0_conv3d_leaky.launches
    got = E.enc0_conv3d_leaky(x, k, bias)
    torch.cuda.synchronize()
    assert E.enc0_conv3d_leaky.launches == before + 1
    assert got.permute(0, 4, 1, 2, 3).is_contiguous() and bool((got < 0).any())
    _held(got, E.enc0_conv3d_leaky_reference(x, k, bias))
    _held(E.enc0_conv3d_leaky(x, k, bias, slope=0.05),
          E.enc0_conv3d_leaky_reference(x, k, bias, 0.05))
    # a window alone gives what it gives inside the batch
    _held(E.enc0_conv3d_leaky(x[-1:].contiguous(), k, bias), got[-1:])


@pytest.mark.parametrize("b,t,h,w,cin,cout", ENC0_SHAPES[4:])
def test_enc0_kernel_is_bitwise_the_same_however_the_walk_splits(dev, b, t, h, w, cin, cout):
    """Each output keeps one order (bias, then dt, dy, dx, ci by fmaf), so a
    window alone (its frames split into more spans) and a window inside the
    batch, or in a batch of twice as many windows, give the same bits."""
    from p2igan_tpu_torch.ops import enc0_conv as E

    rng = np.random.default_rng(7 * (b + t + h + w) + cin + cout)
    x = torch.from_numpy(rng.standard_normal((b, t, h, w, cin)).astype(np.float32)).to(dev)
    k = _init_like(rng, (3, 3, 3, cin, cout), 27 * cin, dev)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.1).to(dev)
    got = E.enc0_conv3d_leaky(x, k, bias)
    alone = [E.enc0_conv3d_leaky(x[i:i + 1].contiguous(), k, bias) for i in range(b)]
    doubled = E.enc0_conv3d_leaky(torch.cat([x, x]), k, bias)
    torch.cuda.synchronize()
    bits = got.contiguous().view(torch.int32)
    for i in range(b):
        assert torch.equal(alone[i].contiguous().view(torch.int32), bits[i:i + 1])
    assert torch.equal(doubled[:b].contiguous().view(torch.int32), bits)
    assert torch.equal(doubled[b:].contiguous().view(torch.int32), bits)


# T of 6, 7 and 9: frame groups of 4 that end past the window
DEC2_SHAPES = [(2, 4, 16, 16, 8), (3, 3, 37, 45, 5), (4, 1, 16, 33, 1),
               (2, 5, 33, 130, 16), (1, 16, 128, 128, 64), (2, 6, 40, 70, 7),
               (3, 7, 32, 64, 3), (1, 9, 65, 129, 12)]


@pytest.mark.parametrize("b,t,h,w,c", DEC2_SHAPES)
def test_dec2_kernel_matches_plain(dev, b, t, h, w, c):
    from p2igan_tpu_torch.ops import dec2_stencil as D

    rng = np.random.default_rng(b + t + h + w + c)
    x = torch.from_numpy(rng.standard_normal((b, t, h, w, c)).astype(np.float32)).to(dev)
    k = _init_like(rng, (3, 3, 3, c, 1), 3 * c, dev)   # 3 x the init: logits of order one
    bias = torch.from_numpy(rng.standard_normal(1).astype(np.float32) * 0.1).to(dev)
    before = D.conv3d_cout1_sigmoid.launches
    got = D.conv3d_cout1_sigmoid(x, k, bias)       # channels-last memory: copied
    torch.cuda.synchronize()
    assert D.conv3d_cout1_sigmoid.launches == before + 1
    assert got.shape == (b, t, h, w, 1)
    want = D.conv3d_cout1_sigmoid_reference(x, k, bias)
    _held(got, want)
    x_cf = x.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    _held(D.conv3d_cout1_sigmoid(x_cf, k, bias), want)   # as the model hands it over
    _held(D.conv3d_cout1_sigmoid(x[-1:], k, bias), got[-1:])
    assert float(got.min()) > 0.0 and float(got.max()) < 1.0 and float(got.std()) > 0.01


def test_fused_convs_reject_what_the_kernels_do_not_take(dev):
    from p2igan_tpu_torch.ops import dec2_stencil as D
    from p2igan_tpu_torch.ops import enc0_conv as E

    x = torch.randn(1, 2, 8, 8, 2, device=dev)
    k, bias = torch.randn(3, 3, 3, 2, 8, device=dev), torch.zeros(8, device=dev)
    with pytest.raises(ValueError):
        E.enc0_conv3d_leaky(x.permute(0, 1, 3, 2, 4), k, bias)          # not contiguous
    with pytest.raises(ValueError):
        E.enc0_conv3d_leaky(torch.randn(1, 2, 8, 8, 5, device=dev),      # Cin > 4
                            torch.randn(3, 3, 3, 5, 8, device=dev), bias)
    with pytest.raises(TypeError):
        E.enc0_conv3d_leaky(x.double(), k.double(), bias.double())
    with pytest.raises(ValueError):
        E.enc0_conv3d_leaky(x, k.cpu(), bias)                            # mixed devices
    with pytest.raises(RuntimeError, match="forward-only"):
        E.enc0_conv3d_leaky(x, k.requires_grad_(True), bias)
    k2 = torch.randn(3, 3, 3, 2, 1, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        D.conv3d_cout1_sigmoid(x, k2, torch.zeros(1, device=dev))


@pytest.mark.parametrize("dec2_fused", [True, False])
def test_folded_simple_generator_card_equals_cpu(dev, dec2_fused):
    """The folded serving module on the card (both kernels, cuDNN between
    them) against the same module on the CPU (plain versions): atol 1e-5."""
    from p2igan_tpu_torch.models import SimpleGenerator
    from p2igan_tpu_torch.ops.dec2_stencil import conv3d_cout1_sigmoid
    from p2igan_tpu_torch.ops.enc0_conv import enc0_conv3d_leaky

    rng = np.random.default_rng(4)
    gen = SimpleGenerator(base_channels=16, dec2_fused=dec2_fused,
                          generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for block in gen.encoder:
            block[1].weight.uniform_(0.7, 1.3)
            block[1].bias.normal_(std=0.2)
            block[1].running_mean.normal_(std=0.1)
            block[1].running_var.uniform_(0.5, 2.0)
    masks = (rng.random((3, 4, 24, 40, 1)) < 0.3).astype(np.float32)
    masked = rng.random((3, 4, 24, 40, 1), dtype=np.float32) * masks
    folded = gen.fold_for_inference()
    with torch.inference_mode():
        want = folded(torch.from_numpy(masked), torch.from_numpy(masks))
        before = (enc0_conv3d_leaky.launches, conv3d_cout1_sigmoid.launches)
        got = folded.to(dev)(torch.from_numpy(masked).to(dev),
                             torch.from_numpy(masks).to(dev))
    torch.cuda.synchronize()
    assert (enc0_conv3d_leaky.launches - before[0],
            conv3d_cout1_sigmoid.launches - before[1]) == (1, int(dec2_fused))
    assert float((got.cpu() - want).abs().max()) <= 1e-5


# -- the generic IDW k-NN (csrc/idw_knn_cells.cu, idw_scatter.cu) -------------

def _knn_inputs(kind, B, shape, P, n_valid, dev, seed=0):
    """prep_points of B samples: random points, or points on the query
    lattice (the observed voxels of a random mask: every unobserved frame sees
    exact +-z ties); the first ``n_valid`` slots valid."""
    from p2igan_tpu_torch.ops import idw_kernel as IK
    from p2igan_tpu_torch.ops.idw import extract_points

    rng = np.random.default_rng(seed)
    if kind == "lattice":
        D, H, W = shape
        mask = np.zeros((B, D * H * W), np.float32)
        for b in range(B):
            mask[b, rng.choice(D * H * W, P, replace=False)] = 1.0
        pts = extract_points(torch.from_numpy(mask.reshape(B, D, H, W)),
                             torch.zeros(B, D, H, W), P)[0]
    else:
        pts = torch.from_numpy(rng.random((B, P, 3)).astype(np.float32))
    vals = torch.from_numpy(rng.normal(size=(B, P)).astype(np.float32))
    valid = torch.from_numpy(np.arange(P)[None].repeat(B, 0) < n_valid)
    pts4, pv = IK.prep_points(pts, vals * valid, valid)
    return pts4.to(dev), pv.to(dev)


KNN_CASES = [("random", None), ("lattice", None), ("random", 2), ("random", 0)]


@pytest.mark.parametrize("kind,n_valid", KNN_CASES)
@pytest.mark.parametrize("B,shape,P", [(3, (2, 17, 17), 300), (2, (16, 128, 128), 4096)])
def test_idw_knn_single_kernel_bitwise(dev, kind, n_valid, B, shape, P):
    """#8's range (P <= 4096), now the cell search, against the brute-force
    plain version on the card: out, sel_idx and w_norm bitwise (one
    arithmetic, every rounding spelled out), ties, fewer than k valid points
    and an empty sample included."""
    from p2igan_tpu_torch.ops import idw_kernel as IK

    pts4, pv = _knn_inputs(kind, B, shape, P, P if n_valid is None else n_valid, dev)
    before = IK.idw_knn_single.launches
    got, none = IK.idw_knn_single(pts4, pv, shape)
    assert IK.idw_knn_single.launches == before + 1 and none is None
    want, (rsel, rw) = IK.idw_knn_single_reference(pts4, pv, shape, with_sel=True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    out, (sel, w_norm) = IK.idw_knn_single(pts4, pv, shape, with_sel=True)
    assert torch.equal(out, got) and torch.equal(sel, rsel)
    assert torch.equal(w_norm.view(torch.int32), rw.view(torch.int32))
    if n_valid == 0:
        assert not bool(got.any())


@pytest.mark.parametrize("kind,n_valid", KNN_CASES)
@pytest.mark.parametrize("B,shape,P", [(2, (4, 40, 40), 4596), (1, (16, 128, 128), 65536),
                                       (2, (3, 19, 37), 700)])
def test_idw_knn_chunked_kernel_bitwise(dev, kind, n_valid, B, shape, P):
    """Kernel #9 against its plain version on the card: out, sel_idx and
    w_norm bitwise; without the selection it writes the same output."""
    from p2igan_tpu_torch.ops import idw_kernel as IK

    pts4, pv = _knn_inputs(kind, B, shape, P, P if n_valid is None else n_valid, dev)
    got, (sel, w_norm) = IK.idw_knn_chunked(pts4, pv, shape, with_sel=True)
    want, (rsel, rw) = IK.idw_knn_chunked_reference(pts4, pv, shape)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(sel, rsel)
    assert torch.equal(w_norm.view(torch.int32), rw.view(torch.int32))
    before = IK.idw_knn_chunked.launches
    alone, none = IK.idw_knn_chunked(pts4, pv, shape)
    assert none is None and IK.idw_knn_chunked.launches == before + 1
    assert torch.equal(alone, got)


def _frame_mask_points(kind, B, shape, seed):
    """prep_points of B windows under ``kind`` masks drawn as the loaders draw
    them (data/masks.py, the shipped configs' keep 4, block 10, intervals
    2..6), their observed voxels in a budget of the largest count."""
    from p2igan_tpu_torch.data.masks import create_mask_np
    from p2igan_tpu_torch.ops import idw_kernel as IK
    from p2igan_tpu_torch.ops.idw import extract_points

    rng = np.random.default_rng(seed)
    masks = np.stack([create_mask_np(shape + (1,), rng, kind, block_sizes=[10], keep=4,
                                     interval=[2, 3, 4, 5, 6])[..., 0] for _ in range(B)])
    P = max(int(masks.reshape(B, -1).sum(1).max()), 1)
    vals = rng.random(masks.shape).astype(np.float32) * masks
    pts, v, valid = extract_points(torch.from_numpy(masks), torch.from_numpy(vals), P)
    return IK.prep_points(pts, v, valid)


@pytest.mark.parametrize("kind", ["fi", "stin", "nowcasting"])
def test_idw_knn_chunked_frame_masks_bitwise(dev, kind):
    """#9 (the cell search) on the masks that take it, bitwise against the
    brute-force plain version: out, sel_idx and w_norm."""
    from p2igan_tpu_torch.ops import idw_kernel as IK

    shape = (16, 64, 64)
    pts4, pv = (t.to(dev) for t in _frame_mask_points(kind, 3, shape, 11))
    got, (sel, w_norm) = IK.idw_knn_chunked(pts4, pv, shape, with_sel=True)
    want, (rsel, rw) = IK.idw_knn_chunked_reference(pts4, pv, shape)
    assert torch.equal(sel, rsel)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(w_norm.view(torch.int32), rw.view(torch.int32))


def test_idw_knn_chunked_adversarial_bitwise(dev):
    """#9 on the CPU search model's adversarial cases (lattice ties on both
    +-z sides, four-way xy ties, 2 valid, empty, one cell, points outside
    [0, 1], duplicate coordinates), one launch over all of them, bitwise
    against the brute-force plain version, and its cell build against the
    plain build."""
    from p2igan_tpu_torch.ops import idw_kernel as IK
    from test_torch_idw_cells import CASES, SHAPE, _case

    rows = [_case(name) for name in CASES]
    Pp = max(r.shape[1] for r in rows)
    pad = torch.tensor([0.0, 0.0, 0.0, IK.PENALTY])
    pts4 = torch.cat([torch.cat([r, pad.expand(r.shape[0], Pp - r.shape[1], 4)], 1)
                      for r in rows]).contiguous().to(dev)
    pv = torch.from_numpy(np.random.default_rng(4).normal(size=pts4.shape[:2])
                          .astype(np.float32)).to(dev) * (pts4[..., 3] == 0)
    got, (sel, w_norm) = IK.idw_knn_chunked(pts4, pv, SHAPE, with_sel=True)
    want, (rsel, rw) = IK.idw_knn_chunked_reference(pts4, pv, SHAPE)
    assert torch.equal(sel, rsel)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(w_norm.view(torch.int32), rw.view(torch.int32))
    dims = IK.cell_dims(*SHAPE)
    count, start, order, lo, hi = IK.idw_cell_build(pts4, dims)
    rcount, rstart, rorder, rlo, rhi = IK.cell_build_reference(pts4, dims)
    assert torch.equal(count, rcount) and torch.equal(start, rstart)
    assert bool((lo == rlo).all()) and bool((hi == rhi).all())
    for b in range(pts4.shape[0]):
        for c in range(count.shape[1]):
            s, n = int(start[b, c]), int(count[b, c])
            got_members = order[b, s:s + n]
            if c < count.shape[1] - 1:  # any order within a valid cell
                got_members = got_members.sort().values
            assert torch.equal(got_members, rorder[b, s:s + n])


@pytest.mark.parametrize("kind", ["random", "lattice"])
def test_idw_knn_chunked_equals_single(dev, kind):
    """#9 at P <= 4096 gives the output of #8's function bit for bit: the
    brute-force plain version's, which the single-pass range also returns."""
    from p2igan_tpu_torch.ops import idw_kernel as IK

    shape = (16, 64, 64)
    pts4, pv = _knn_inputs(kind, 3, shape, 3200, 3100, dev, seed=1)
    out, _ = IK.idw_knn_chunked(pts4, pv, shape)
    want, _ = IK.idw_knn_single_reference(pts4, pv, shape)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert torch.equal(out, IK.idw_knn_single(pts4, pv, shape)[0])


@pytest.mark.parametrize("kind,n_valid", KNN_CASES)
@pytest.mark.parametrize("B,shape,P", [(3, (2, 17, 17), 300), (2, (16, 128, 128), 3200),
                                       (1, (16, 64, 64), 9000)])
def test_idw_knn_bwd_kernel(dev, kind, n_valid, B, shape, P):
    """Kernel #10 (``scatter_selection``, the scatter of the forward's saved
    selection) against its plain version (``index_add_``) and the recomputing
    statement of the TPU kernel's function (``idw_knn_bwd_reference``): each
    sample's max abs error <= 1e-5 x the largest sum of |terms| a point of it
    receives (the backward of |g|), since the kernel sums in 64-bit fixed
    point and they in float32 (and w_norm * g rounds otherwise than
    w * (g / sum w)), and with fewer than k valid points one point takes a
    term from every query. Order-free: a second launch and a launch on the
    queries in another order give the same bits, on the tile (Pp <= 4096) and
    the global path (above). The linearity identity <dv, v> == <g, f(v)>,
    within 1e-5 x <|g|, f(|v|)>."""
    from p2igan_tpu_torch.ops import idw_kernel as IK

    pts4, pv = _knn_inputs(kind, B, shape, P, P if n_valid is None else n_valid, dev)
    Pp, Q = pts4.shape[1], shape[0] * shape[1] * shape[2]
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(B, Q))
                         .astype(np.float32)).to(dev)
    out, (sel, w_norm) = IK.idw_knn_chunked(pts4, pv, shape, with_sel=True)
    before = IK.scatter_selection.launches
    got = IK.scatter_selection(sel, w_norm, g, Pp)
    assert IK.scatter_selection.launches == before + 1
    mass = IK.scatter_selection_reference(sel, w_norm, g.abs(), Pp).amax(dim=1, keepdim=True)
    assert bool((mass > 0).all())
    for want in (IK.scatter_selection_reference(sel, w_norm, g, Pp),
                 IK.idw_knn_bwd_reference(pts4, g, shape)):
        assert bool(((got - want).abs() <= 1e-5 * mass).all())
    again = IK.scatter_selection(sel, w_norm, g, Pp)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    perm = torch.randperm(Q, generator=torch.Generator().manual_seed(3)).to(dev)
    shuffled = IK.scatter_selection(sel[:, perm].contiguous(), w_norm[:, perm].contiguous(),
                                    g[:, perm].contiguous(), Pp)
    assert torch.equal(shuffled.view(torch.int32), got.view(torch.int32))
    rhs = float((g.double() * out.double()).sum())
    bound = 1e-5 * float((g.abs().double() *
                          IK.idw_knn_chunked(pts4, pv.abs(), shape)[0].double()).sum())
    assert abs(float((got.double() * pv.double()).sum()) - rhs) <= bound


@pytest.mark.parametrize("Pp", [384, 8192])
def test_idw_scatter_zero_and_non_finite_cotangents(dev, Pp):
    """#10 on a cotangent of zeros gives zeros; a NaN or an infinity reaches
    exactly the points its terms touch, as the float32 plain version makes it
    (NaN for NaN or for +inf and -inf together), and every other point keeps
    the sum of its finite terms (tile and global path)."""
    from p2igan_tpu_torch.ops import idw_kernel as IK

    rng = np.random.default_rng(4)
    B, Q, k = 2, 5000, 4
    sel = torch.from_numpy(rng.integers(0, Pp, (B, Q, k)).astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.random((B, Q, k)).astype(np.float32)).to(dev)
    w = (w / w.sum(-1, keepdim=True)).contiguous()
    zero = IK.scatter_selection(sel, w, torch.zeros(B, Q, device=dev), Pp)
    assert not bool(zero.any()) and not bool(torch.signbit(zero).any())
    g = torch.from_numpy(rng.normal(size=(B, Q)).astype(np.float32)).to(dev)
    g[0, 10], g[0, 20], g[1, 30], g[1, 40] = (float("nan"), float("inf"), float("inf"),
                                              -float("inf"))
    got = IK.scatter_selection(sel, w, g, Pp)
    want = IK.scatter_selection_reference(sel, w, g, Pp)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-5 * float(want[fin].abs().max())


def test_idw_knn_wrappers_validate(dev):
    from p2igan_tpu_torch.ops import idw_kernel as IK

    pts4, pv = _knn_inputs("random", 2, (2, 8, 8), 5000, 5000, dev)
    with pytest.raises(ValueError, match="single pass"):   # Pp > 4096
        IK.idw_knn_single(pts4, pv, (2, 8, 8))
    small, sv = pts4[:, :256].contiguous(), pv[:, :256].contiguous()
    with pytest.raises(ValueError, match="unsupported k"):
        IK.idw_knn_chunked(small, sv, (2, 8, 8), k=9)
    with pytest.raises(TypeError):
        IK.idw_knn_single(small.double(), sv.double(), (2, 8, 8))
    with pytest.raises(ValueError):
        IK.idw_knn_single(small, sv.cpu(), (2, 8, 8))                    # mixed devices
    with pytest.raises(ValueError):
        IK.idw_knn_single(small[:, :, :3].contiguous(), sv, (2, 8, 8))  # rows of 3
    with pytest.raises(ValueError):
        IK.idw_knn_chunked(small, sv[:1], (2, 8, 8))                    # batch mismatch
    _, (sel, w_norm) = IK.idw_knn_single(small, sv, (2, 8, 8), with_sel=True)
    g = torch.zeros(2, 128, device=dev)
    with pytest.raises(ValueError):
        IK.scatter_selection(sel, w_norm, g[:, :64], 256)               # cotangent shape
    with pytest.raises(TypeError):
        IK.scatter_selection(sel.long(), w_norm, g, 256)


@pytest.mark.parametrize("P", [2048, 4480])
def test_generic_generator_gradients_on_the_card(dev, P):
    """A small generator on per-frame masks, forward and backward on the card
    (P <= 4096: #8's range, above: #9's; #10 the backward of both): every parameter gets a
    gradient, the output matches the CPU path within 1e-5 and input.*'s
    gradients within 1e-4 x max."""
    from p2igan_tpu_torch.data.masks import create_mask_np
    from p2igan_tpu_torch.models import P2IGenerator
    from p2igan_tpu_torch.ops import idw_kernel as IK

    rng = np.random.default_rng(8)
    kind, kw = ("nowcasting", {"keep": 2}) if P == 2048 else ("stin", {"keep": 4,
                                                                       "block_sizes": [4]})
    masks = np.stack([create_mask_np((8, 32, 32, 1), rng, kind, **kw) for _ in range(3)])
    frames = rng.random(masks.shape).astype(np.float32)
    outs, grads = {}, {}
    for d in ("cpu", dev):
        gen = P2IGenerator(H=32, W=32, length=8, num_res=1, base_channels=32,
                           idw_max_points=P,
                           generator=torch.Generator().manual_seed(0), device=d)
        m = torch.from_numpy(masks).to(d)
        f = torch.from_numpy(frames).to(d)
        before = (IK.idw_knn_single.launches, IK.idw_knn_chunked.launches,
                  IK.scatter_selection.launches)
        out = gen(f * m, m)
        (out - f).abs().mean().backward()
        after = (IK.idw_knn_single.launches, IK.idw_knn_chunked.launches,
                 IK.scatter_selection.launches)
        want = (0, 0, 0) if d == "cpu" else ((1, 0, 1) if P <= 4096 else (0, 1, 1))
        assert tuple(a - b for a, b in zip(after, before)) == want
        outs[str(d)] = out.detach().cpu()
        grads[str(d)] = {n: p.grad.cpu() for n, p in gen.named_parameters()}
        assert all(p.grad is not None for p in gen.parameters())
    assert float((outs["cpu"] - outs[str(dev)]).abs().max()) <= 1e-5
    for name, g in grads["cpu"].items():
        if name.startswith("input."):
            assert float(g.abs().max()) > 0
            assert float((g - grads[str(dev)][name]).abs().max()) <= \
                1e-4 * float(g.abs().max()), name


# -- the online evaluation path: the metric suite on the card -------------------

COUNT_LEAVES = ("n_obs", "ssim_n", "hits", "misses", "false", "correct", "counts")


def _rain_pair(rng, shape):
    """Normalized (preds, target) in [0, 60]: every threshold splits them;
    values whose transform is within 1e-5 of a threshold are drawn again, so
    the card's and the CPU's pow cannot flip a count."""
    def clear(x):
        while True:
            mm = 10.0 ** (x.astype(np.float64) * 0.0625) * 0.036
            near = np.zeros(x.shape, bool)
            for thr in (0.5, 2.0, 4.0, 8.0):
                near |= np.abs(mm / thr - 1.0) < 1e-5
            if not near.any():
                return x
            x[near] = rng.uniform(0.0, 60.0, int(near.sum())).astype(np.float32)

    target = rng.uniform(0.0, 60.0, shape).astype(np.float32)
    preds = np.clip(target + rng.normal(0.0, 6.0, shape), 0.0, 60.0).astype(np.float32)
    return clear(preds), clear(target)


def _assert_suites_agree(card, cpu):
    for part_card, part_cpu in zip(card.state, cpu.state):
        for key, val in part_card.items():
            assert val.device.type == "cuda" and val.dtype == torch.float32, key
            got, want = val.cpu().numpy(), part_cpu[key].numpy()
            if key in COUNT_LEAVES:
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
    got, want = card.compute(), cpu.compute()
    assert got.keys() == want.keys()
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, rtol=1e-5, atol=1e-12, err_msg=key)


def test_metric_suite_card_equals_cpu(dev):
    """Counts exactly, sums and SSIM within rtol 1e-5, on inputs that cross
    every threshold; an update waits for nothing on the card (it runs under
    the sync debug mode "error")."""
    from p2igan_tpu_torch.metrics import RainfallMetricSuite

    rng = np.random.default_rng(11)
    card, cpu = RainfallMetricSuite(device=dev), RainfallMetricSuite(device="cpu")
    for channels in (1, 2):
        preds, target = _rain_pair(rng, (2, 4, 32, 32, channels))
        p_card, t_card = torch.from_numpy(preds).to(dev), torch.from_numpy(target).to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card.update(p_card, t_card)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        cpu.update(torch.from_numpy(preds), torch.from_numpy(target))
    for key in ("hits", "misses", "false", "correct"):
        assert bool((cpu.state[1][key] > 0).all()), key
    _assert_suites_agree(card, cpu)


class _Recorder:
    def __init__(self):
        self.metrics = {}

    def log_metric(self, key, value, step=None):
        self.metrics[key] = (value, step)

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


@pytest.mark.parametrize("model", ["p2igan", "dk", "simple"])
def test_evaluate_rec_loss_with_eval_metrics_on_the_card(dev, tmp_path, monkeypatch, model):
    """train.eval_metrics on the card: every validation batch's prediction
    goes into a suite on the card, whose val/* keys equal a CPU suite's on
    the same tensors (counts exactly, the rest within rtol 1e-5)."""
    from p2igan_tpu_torch.data import fake
    from p2igan_tpu_torch.metrics import RainfallMetricSuite
    from p2igan_tpu_torch.training.trainer import Trainer

    monkeypatch.setenv("P2IGAN_FORCE_FILE_TRACKER", "1")
    T, HW = 4, 32
    fake.write_train_zarr(tmp_path / "train.zarr", n_events=2, T=12, H=HW, W=HW, window=T,
                          stride=2, seed=0)
    fake.write_gauge_mask(tmp_path / "gauges.txt", H=HW, W=HW, n_gauges=79, seed=1)
    cfg = {"seed": 7, "save_dir": str(tmp_path / "w"),
           "model": {"name": model, "in_channels": 1, "out_channels": 1,
                     "base_channels": 4 * T},
           "data": {"train": {"data_root": str(tmp_path / "train.zarr"), "w": HW, "h": HW,
                              "sample_length": T,
                              "mask": {"type": "stis", "file": str(tmp_path / "gauges.txt")}}},
           "loss": {"adversarial_weight": 0.01, "k1_weight": 0.05, "gan_loss": "hinge",
                    "use_gan": 0},
           "train": {"optimizer": {"beta1": 0.0, "beta2": 0.99, "lr": 1e-4},
                     "batch_size": 2, "num_workers": 2, "iterations": 1,
                     "use_validation": True, "eval_metrics": True}}
    seen = []
    update = RainfallMetricSuite.update

    def recording(self, preds, target):
        assert self.device.type == "cuda" and preds.is_cuda and target.is_cuda
        seen.append((preds.cpu(), target.cpu()))
        return update(self, preds, target)

    monkeypatch.setattr(RainfallMetricSuite, "update", recording)
    tr = Trainer(cfg, device=dev)
    tr.tracker = _Recorder()
    loss = tr._evaluate_rec_loss(tr.val_loader)
    assert np.isfinite(loss) and len(seen) == len(tr.val_loader) >= 1
    cpu = RainfallMetricSuite(device="cpu")
    for preds, target in seen:
        update(cpu, preds, target)  # not the recording wrapper
    want = cpu.compute()
    got = {k[4:]: v for k, (v, step) in tr.tracker.metrics.items()}
    assert got.keys() == want.keys()
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, rtol=1e-5, atol=1e-12, err_msg=key)


# -- the bf16 options: #3 on bfloat16, the bf16 critic ---------------------------


@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("shape", [(8, 64, 128, 128), (12, 256, 32, 32), (3, 5, 6, 10),
                                   (2, 3, 8, 6), (1, 1, 2, 2), (1, 70000, 16, 128)])
def test_pool_dup_bf16_kernel_bitwise(dev, shape, offset):
    """The bf16 instantiation of #3, forward and backward bitwise its plain
    version (``max_pool2d`` -> ``repeat_interleave`` on bf16), NaN and +-0
    included: the 8-byte form (W % 4 == 0, 8-byte aligned), the 4-byte form
    (rows of 6 or 10 or 2, or an input offset by two elements), more planes
    than grid.z holds."""
    n = int(np.prod(shape))
    x = torch.randn(n + offset, device=dev).to(torch.bfloat16)[offset:].view(shape)
    x.view(-1)[::7] = 0.0
    x.view(-1)[1::11] = -0.0
    x.view(-1)[3::101] = float("nan")
    before = (maxpool2_duplicate.launches, maxpool2_duplicate.bf16_launches)
    got, want = maxpool2_duplicate(x), maxpool2_duplicate_reference(x)
    assert (maxpool2_duplicate.launches, maxpool2_duplicate.bf16_launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    xa, xr = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    y = maxpool2_duplicate(xa)
    assert type(y.grad_fn).__name__ == "_MaxPool2DuplicateBackward"
    gy = torch.randn(y.shape, device=dev).to(torch.bfloat16)
    y.backward(gy)
    maxpool2_duplicate_reference(xr).backward(gy)
    assert torch.equal(xa.grad.view(torch.int16), xr.grad.view(torch.int16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        maxpool2_duplicate(x.to(torch.float16))


def test_gan_step_with_the_bf16_critic_card_equals_cpu(dev):
    """One hinge-GAN step (32x32, base 16, T=4, batch 2, a shared 9-gauge
    mask) with the critic's 3-D branch in bf16, from the same state on the
    card (kernels, cuDNN in bf16) and on the CPU (plain versions, oneDNN in
    bf16), held as ``tests/test_torch_bf16.py`` holds it against the JAX
    package: losses rtol 2e-2; the parameters within 2 lr everywhere (Adam's
    first step) and within 1e-2 lr where the two gradients agree in sign and
    clear 1e-3 x max and 100 x eps; the generator's and the 2-D branch's
    gradients within 2e-2 x max of each tensor; the 3-D branch's gradient
    signs agree on 99% of its elements above 100 x eps."""
    from p2igan_tpu_torch.models import P2IDiscriminator, P2IGenerator
    from p2igan_tpu_torch.training import steps as tsteps

    T, hw, lr, eps = 4, 32, 1e-4, 1e-8
    rng = np.random.default_rng(11)
    flat = np.zeros(hw * hw, np.float32)
    flat[rng.choice(hw * hw, 9, replace=False)] = 1.0
    masks = np.broadcast_to(flat.reshape(1, 1, hw, hw, 1), (2, T, hw, hw, 1)).copy()
    frames = rng.random((2, T, hw, hw, 1), dtype=np.float32)
    kw = dict(H=hw, W=hw, length=T, num_res=1, base_channels=16, idw_max_points=128,
              idw_factored=True, idw_shared_batch_mask=True)
    gen0 = P2IGenerator(**kw, generator=torch.Generator().manual_seed(0))
    disc0 = P2IDiscriminator(in_channels=T, branch3d_dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(1))
    with torch.no_grad():  # a few power iterations: sigma well conditioned
        for _ in range(3):
            disc0(torch.from_numpy(frames), update_stats=True)
    runs = {}
    for d in ("cpu", dev):
        gen = P2IGenerator(**kw, device=d)
        gen.load_state_dict(gen0.state_dict())
        disc = P2IDiscriminator(in_channels=T, branch3d_dtype=torch.bfloat16, device=d)
        disc.load_state_dict(disc0.state_dict())
        cfg = {"lr": lr, "beta1": 0.0, "beta2": 0.99}
        step = tsteps.build_train_step(
            gen, disc, tsteps.make_optimizer(cfg, gen.parameters()),
            tsteps.make_optimizer(cfg, disc.parameters()), use_gan=True,
            gan_loss_type="hinge", adversarial_weight=0.01, k1_alpha=0.05)
        m = step(*(torch.from_numpy(a).to(d) for a in (frames, frames * masks, masks)))
        runs[str(d)] = ({k: float(v) for k, v in m.items()}, gen, disc)
    (mc, gc, dc), (mg, gg, dg) = runs["cpu"], runs[str(dev)]
    for key in ("loss", "rec_loss", "adv_loss", "dis_loss"):
        np.testing.assert_allclose(mg[key], mc[key], rtol=2e-2, err_msg=key)
    signs = []
    for mod_c, mod_g in ((gc, gg), (dc, dg)):
        card = dict(mod_g.named_parameters())
        for name, p in mod_c.named_parameters():
            q = card[name]
            assert q.dtype == torch.float32
            np.testing.assert_allclose(q.detach().cpu().numpy(), p.detach().numpy(),
                                       rtol=0, atol=2.0001 * lr, err_msg=name)
            if p.grad is None:
                continue
            g, w = q.grad.cpu().numpy(), p.grad.numpy()
            same = ((np.sign(g) == np.sign(w))
                    & (np.minimum(np.abs(g), np.abs(w)) > max(1e-3 * np.abs(w).max(),
                                                              100 * eps)))
            np.testing.assert_allclose(q.detach().cpu().numpy()[same],
                                       p.detach().numpy()[same], rtol=0, atol=1e-2 * lr,
                                       err_msg=name)
            if name.startswith("d3d."):
                signs.append((np.sign(g) == np.sign(w))[np.abs(w) > 100 * eps])
            else:
                assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), name
    assert np.concatenate(signs).mean() >= 0.99


# -- the offline evaluation suite: card against CPU --------------------------

@pytest.mark.parametrize("pool8", [True, False])
@pytest.mark.parametrize("mode", ["radar", "gauge"])
def test_offline_suite_card_equals_cpu(dev, mode, pool8):
    """run_exp1 and exp3's metrics on the card against the CPU on the same
    stores (a missing and a short event, non-finite pixels)."""
    from p2igan_tpu_torch.experiments.compare import suite_mismatches
    from p2igan_tpu_torch.experiments.exp1 import run_exp1
    from p2igan_tpu_torch.experiments.exp3 import exp3_metrics

    rng = np.random.default_rng(4)
    truth = {f"event_{i + 1:02d}": (rng.random((12, 48, 48)) * 160).astype(np.float32)
             for i in range(3)}
    preds = {"A": {k: (v + rng.normal(0, 10, v.shape)).astype(np.float32)[..., None]
                   for k, v in truth.items()},
             "B": {"event_01": truth["event_01"][:7] * np.float32(1.1),
                   "event_03": truth["event_03"] + np.float32(4.0)}}
    preds["A"]["event_02"][1, 5:9] = np.nan
    mask = np.zeros((40, 40), bool)
    mask.reshape(-1)[rng.choice(1600, 79, replace=False)] = True
    got, want = (run_exp1(preds, truth, mask, mode, 40, use_pool8=pool8, device=d)
                 for d in (dev, "cpu"))
    assert not suite_mismatches(got, want)
    assert got["A"]["CAT_0.5"]["CSI"] > 0.3
    got, want = (exp3_metrics(preds, truth, mask, mode, 40, device=d) for d in (dev, "cpu"))
    assert not suite_mismatches(got, want)
