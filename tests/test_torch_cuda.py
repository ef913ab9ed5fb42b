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


@pytest.mark.parametrize("kind", ["79", "grid", "2"])
@pytest.mark.parametrize("D,N,k", [(16, 8, 4), (4, 3, 4), (1, 1, 4), (16, 70, 3)])
def test_combine_table_multi_kernel(dev, kind, D, N, k):
    rng = np.random.default_rng(1)
    mask = torch.from_numpy(_mask(kind, 24, 40, rng)).to(dev)
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


@pytest.mark.parametrize("shape", [(8, 64, 128, 128), (3, 5, 6, 10), (1, 1, 2, 2)])
def test_pool_dup_kernel_bitwise(dev, shape):
    x = torch.randn(shape, device=dev)
    x.view(-1)[::7] = 0.0
    x.view(-1)[1::11] = -0.0
    x.view(-1)[3::101] = float("nan")
    got, want = maxpool2_duplicate(x), maxpool2_duplicate_reference(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kind", ["79", "grid", "2"])
@pytest.mark.parametrize("D,N,k", [(16, 12, 4), (4, 3, 4), (16, 40, 3), (1, 1, 4)])
def test_combine_table_multi_bwd_kernel(dev, kind, D, N, k):
    """Kernel #4 against its plain version (autograd of the unpruned plain
    combine): max abs error <= 1e-5 x max|plain|, because the sums run in
    another order (shared-memory atomics, then per-block partials)."""
    rng = np.random.default_rng(5)
    mask = torch.from_numpy(_mask(kind, 40, 24, rng)).to(dev)
    gd2, gsel, _ = factored_prepare_full(mask, 128, k=k)
    g = torch.from_numpy(rng.normal(size=(N, D, 40 * 24)).astype(np.float32)).to(dev)
    args = (gd2.t().contiguous(), gsel.t().contiguous(), g, 128, k)
    before = K.combine_table_multi_bwd.launches
    got = K.combine_table_multi_bwd(*args)
    want = K.combine_table_multi_bwd_reference(*args)
    assert K.combine_table_multi_bwd.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


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


@pytest.mark.parametrize("D,G,k", [(16, 128, 4), (16, 1152, 4), (4, 256, 4), (1, 128, 4),
                                   (16, 128, 3)])
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


@pytest.mark.parametrize("D,G,k", [(16, 128, 4), (16, 1152, 4), (4, 256, 4), (16, 128, 3)])
def test_combine_table_bwd_kernel(dev, D, G, k):
    """Kernel #6 against its plain version (autograd of the unpruned plain
    combine): max abs error <= 1e-5 x max|plain| (shared-memory atomics, then
    per-block partials: another order of the sums). Through autograd the
    output carries a grad_fn and the table receives that gradient."""
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
    tables = torch.randn(4, D, G, device=dev, requires_grad=True)
    out = K.combine_table(gd2_t, gsel_t, tables, k)
    assert type(out.grad_fn).__name__ == "_CombineTableBackward"
    out.backward(g)
    assert float((tables.grad - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(ValueError, match="shared memory"):
        K.combine_table_bwd(gd2_t, gsel_t, g, 100000, k)


@pytest.mark.parametrize("kind", ["79", "grid", "2", "empty"])
@pytest.mark.parametrize("D,k", [(16, 4), (4, 4), (1, 4), (16, 3)])
def test_combine_dense_kernel_bitwise(dev, kind, D, k):
    """Kernel #7 (through idw_3d_factored) against its plain version and the
    CPU path: bitwise; its gradient (autograd of the plain version on the
    card) reaches the field and equals the CPU path's within 1e-5 x max."""
    from p2igan_tpu_torch.ops.idw import factored_prepare, idw_3d_factored

    rng = np.random.default_rng(3)
    mask = torch.from_numpy(_mask(kind, 24, 40, rng))
    values = torch.from_numpy(rng.normal(size=(D, 24, 40)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(D, 24, 40)).astype(np.float32))
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
    want = K.combine_dense_reference(gd2_t, cvals_t, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
                           idw_max_points=512, idw_shared_batch_mask=False,
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
# the thread grid's 104 columns, and the models' own h = 100
TAIL_SHAPES = [(256, 6, 100), (1000, 5, 100), (77, 3, 40), (130, 2, 102), (64, 1, 8)]


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
    """Partials are summed in block order, so two runs agree bit for bit."""
    from p2igan_tpu_torch.ops import dk_mlp_kernel as M

    phi, off, fc2, b2, fc3, b3, fc4, _ = _tail_inputs(700, 9, 100, dev)
    g = torch.ones((9, 700), device=dev)
    first = M.mlp_tail_bwd(phi, off, g, fc2, b2, fc3, b3, fc4)
    second = M.mlp_tail_bwd(phi, off, g, fc2, b2, fc3, b3, fc4)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_mlp_tail_rejects_what_the_kernel_does_not_take(dev):
    from p2igan_tpu_torch.ops import dk_mlp_kernel as M

    args = list(_tail_inputs(64, 2, 100, dev))
    with pytest.raises(ValueError):
        M.mlp_tail_fused(*_tail_inputs(64, 2, 120, dev))       # h > 104
    wide = _tail_inputs(64, 2, 104, dev)                       # fits the forward only
    assert M.mlp_tail_fused(*wide).shape == (2, 64)
    with pytest.raises(ValueError):
        M.mlp_tail_bwd(*wide[:2], torch.ones((2, 64), device=dev), *wide[2:7])
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
# temporal edge is hit, Cin 1..4, Cout off the 32-channel pass
ENC0_SHAPES = [(2, 4, 16, 16, 2, 16), (3, 3, 37, 45, 3, 40), (4, 1, 16, 33, 1, 8),
               (2, 5, 17, 64, 4, 64), (1, 16, 128, 128, 2, 64)]


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


DEC2_SHAPES = [(2, 4, 16, 16, 8), (3, 3, 37, 45, 5), (4, 1, 16, 33, 1),
               (2, 5, 33, 130, 16), (1, 16, 128, 128, 64)]


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
