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
