"""The dk/stdk ops of the PyTorch port vs the JAX package, on the CPU.

Inputs come from numpy seeds. The Wendland bases must equal the JAX package's
arrays exactly (the same numpy code). The fused MLP tail runs its plain
version here (a CPU tensor); it is held to the JAX ``mlp_tail_reference`` at
atol 1e-5 and to the JAX Pallas kernel in interpret mode at the JAX package's
own 2e-5; its eight gradients to ``jax.grad`` of the reference at rtol 2e-4
(the sums over J*HW terms run in another order). ``select_visible`` must
equal ``jax.lax.top_k``'s lowest-index tie order exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2igan_tpu.models import dk as jdk
from p2igan_tpu.ops import wendland as jw
from p2igan_tpu.ops.pallas import dk_mlp_kernel as jtail
from p2igan_tpu_torch.models import dk as tdk
from p2igan_tpu_torch.ops import dk_mlp_kernel as ttail
from p2igan_tpu_torch.ops import wendland as tw

HW, J, HID = 256, 6, 100


@pytest.mark.parametrize("H,W", [(128, 128), (32, 32), (20, 13)])
def test_phi_space_equals_jax(H, W):
    got, want = tw.build_phi_space(H, W), jw.build_phi_space(H, W)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if (H, W) == (128, 128):
        assert got.shape == (128 * 128, 139)


@pytest.mark.parametrize("T", [16, 4, 7])
def test_phi_time_equals_jax(T):
    np.testing.assert_array_equal(tw.build_phi_time(T), jw.build_phi_time(T))
    assert tw.time_basis_count(T) == jw.time_basis_count(T)
    assert tw.build_phi_time(T).shape == (T, tw.time_basis_count(T))
    if T == 16:
        assert tw.time_basis_count(T) == 44


def test_basis_arrays_are_cached():
    assert tw.build_phi_space(32, 32) is tw.build_phi_space(32, 32)
    assert tw.build_phi_time(4) is tw.build_phi_time(4)


def _tail_args(seed=0, hw=HW, j=J, h=HID):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return (f32(rng.normal(size=(hw, h))), f32(rng.normal(size=(j, h))),
            f32(rng.normal(size=(h, h)) * 0.1), f32(rng.normal(size=(h,))),
            f32(rng.normal(size=(h, h)) * 0.1), f32(rng.normal(size=(h,))),
            f32(rng.normal(size=(h,))), np.float32(0.37))


def test_mlp_tail_matches_jax_reference():
    args = _tail_args()
    want = np.asarray(jtail.mlp_tail_reference(*map(jnp.asarray, args)))
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    before = ttail.mlp_tail_fused.launches
    got = ttail.mlp_tail_fused(*targs)
    assert ttail.mlp_tail_fused.launches == before  # the plain version ran
    assert got.shape == (J, HW) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # a chunk that does not divide J walks the same rows
    np.testing.assert_allclose(ttail.mlp_tail_reference(*targs, chunk=4).numpy(),
                               got.numpy(), rtol=0, atol=1e-6)


def test_mlp_tail_matches_jax_pallas_kernel_interpreted():
    """The TPU kernel itself, as tests/test_pallas.py runs it on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    args = _tail_args(seed=1, hw=300, j=11)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jtail.mlp_tail_fused(*map(jnp.asarray, args),
                                               use_pallas=True))
    got = ttail.mlp_tail_fused(*[torch.from_numpy(np.asarray(a)) for a in args])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


GRAD_NAMES = ["phi", "off", "fc2", "b2", "fc3", "b3", "fc4", "b4"]


@pytest.fixture(scope="module")
def tail_grads():
    args = _tail_args(seed=2)
    w = np.random.default_rng(3).normal(size=(J, HW)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jnp.asarray(w) * jtail.mlp_tail_reference(*a)),
                    argnums=tuple(range(8)))(*map(jnp.asarray, args))
    targs = [torch.from_numpy(np.asarray(a)).requires_grad_(True) for a in args]
    (torch.from_numpy(w) * ttail.mlp_tail_fused(*targs)).sum().backward()
    bwd = ttail.mlp_tail_bwd(*[t.detach() for t in targs[:2]], torch.from_numpy(w),
                             *[t.detach() for t in targs[2:7]])
    return ({n: np.asarray(g) for n, g in zip(GRAD_NAMES, want)},
            {n: t.grad.numpy() for n, t in zip(GRAD_NAMES, targs)},
            dict(zip(["phi", "off", "fc2", "b2", "fc3", "b3", "fc4"],
                     [g.numpy() for g in bwd])))


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_mlp_tail_gradient_matches_jax(tail_grads, name):
    want, got, bwd = tail_grads
    scale = np.abs(want[name]).max()
    np.testing.assert_allclose(got[name], want[name], rtol=2e-4, atol=2e-4 * scale,
                               err_msg=name)
    if name != "b4":  # mlp_tail_bwd leaves db4 = sum g to its caller
        np.testing.assert_allclose(bwd[name], want[name], rtol=2e-4,
                                   atol=2e-4 * scale, err_msg=name)


def test_mlp_tail_relu_gradient_is_zero_at_zero():
    """An activation at exactly zero passes no gradient (h > 0), as
    jax.nn.relu and the kernels' masks."""
    h = 4
    phi = torch.zeros((3, h), requires_grad=True)
    off = torch.zeros((2, h), requires_grad=True)
    eye, zero = torch.eye(h), torch.zeros(h)
    out = ttail.mlp_tail_fused(phi, off, eye, zero, eye, zero, torch.ones(h),
                               torch.zeros(()))
    out.sum().backward()
    assert float(phi.grad.abs().max()) == 0.0 and float(off.grad.abs().max()) == 0.0


def _mask(rng, b, t, hw, n_ones, shared):
    m = np.zeros((b, t, hw), np.float32)
    if shared:
        m[:, :, rng.choice(hw, n_ones, replace=False)] = 1.0
    else:
        for i in range(b):
            for j in range(t):
                m[i, j, rng.choice(hw, n_ones, replace=False)] = 1.0
    return m


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n_ones", [7, 12, 3, 0])
def test_select_visible_equals_jax(shared, n_ones):
    """k = 7 of n_ones observed pixels: exactly k, more than k (the first k in
    ascending index win the tie), fewer than k and none (lowest-index zeros
    fill up, as jax.lax.top_k does)."""
    rng = np.random.default_rng(10 + n_ones)
    b, t, hw, k = 2, 3, 64, 7
    m = _mask(rng, b, t, hw, n_ones, shared)
    x = rng.random((b, t, hw)).astype(np.float32)
    want = np.asarray(jdk.select_visible(jnp.asarray(x), jnp.asarray(m), k, shared))
    got = tdk.select_visible(torch.from_numpy(x), torch.from_numpy(m), k, shared)
    assert got.shape == (b, t, k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_visible_carries_the_gradient_to_the_frames():
    rng = np.random.default_rng(4)
    m = torch.from_numpy(_mask(rng, 1, 2, 32, 5, True))
    x = torch.from_numpy(rng.random((1, 2, 32)).astype(np.float32)).requires_grad_(True)
    tdk.select_visible(x, m, 5, True).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), m.numpy())


def test_tail_shared_memory_fits_the_card_at_hidden_100():
    """The launchers opt in to this much dynamic shared memory; both must fit
    the 227 KB a block may use, the backward at every hidden width it takes
    (its operands are padded to 104)."""
    assert ttail.fwd_shared_bytes(100) <= ttail.MAX_SHARED_BYTES
    assert ttail.bwd_shared_bytes(100) <= ttail.MAX_SHARED_BYTES
    assert ttail.bwd_shared_bytes(ttail.MAX_HIDDEN) <= ttail.MAX_SHARED_BYTES
