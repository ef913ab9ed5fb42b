"""The 3xTF32 split of kernel #13 (``csrc/dk_mlp_tail_bwd.cu`` on the tensor
cores through ``csrc/dk_mlp_mma.cuh``), modelled on the CPU and held against
float64.

``mma.sync`` multiplies TF32 operands (10 explicit mantissa bits) and adds in
float32. The kernel splits each float32 operand, hi = rna(x), lo = rna(x - hi)
(``cvt.rna.tf32.f32``: round to nearest on the 13 low bits, ties away from
zero), and forms lo*hi + hi*lo + hi*hi in float32. Each product of two TF32
values is exact in float32, so a float32 matrix product of the split halves
states the kernel's arithmetic up to the order of its sums. Here the six tile
products of the tail's backward (two recomputed, two transposed, two weight
gradients) go through that model at h = 100 and are held to the tolerances the
card tests state against float64 autograd (1e-4 x max|float64|, the strictest
of ``chip_smoke.py``'s and ``tests/test_torch_cuda.py``'s), and a single TF32
pass is shown to break them. The kernel runs on the card only;
``tests/test_torch_cuda.py`` holds it to its plain version there.
"""

import numpy as np
import pytest

NAMES = ("dphi", "doff", "dfc2", "db2", "dfc3", "db3", "dfc4")


def to_tf32(x):
    """float32 -> float32 holding the nearest TF32 value, ties away from zero
    (cvt.rna.tf32.f32): add half of the dropped 13 bits' range to the
    magnitude bits, then clear them. A carry into the exponent is the
    rounding up it should be; infinities and NaNs are left as they are."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32)
    finite = (bits & 0x7F800000) != 0x7F800000
    rounded = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(finite, rounded, bits).astype(np.uint32).view(np.float32)


def split(x):
    hi = to_tf32(x)
    return hi, to_tf32(np.asarray(x, np.float32) - hi)


def product(passes):
    """The tile product a @ b in float32: three TF32 passes (lo*hi, hi*lo,
    hi*hi, added in that order) or one (hi*hi)."""
    def mm(a, b):
        a_hi, a_lo = split(a)
        b_hi, b_lo = split(b)
        if passes == 1:
            return a_hi @ b_hi
        acc = a_lo @ b_hi
        acc = acc + a_hi @ b_lo
        return acc + a_hi @ b_hi
    return mm


def tail_backward(phi, off, g, fc2, b2, fc3, b3, fc4, mm):
    """The seven gradients as the kernel forms them, its six tile products
    through ``mm``, everything else elementwise in the inputs' type; rows are
    the (j, pixel) pairs. Masks from the recomputed outputs, zero at zero."""
    J, (HW, h) = off.shape[0], phi.shape
    relu = lambda x: np.maximum(x, 0)  # noqa: E731
    h1 = relu(phi[None] + off[:, None]).reshape(J * HW, h)
    h2 = relu(mm(h1, fc2) + b2)
    h3 = relu(mm(h2, fc3) + b3)
    gr = g.reshape(J * HW, 1)
    dfc4 = (h3 * gr).sum(0)
    da3 = np.where(h3 > 0, gr * fc4, 0).astype(h3.dtype)
    dfc3 = mm(h2.T, da3)
    da2 = np.where(h2 > 0, mm(da3, fc3.T), 0).astype(h2.dtype)
    dfc2 = mm(h1.T, da2)
    da1 = np.where(h1 > 0, mm(da2, fc2.T), 0).astype(h1.dtype).reshape(J, HW, h)
    return (da1.sum(0), da1.sum(1), dfc2, da2.sum(0), dfc3, da3.sum(0), dfc4), h2


def tail_inputs(HW=64, J=4, h=100, seed=0):
    """chip_smoke-like tail inputs: 256 (j, pixel) rows at the models' h."""
    rng = np.random.default_rng(seed)
    s = np.sqrt(2.0 / h)
    arr = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale  # noqa: E731
                                     ).astype(np.float32)
    return (arr(HW, h), arr(J, h), arr(J, HW), arr(h, h, scale=s), arr(h, scale=0.1),
            arr(h, h, scale=s), arr(h, scale=0.1), arr(h, scale=s))


def near_zero_tail_inputs(HW=256, J=4, h=100):
    """Tail inputs whose pre-activations sit near zero. Pixels 0-63 share one
    phi row, and b2 and b3 are set in float64 so that at j = 0 every second-
    and third-layer pre-activation of those pixels is +-(1-2)e-5: near zero,
    yet 10x beyond the rounding of a float32-accurate recompute (a single
    TF32 pass, off by ~1e-3 here, flips many of them). At j = 1, pixel 100
    has 50 first-layer pre-activations of exactly zero (off = -phi), where
    every version masks by "zero at zero". Returns phi, off, g, fc2, b2,
    fc3, b3, fc4 as float32 arrays."""
    rng = np.random.default_rng(21)
    s = np.sqrt(2.0 / h)
    phi = rng.standard_normal((HW, h)).astype(np.float32)
    phi[:64] = phi[0]
    off = rng.standard_normal((J, h)).astype(np.float32)
    off[1, :50] = -phi[100, :50]
    fc2 = (rng.standard_normal((h, h)) * s).astype(np.float32)
    fc3 = (rng.standard_normal((h, h)) * s).astype(np.float32)
    fc4 = (rng.standard_normal(h) * s).astype(np.float32)

    def near_zero():
        return rng.choice([-1.0, 1.0], h) * rng.uniform(1e-5, 2e-5, h)

    h1 = np.maximum(phi[0].astype(np.float64) + off[0], 0.0)
    b2 = (near_zero() - h1 @ fc2.astype(np.float64)).astype(np.float32)
    h2 = np.maximum(h1 @ fc2.astype(np.float64) + b2, 0.0)
    b3 = (near_zero() - h2 @ fc3.astype(np.float64)).astype(np.float32)
    g = rng.standard_normal((J, HW)).astype(np.float32)
    return phi, off, g, fc2, b2, fc3, b3, fc4


def relative_errors(args, passes):
    """max |model - float64| / max |float64| for each gradient."""
    got, _ = tail_backward(*args, mm=product(passes))
    want, _ = tail_backward(*(a.astype(np.float64) for a in args), mm=np.matmul)
    return {n: float(np.abs(a.astype(np.float64) - b).max() / np.abs(b).max())
            for n, a, b in zip(NAMES, got, want)}


def test_to_tf32_rounds_to_nearest_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)     # a TF32 ulp at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - ulp / 1024,
                  one + 3 * ulp / 2, np.float32(3.0) * 2 ** -100, np.inf, -np.inf],
                 np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + 2 * ulp,
                     np.float32(3.0) * 2 ** -100, np.inf, -np.inf], np.float32)
    np.testing.assert_array_equal(to_tf32(x), want)
    assert np.isnan(to_tf32(np.float32(np.nan)))
    v = np.random.default_rng(1).standard_normal(1000).astype(np.float32)
    t = to_tf32(v)
    assert not (t.view(np.uint32) & 0x1FFF).any()                 # 10 mantissa bits
    assert np.all(np.abs(t - v) <= np.abs(v) * 2.0 ** -11)
    hi, lo = split(v)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - v) <= np.abs(v) * 2.0 ** -21)


def test_split_products_are_exact_in_float32():
    """hi*hi, hi*lo and lo*hi of TF32 values need at most 22 significant
    bits, so the float32 products the model forms are the exact ones."""
    rng = np.random.default_rng(2)
    a, b = split(rng.standard_normal(4096).astype(np.float32))
    for x, y in ((a, b), (a, a[::-1]), (b, b[::-1])):
        exact = x.astype(np.float64) * y.astype(np.float64)
        np.testing.assert_array_equal((x * y).astype(np.float64), exact)


@pytest.mark.parametrize("seed", [0, 1])
def test_three_tf32_passes_keep_the_tails_tolerances(seed):
    errs = relative_errors(tail_inputs(seed=seed), passes=3)
    for name, e in errs.items():
        assert e <= 1e-4, (name, errs)


@pytest.mark.parametrize("seed", [0, 1])
def test_one_tf32_pass_breaks_them(seed):
    errs = relative_errors(tail_inputs(seed=seed), passes=1)
    assert errs["dphi"] > 1e-4 and errs["doff"] > 1e-4, errs
    assert max(errs.values()) > 10 * max(relative_errors(tail_inputs(seed=seed),
                                                         passes=3).values())


def test_near_zero_preactivations_keep_their_masks_under_three_passes():
    args = near_zero_tail_inputs()
    _, h2_64 = tail_backward(*(a.astype(np.float64) for a in args), mm=np.matmul)
    for passes, flips_expected in ((3, False), (1, True)):
        _, h2 = tail_backward(*args, mm=product(passes))
        flips = int(((h2 > 0) != (h2_64 > 0)).sum())
        assert (flips > 0) == flips_expected, (passes, flips)
    errs = relative_errors(args, passes=3)
    for name, e in errs.items():
        assert e <= 1e-4, (name, errs)
