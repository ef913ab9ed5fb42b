"""The arithmetic of kernel #12, the DK/STDK MLP tail forward
(``csrc/dk_mlp_tail.cu``), modelled exactly in numpy.

The backward (#13, ``csrc/dk_mlp_tail_bwd.cu``) recomputes the forward and
takes its relu masks from it, so the forward's order of operations is a
contract: every pre-activation of layers 2 and 3 is the float32 ``fmaf`` sum
over k = 0 .. h-1 in ascending order from 0.0f, then ``+ bias``, then relu;
h1 = relu(phi + off); the fc4 dot is 13 partials, owner t summing
``fmaf(h3[n], fc4[n], part)`` over n = t, t + 13, ... in ascending n, and
out = b4 + part[0] + ... + part[12] in t order.

:func:`tail_model` states that order in numpy with a correctly rounded
float32 ``fmaf`` (Python 3.12 has no ``math.fma``): the product of two
float32 is exact in float64, TwoSum gives the float64 sum's exact error, and
where the float64 sum lands on a float32 midpoint the error decides the
rounding. Here the ``fmaf`` is held against ``fractions.Fraction`` on random
and adversarial (double-rounding) cases, the model against a scalar
evaluation of the same order and against the plain version. On the card,
``tests/test_torch_cuda.py`` holds the kernel bitwise equal to the model.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from p2igan_tpu_torch.ops.dk_mlp_kernel import mlp_tail_reference

OWNERS = 13  # the kernel's column owners: fc4 partial t sums columns n = t (mod 13)


def fmaf(a, b, c):
    """Elementwise float32 a * b + c rounded once (to nearest, ties to even),
    broadcasting; finite values whose result does not overflow."""
    a, b, c = (np.asarray(x, np.float32) for x in (a, b, c))
    p = a.astype(np.float64) * b.astype(np.float64)   # 48 bits: exact
    c64 = c.astype(np.float64)
    s = p + c64
    v = s - p
    err = (p - (s - v)) + (c64 - v)                    # TwoSum: p + c = s + err
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > r64, np.float32(np.inf), np.float32(-np.inf)))
    # s on the midpoint between r and its neighbour toward s: the float64
    # rounding may have crossed it; the exact sum lies on err's side
    mid = (s != r64) & (s == (r64 + other.astype(np.float64)) * 0.5)
    away = mid & (err != 0) & ((err > 0) == (s > r64))
    return np.where(away, other, r).astype(np.float32)


def tail_model(phi, off, fc2, b2, fc3, b3, fc4, b4, preactivations=False):
    """The kernel's output (J, HW), float32 numpy in and out. With
    ``preactivations`` also the layer-2 and layer-3 pre-activations
    (J * HW, h), rows j-major."""
    phi, off, fc2, b2, fc3, b3, fc4 = (np.asarray(x, np.float32)
                                       for x in (phi, off, fc2, b2, fc3, b3, fc4))
    b4 = np.float32(np.asarray(b4, np.float32).reshape(()))
    (HW, h), J = phi.shape, off.shape[0]
    x = np.maximum(phi[None, :, :] + off[:, None, :], np.float32(0)).reshape(J * HW, h)
    pre = []
    for w, bias in ((fc2, b2), (fc3, b3)):
        acc = np.zeros((J * HW, h), np.float32)
        for k in range(h):
            acc = fmaf(x[:, k:k + 1], w[k:k + 1, :], acc)
        pre.append(acc + bias)
        x = np.maximum(pre[-1], np.float32(0))
    y = np.full(J * HW, b4, np.float32)
    for t in range(OWNERS):
        part = np.zeros(J * HW, np.float32)
        for n in range(t, h, OWNERS):
            part = fmaf(x[:, n], fc4[n], part)
        y = y + part
    out = y.reshape(J, HW)
    return (out, *pre) if preactivations else out


def round_to_float32(q: Fraction) -> np.float32:
    """The float32 nearest to the rational q, ties to even (normal range and
    below; no overflow)."""
    if q == 0:
        return np.float32(0)
    mag = abs(q)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    if mag < Fraction(2) ** e:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    n = round(mag / ulp)                               # Fraction rounds half to even
    return np.float32(float(n * ulp) * (1 if q > 0 else -1))


def exact_fmaf(a, b, c) -> np.float32:
    return round_to_float32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("scale", ["mixed", "same"])
def test_fmaf_matches_fractions_on_random_inputs(scale):
    rng = np.random.default_rng(0 if scale == "mixed" else 1)
    n = 3000
    if scale == "mixed":   # magnitudes 2^-60 .. 2^60, near-cancelling sums included
        a, b, c = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
                   for _ in range(3))
        c[: n // 3] = -(a[: n // 3].astype(np.float32).astype(np.float64)
                        * b[: n // 3].astype(np.float32))
    else:                  # the tail's own: products and sums of unit scale
        a, b, c = (rng.standard_normal(n) for _ in range(3))
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    got = fmaf(a, b, c)
    want = np.array([exact_fmaf(*abc) for abc in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fmaf_repairs_float64_midpoints():
    """Cases where a * b + c rounded to float64 lies exactly on a float32
    midpoint and the exact value does not: rounding the float64 sum again
    (the naive model) is wrong on each, the model is right."""
    rng = np.random.default_rng(2)
    n = 200000
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-10, 10, n)).astype(np.float32)
    # b such that a * b is close to half a unit of c (an odd number of them)
    half_ulp = (np.spacing(np.abs(c)).astype(np.float64) / 2
                * rng.choice([-3, -1, 1, 3], n))
    b = (half_ulp / a.astype(np.float64)).astype(np.float32)
    s = a.astype(np.float64) * b + c
    naive = s.astype(np.float32)
    cand = np.flatnonzero(naive != fmaf(a, b, c))
    assert cand.size >= 50, cand.size           # the construction finds such cases
    for i in cand[:400]:
        want = exact_fmaf(a[i], b[i], c[i])
        assert _bits(fmaf(a[i], b[i], c[i])) == _bits(want), (a[i], b[i], c[i])
        assert _bits(naive[i]) != _bits(want)


def _inputs(HW, J, h, seed=0):
    """As ``tests/test_torch_cuda.py`` makes the tail's inputs."""
    rng = np.random.default_rng(seed)
    s = np.sqrt(2.0 / h)

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (arr(HW, h), arr(J, h), arr(h, h, scale=s), arr(h, scale=0.1),
            arr(h, h, scale=s), arr(h, scale=0.1), arr(h, scale=s), arr(1)[0])


def test_model_is_the_sequential_order():
    """The vectorised model against a scalar evaluation of the contract with
    Fraction-rounded fmaf: both pre-activations and the output, bitwise, at
    a few (j, pixel) rows."""
    HW, J, h = 19, 2, 30
    args = _inputs(HW, J, h, seed=3)
    phi, off, fc2, b2, fc3, b3, fc4, b4 = args
    out, a2, a3 = tail_model(*args, preactivations=True)
    relu = lambda v: np.float32(max(v, np.float32(0)))   # noqa: E731
    for j, p in ((0, 0), (1, 7), (0, 18), (1, 18)):
        x = [relu(np.float32(phi[p, k] + off[j, k])) for k in range(h)]
        for w, bias, pre in ((fc2, b2, a2), (fc3, b3, a3)):
            got = []
            for n in range(h):
                acc = np.float32(0)
                for k in range(h):
                    acc = exact_fmaf(x[k], w[k, n], acc)
                got.append(np.float32(acc + bias[n]))
            np.testing.assert_array_equal(_bits(pre[j * HW + p]), _bits(got))
            x = [relu(v) for v in got]
        y = np.float32(b4)
        for t in range(OWNERS):
            part = np.float32(0)
            for n in range(t, h, OWNERS):
                part = exact_fmaf(x[n], fc4[n], part)
            y = np.float32(y + part)
        assert _bits(out[j, p]) == _bits(y)


@pytest.mark.parametrize("HW,J,h", [(77, 3, 40), (130, 2, 100), (65, 4, 97)])
def test_model_matches_the_plain_version(HW, J, h):
    """Within the kernel's tolerance of the plain version (1e-5 x max|plain|,
    as ``chip_smoke.py`` holds the kernel), and nearer float64 than that."""
    args = _inputs(HW, J, h)
    got = tail_model(*args)
    plain = mlp_tail_reference(*(torch.from_numpy(np.asarray(a)) for a in args)).numpy()
    f64 = mlp_tail_reference(*(torch.from_numpy(np.asarray(a, np.float64))
                               for a in args)).numpy()
    assert got.shape == (J, HW) and got.dtype == np.float32
    scale = float(np.abs(plain).max())
    assert float(np.abs(got - plain).max()) <= 1e-5 * scale
    assert float(np.abs(got - f64).max()) <= 1e-5 * scale
