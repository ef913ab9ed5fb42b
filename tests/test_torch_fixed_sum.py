"""The order-free sum of the port's scatter kernels (``csrc/fixed_sum.cuh``:
#4 ``combine_table_multi_bwd``, #6 ``combine_table_bwd``, #10
``scatter_selection``), modelled on the CPU and held against a float64 sum.

A row's terms t = w * g (w in [0, 1]) are scaled by 2^s, s = 62 - L - e, with
L the bit length of the most terms a target takes and M < 2^e the row's
largest finite |g| (#4, #6) or largest finite |t| (#10); each is rounded to
an int64, the ints are summed (any order gives the same total), and the total
goes back to float32 with one rounding. Non-finite terms flag their target
instead, and the target then takes what a float sum gives. The kernels run
on the card only; this model
states their arithmetic, and ``tests/test_torch_cuda.py`` holds the kernels to
their plain versions and to themselves across launches.
"""

import math

import numpy as np
import pytest

FLAG_POS, FLAG_NEG, FLAG_NAN = 1, 2, 4


def log2_terms(terms):
    """fixed_log2_terms: the bit length of the term count."""
    return int(terms).bit_length()


def shift_of(max_abs, L):
    """fixed_shift: M = m 2^e, m in [0.5, 1) (frexp; 0 gives e = 0)."""
    return 62 - L - math.frexp(float(max_abs))[1]


def to_fixed(t, s):
    """fixed_add's rounding: the float32 term scaled exactly in double, then
    rounded half to even to an integer (__double2ll_rn)."""
    return round(math.ldexp(float(t), s))


def fixed_scatter(w, g, idx, n_out, terms, by_terms=False):
    """The kernels' sum of one row: t = float32(w * g) into n_out targets; M
    the largest finite |g|, or |t| with ``by_terms``."""
    t = (np.asarray(w, np.float32) * np.asarray(g, np.float32)).astype(np.float32)
    of = np.abs(t if by_terms else np.asarray(g, np.float32))
    finite = of[np.isfinite(of)]
    max_abs = np.float32(finite.max()) if finite.size else np.float32(0.0)
    L = log2_terms(terms)
    s = shift_of(max_abs, L)
    acc = [0] * n_out
    flags = [0] * n_out
    for ti, i in zip(t.tolist(), np.asarray(idx).tolist()):
        if math.isfinite(ti):
            acc[i] += to_fixed(ti, s)
        else:
            flags[i] |= FLAG_NAN if math.isnan(ti) else (FLAG_POS if ti > 0 else FLAG_NEG)
    out = np.empty(n_out, np.float32)
    for i in range(n_out):
        f = flags[i]
        if f & FLAG_NAN or f == FLAG_POS | FLAG_NEG:
            out[i] = np.nan
        elif f:
            out[i] = np.inf if f == FLAG_POS else -np.inf
        else:
            assert abs(acc[i]) < 2 ** 63
            out[i] = np.ldexp(np.array(acc[i], np.int64).astype(np.float32), -s)
    return out


def _terms(rng, n_terms, n_out, scale=1.0):
    w = rng.random(n_terms).astype(np.float32)
    g = (rng.normal(size=n_terms) * scale).astype(np.float32)
    idx = rng.integers(0, n_out, n_terms)
    return w, g, idx


def _float64_sum(w, g, idx, n_out):
    t = (w * g).astype(np.float32).astype(np.float64)
    out = np.zeros(n_out, np.float64)
    np.add.at(out, idx, t)
    return out


def _ulp32(x):
    return np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("scale", [1.0, 3e-5, 7e4])
def test_fixed_sum_is_the_float64_sum_rounded(scale):
    """Against the float64 sum of the same float32 terms: within half a
    float32 ulp of it plus the terms' rounding (half a unit each, a unit of
    2^(L + e - 62)), and identical whatever the order of the terms."""
    rng = np.random.default_rng(0)
    n_terms, n_out = 4000, 37
    w, g, idx = _terms(rng, n_terms, n_out, scale)
    got = fixed_scatter(w, g, idx, n_out, n_terms)
    want = _float64_sum(w, g, idx, n_out)
    unit = math.ldexp(1.0, log2_terms(n_terms) + math.frexp(float(np.abs(g).max()))[1] - 62)
    assert np.all(np.abs(got - want) <= 0.5 * _ulp32(want) + 0.5 * unit * n_terms)
    order = rng.permutation(n_terms)
    again = fixed_scatter(w[order], g[order], idx[order], n_out, n_terms)
    assert np.array_equal(again.view(np.int32), got.view(np.int32))
    # a float32 sum in two orders generally differs in its last bits
    f32 = [np.zeros(n_out, np.float32) for _ in range(2)]
    t = (w * g).astype(np.float32)
    np.add.at(f32[0], idx, t)
    np.add.at(f32[1], idx[order], t[order])
    assert not np.array_equal(f32[0], f32[1])


def test_fixed_sum_all_zero_and_worst_case_scale():
    """An all-zero cotangent gives zeros (M = 0: e = 0). The largest total the
    scale allows, 2^L - 1 terms of the largest |g| into one target with w = 1,
    stays below 2^62."""
    rng = np.random.default_rng(1)
    w, _, idx = _terms(rng, 500, 9)
    zero = fixed_scatter(w, np.zeros(500, np.float32), idx, 9, 500)
    assert not zero.any() and not np.signbit(zero).any()
    for terms in (1, 2 ** 18, 2 ** 19 - 1):
        for m in (np.float32(1.0), np.nextafter(np.float32(2.0), np.float32(0)),
                  np.float32(3e38), np.float32(1e-45)):
            s = shift_of(m, log2_terms(terms))
            assert terms * to_fixed(m, s) < 2 ** 62


def test_fixed_sum_carries_nan_and_inf_to_the_targets_they_touch():
    """A NaN or infinite cotangent reaches exactly the targets of its terms,
    as the float32 sum makes it (NaN; +inf and -inf together give NaN), and the
    other targets keep the sum of their finite terms, scaled by the largest
    finite |g|."""
    rng = np.random.default_rng(2)
    n_out = 8
    w, g, idx = _terms(rng, 300, n_out)
    idx[:3] = [0, 1, 2]
    idx[3:6] = [2, 3, 3]
    w[:6] = 0.5
    g[:6] = [np.nan, np.inf, np.inf, -np.inf, np.inf, np.inf]
    idx[6:] = rng.integers(4, n_out, 294)
    got = fixed_scatter(w, g, idx, n_out, 300)
    f32 = np.zeros(n_out, np.float32)
    with np.errstate(invalid="ignore"):
        np.add.at(f32, idx, (w * g).astype(np.float32))
    assert np.isnan(got[0]) and np.isnan(f32[0])
    assert got[1] == np.inf == f32[1]
    assert np.isnan(got[2]) and np.isnan(f32[2])    # +inf and -inf
    assert got[3] == np.inf == f32[3]
    finite = _float64_sum(w[6:], g[6:], idx[6:], n_out)[4:]
    assert np.all(np.isfinite(got[4:]))
    assert np.all(np.abs(got[4:] - finite) <= _ulp32(finite))


def test_fixed_sum_of_subnormal_terms():
    """Terms that are subnormal floats (a cotangent of ~1e-40) keep their
    precision: the scale follows the largest |g| down, and the double holds
    2^s beyond float32's range."""
    rng = np.random.default_rng(3)
    w, g, idx = _terms(rng, 1000, 5, scale=1e-40)
    assert np.abs(g).max() < np.finfo(np.float32).tiny
    got = fixed_scatter(w, g, idx, 5, 1000)
    want = _float64_sum(w, g, idx, 5)
    assert np.abs(want).min() > 0
    assert np.all(np.abs(got - want) <= 0.5 * _ulp32(want) + 1e-60)


def test_fixed_sum_scaled_by_the_largest_term_keeps_tiny_weights():
    """#10's scale: with M the largest |w * g|, a sample whose every weight is
    ~1e-18 (no valid point: 1e-30 / (4e-30 + 1e-12)) keeps the float64 sum's
    precision; scaled by the largest |g| its terms would round to nothing."""
    rng = np.random.default_rng(4)
    w, g, idx = _terms(rng, 2000, 7)
    w = (w * np.float32(1e-18)).astype(np.float32)
    want = _float64_sum(w, g, idx, 7)
    got = fixed_scatter(w, g, idx, 7, 2000, by_terms=True)
    assert np.all(np.abs(got - want) <= 0.5 * _ulp32(want) + 1e-6 * np.abs(want).max())
    assert not fixed_scatter(w, g, idx, 7, 2000).any()


def split_word_add(words, v):
    """fixed_add_shared's add of the int64 v into a total kept as two 32-bit
    words (low, high): the low add's carry comes from the word's old value."""
    u = v % 2 ** 64
    lo, hi = u % 2 ** 32, u >> 32
    old = words[0]
    words[0] = (old + lo) % 2 ** 32
    carry = 1 if words[0] < old else 0
    words[1] = (words[1] + hi + carry) % 2 ** 32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_word_adds_are_the_64_bit_sum_in_any_order(seed):
    """#6 adds a term to its shared total as two 32-bit atomics with an exact
    carry: in any order of the adds, signed terms included, the two words end
    as the 64-bit total modulo 2^64 that one 64-bit atomic a term gives."""
    rng = np.random.default_rng(seed)
    vals = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, 300)]
    vals += [2 ** 32 - 1, 1, -1, -(2 ** 32), 2 ** 63 - 1, -(2 ** 63)]
    want = sum(vals) % 2 ** 64
    for _ in range(3):
        words = [0, 0]
        for i in rng.permutation(len(vals)):
            split_word_add(words, vals[i])
        assert words[0] + (words[1] << 32) == want
