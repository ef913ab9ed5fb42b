"""The layer library's layers no model uses, and seeding, in the port vs the
JAX package (CPU): ``BasicConv`` (plain and transposed, BatchNorm in train
and eval mode), ``ResBlockDOFFT``, ``LayerNorm2d``, ``STABEDBlock``,
``FFTBenchComplexConv``, ``SimAM``; ``seed_everything`` and ``KeyStream``.

Weights cross through ``layer_state_dict_from_jax``; inputs come from numpy
seeds. Tolerance: rtol 1e-5 with atol 1e-5 x max|JAX| (float32 convolutions
and reductions summed in another order; the FFT blocks' transforms too).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2igan_tpu.ops import doconv as jdoconv
from p2igan_tpu.ops import layers as jlayers
from p2igan_tpu_torch.models.convert import layer_state_dict_from_jax
from p2igan_tpu_torch.ops import layers
from p2igan_tpu_torch.ops.doconv import SimAM
from p2igan_tpu_torch.utils.rng import KeyStream, fold_in, seed_everything


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _perturbed(variables, seed):
    """The JAX init with every leaf moved by noise: non-zero biases and
    DO-conv D, BatchNorm affine away from (1, 0)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: np.asarray(v) + rng.normal(size=v.shape).astype(
        np.float32) * 0.1, variables)


def _run(jmod, port, x, seed=0, **kw):
    variables = _perturbed(dict(jax.jit(jmod.init)(jax.random.key(seed), jnp.asarray(x))),
                           seed)
    port.load_state_dict(layer_state_dict_from_jax(port, variables))
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x), **kw)
    return _nhwc(got), want, variables


@pytest.mark.parametrize("transpose", [False, True])
def test_basic_conv_matches_jax(transpose):
    x = np.random.default_rng(1).normal(size=(2, 8, 8, 3)).astype(np.float32)
    if transpose:  # k=4, s=2, p=1: doubles H and W
        jmod = jlayers.BasicConv(3, 6, 4, stride=2, transpose=True, relu=False,
                                 use_bias=True)
        port = layers.BasicConv(3, 6, 4, stride=2, transpose=True, relu=False, bias=True)
    else:
        jmod = jlayers.BasicConv(3, 6, 3, use_bias=True, relu=True)
        port = layers.BasicConv(3, 6, 3, bias=True, relu=True)
    got, want, _ = _run(jmod, port, x)
    assert got.shape == (2, 16, 16, 6) if transpose else (2, 8, 8, 6)
    _close(got, want)


def test_basic_conv_batch_norm_train_and_eval_match_jax():
    """Train mode normalises with the batch's statistics and moves the running
    ones as flax does (momentum 0.9 on the biased variance); eval mode
    normalises with the running ones."""
    x = np.random.default_rng(2).normal(size=(3, 8, 8, 4)).astype(np.float32)
    jmod = jlayers.BasicConv(4, 6, 3, norm=True, relu=True, stride=2)
    port = layers.BasicConv(4, 6, 3, norm=True, relu=True, stride=2)
    variables = dict(jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x)))
    variables["params"] = _perturbed(variables["params"], 3)
    variables["batch_stats"] = jax.tree.map(
        lambda v: np.abs(np.asarray(v) + 0.3), variables["batch_stats"])
    sd = layer_state_dict_from_jax(port, variables)
    assert "main.0.bias" not in sd  # no conv bias under a norm
    port.load_state_dict(sd)
    want, upd = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = port(_nchw(x), train=True)
    _close(_nhwc(got), want)
    bn = port.main[1]
    _close(bn.running_mean.numpy(), upd["batch_stats"]["bn"]["mean"])
    _close(bn.running_var.numpy(), upd["batch_stats"]["bn"]["var"])
    variables["batch_stats"] = upd["batch_stats"]
    with torch.no_grad():
        got = port(_nchw(x))
    _close(_nhwc(got), jmod.apply(variables, jnp.asarray(x)))
    with pytest.raises(NotImplementedError, match="groups"):
        layers.BasicConv(4, 8, 4, transpose=True, groups=2)


def test_fft_resblock_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 8, 8, 16)).astype(np.float32)
    got, want, _ = _run(jlayers.ResBlockDOFFT(16), layers.ResBlockDOFFT(16), x)
    _close(got, want)


def test_fft_bench_complex_conv_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 8, 6, 8)).astype(np.float32)
    for dw, bias in ((1.0, False), (0.5, True)):
        got, want, _ = _run(jlayers.FFTBenchComplexConv(8, dw=dw, use_bias=bias),
                            layers.FFTBenchComplexConv(8, dw=dw, bias=bias), x)
        assert got.shape == x.shape
        _close(got, want)


def test_layernorm2d_and_stabed_block_match_jax():
    x = np.random.default_rng(6).normal(size=(2, 5, 5, 8)).astype(np.float32)
    got, want, _ = _run(jlayers.LayerNorm2d(8), layers.LayerNorm2d(8), x)
    _close(got, want)
    got, want, _ = _run(jlayers.STABEDBlock(8, 4), layers.STABEDBlock(8, 4), x)
    assert got.shape == (2, 5, 5, 4)
    _close(got, want)


def test_simam_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 6, 7, 4)).astype(np.float32)
    got, want, variables = _run(jdoconv.SimAM(), SimAM(), x)
    assert variables == {} and layer_state_dict_from_jax(SimAM(), {}) == {}
    _close(got, want)


def test_seed_everything_and_key_stream_repeat():
    def draws(seed):
        gen = seed_everything(seed)
        return (random.random(), float(np.random.random()), float(torch.rand(1)),
                float(torch.rand(1, generator=gen)))

    assert draws(5) == draws(5)
    assert draws(5) != draws(6)
    a, b = KeyStream(3), KeyStream(3)
    first = [float(torch.rand(1, generator=a())) for _ in range(4)]
    assert first == [float(torch.rand(1, generator=b.next())) for _ in range(4)]
    assert len(set(first)) == 4  # every generator a fresh stream
    assert first != [float(torch.rand(1, generator=g())) for g in [KeyStream(4)] * 4]
    assert fold_in(3, 1) == fold_in(3, 1) != fold_in(1, 3)
    assert 0 <= fold_in(2 ** 40, 7) < 2 ** 63
