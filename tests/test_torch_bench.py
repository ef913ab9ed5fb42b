"""``bench_torch.py`` (the port's bench) against ``bench.py`` (the JAX
package's), on the CPU.

* the geometry is ``bench.py``'s constants, full and under ``BENCH_SMALL``
  (the one deliberate difference: no fallback train batch);
* the gauge masks and events are ``bench.py``'s numpy draws, bit for bit;
* ``main`` at a tiny geometry on the CPU prints four cumulative lines, every
  rate and operation count above 0, each spread around its median, no error;
* ``--device cuda`` without a GPU fails before the first stage;
* ``count_ops_bytes`` counts the dk, stdk and simple kernels (#12-#15) by
  their formulas, as the p2igan ones;
* the reconstruction the inference stage times, on ``bench.py``'s small
  inputs and the bench's seeded weights (carried to JAX by the JAX package's
  ``torch_import`` and back, exactly, by ``models/convert.py``), equals the
  JAX program ``bench.py`` times within atol 1e-4 x 255. Compiled as
  ``bench.py`` compiles it, that program breaks exact gauge distance ties
  its own way: XLA's simplifier turns the gauge coordinates' division into
  a product with the reciprocal (the optimized HLO shows it). It is compiled
  with that pass off, at level 0 (no FMA contraction), so that it rounds as
  the op-by-op form the sti parity tests get from ``jax.disable_jit()``,
  which is far slower for the whole program.

``bench.py`` is loaded by path: it imports only numpy at its top level (its
environment setting is undone after the load).
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import bench_torch
from p2igan_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--size", "16", "--frames", "4", "--base", "16"]
STAGES = ["inference", "train", "families", "family_train"]
SCALE = 255.0
# XLA options under which a jitted program rounds as its op-by-op form does:
# the algebraic simplifier turns a division by a constant (the gauge
# coordinates' / (H - 1)) into a product with its reciprocal, and the backend
# above level 0 contracts products and sums into FMAs; either moves exact
# gauge distance ties
OP_BY_OP_ARITHMETIC = {"xla_backend_optimization_level": "0",
                       "xla_disable_hlo_passes": "algsimp"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the test run has a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load_bench(small: bool):
    with mock.patch.dict(os.environ):
        os.environ.pop("BENCH_SMALL", None)
        if small:
            os.environ["BENCH_SMALL"] = "1"
        spec = importlib.util.spec_from_file_location(f"jax_bench_{int(small)}",
                                                      REPO / "bench.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_bench():
    return {small: _load_bench(small) for small in (False, True)}


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_the_geometry_is_bench_pys(jax_bench, small):
    ref = jax_bench[small]
    geo = bench_torch.geometry(small)
    for name in geo._fields:
        want = getattr(ref, name.upper())
        if name == "train_batches":
            want = want[:1]  # no fallback batch (bench.py's (12, 4) was for the v5e)
        assert getattr(geo, name) == want, name
    assert ref.TRAIN_BATCHES[0] == geo.train_batches[0]


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_the_inputs_are_bench_pys_bitwise(jax_bench, small):
    ref = jax_bench[small]
    geo = bench_torch.geometry(small)
    for seed in (0, 1):
        ours, theirs = bench_torch._gauge_mask_np(geo, seed), ref._gauge_mask_np(seed)
        assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()
    mask = ref._gauge_mask_np(0)
    for ours, theirs in zip(bench_torch._event_batch(geo, mask, 2),
                            ref._event_batch(mask, 2)):
        assert ours.shape == theirs.shape == (2, geo.event_t, geo.h, geo.w, 1)
        assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()


RATES = ("events_per_sec_batched", "gan_steps_per_sec", "gan_samples_per_sec",
         "gan_steps_per_sec_d3d_bf16", "simple_events_per_sec", "dk_events_per_sec",
         "stdk_events_per_sec", "dk_train_steps_per_sec", "stdk_train_steps_per_sec",
         "simple_train_steps_per_sec", "flops_per_event", "flops_per_step",
         "mfu_inference", "mfu_train", "simple_flops_per_event", "dk_flops_per_event",
         "stdk_flops_per_event", "dk_train_flops_per_step", "stdk_train_flops_per_step",
         "simple_train_flops_per_step")


def test_main_prints_the_four_stages_on_the_cpu(capsys, monkeypatch):
    monkeypatch.delenv("BENCH_SMALL", raising=False)
    monkeypatch.delenv("BENCH_FULL", raising=False)
    assert bench_torch.main(TINY) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [line["stages_done"] for line in lines] == [STAGES[:i + 1] for i in range(4)]
    for prev, cur in zip(lines, lines[1:]):  # each line carries every finished stage
        assert set(prev) <= set(cur)
    final = lines[-1]
    assert [key for key in final if key.endswith("_error")] == []
    assert final["card"] == "cpu" and final["unit"] == "events/sec"
    assert final["value"] == final["events_per_sec_batched"]
    assert final["vs_prev_round"] is None and final["vs_baseline"] is None
    assert final["geometry"]["h"] == 16 and final["geometry"]["reps"] == 1
    assert final["gan_batch"] == 2
    for key in RATES:
        assert final[key] > 0, key
    spreads = [k for k in final if k.endswith("_spread")]
    assert len(spreads) == 8
    for key in spreads:
        lo, hi = final[key]
        median = final["events_per_sec_batched" if key == "events_per_sec_spread"
                       else key[:-len("_spread")]]
        assert lo <= median <= hi, key
    for stage in STAGES:
        assert final[f"{stage}_launches"] == {}  # the CPU runs the plain versions
        assert final[f"{stage}_secs"] >= 0


def _kernel_args(name: str):
    rand = torch.Generator().manual_seed(3)
    r = lambda *shape: torch.rand(shape, generator=rand)  # noqa: E731
    hw, J, h = 24, 6, 8
    if name == "mlp_tail_fused":
        return (r(hw, h), r(J, h), r(h, h), r(h), r(h, h), r(h), r(h), r(1)), (
            J * hw * (4 * h * h + 4 * h), 4 * (hw * h + J * h + 2 * h * h + 3 * h + 1 + J * hw))
    if name == "mlp_tail_bwd":
        return (r(hw, h), r(J, h), r(J, hw), r(h, h), r(h), r(h, h), r(h), r(h)), (
            J * hw * (12 * h * h + 10 * h), 4 * (2 * hw * h + 2 * J * h + J * hw + 4 * h * h + 6 * h))
    cin, cout = (2, 5) if name == "enc0_conv3d_leaky" else (4, 1)
    x, w, b = r(2, 3, 5, 6, cin), r(3, 3, 3, cin, cout), r(cout)
    return (x, w, b), (180 * cout * (54 * cin + 3), 4 * (x.numel() + 180 * cout + w.numel() + cout))


@pytest.mark.parametrize("name", ["mlp_tail_fused", "mlp_tail_bwd", "enc0_conv3d_leaky",
                                  "conv3d_cout1_sigmoid"])
def test_the_family_kernels_are_counted_by_their_formulas(name):
    """The flop keys of dk, stdk and simple on the card count #12-#15 by their
    bounds' formulas (ctypes calls that no dispatch mode sees)."""
    from p2igan_tpu_torch.models import dk, simple
    from p2igan_tpu_torch.ops import dk_mlp_kernel

    owner = {"mlp_tail_fused": dk, "mlp_tail_bwd": dk_mlp_kernel}.get(name, simple)
    args, (ops, nbytes) = _kernel_args(name)
    c = profiling.count_ops_bytes(lambda: getattr(owner, name)(*args))
    assert c["kernels"] == {name: [1, ops, nbytes]}
    assert (c["ops"], c["bytes"]) == (ops, nbytes)  # the plain version is not counted


def test_cuda_without_a_gpu_fails_before_any_stage(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench_torch.main(["--device", "cuda"] + TINY[2:])
    assert capsys.readouterr().out == ""


def test_the_timed_reconstruction_matches_jax(jax_bench):
    import jax
    import jax.numpy as jnp

    from p2igan_tpu.models import P2IGenerator as JaxGenerator
    from p2igan_tpu.models.torch_import import import_p2igan_generator
    from p2igan_tpu_torch.models import P2IGenerator
    from p2igan_tpu_torch.models.convert import state_dict_from_jax

    ref = jax_bench[True]
    geo = bench_torch.geometry(True)
    # the bench's seeded flagship as JAX variables, and back through convert.py
    seeded = bench_torch._flagship(geo, torch.device("cpu")).state_dict()
    jvars = import_p2igan_generator({k: v.numpy() for k, v in seeded.items()})
    state = state_dict_from_jax(jvars)
    assert all(torch.equal(state[k], seeded[k]) for k in state)
    gen = P2IGenerator(H=geo.h, W=geo.w, length=geo.t, base_channels=geo.base,
                       idw_max_points=geo.idw_max_points, idw_factored=True,
                       idw_shared_batch_mask=True)
    gen.load_state_dict(state)
    # bench_inference's mask and events, through the reconstruction it times
    masked, masks = ref._event_batch(ref._gauge_mask_np(0), ref.N_EVENTS)
    got = bench_torch._make_reconstructor(gen, geo)._reconstruct(
        torch.from_numpy(masked), torch.from_numpy(masks)).numpy()

    # bench.py's generator (its main) and program (its bench_inference)
    jgen = JaxGenerator(H=geo.h, W=geo.w, length=geo.t, base_channels=geo.base,
                        idw_max_points=geo.idw_max_points, idw_chunk=16384,
                        idw_factored=True, idw_shared_batch_mask=True)
    jrecon = ref._make_reconstructor(jgen, jvars)
    args = (jnp.asarray(masked), jnp.asarray(masks))
    program = jrecon.compiled_batch_fn(geo.event_t, n_events=ref.N_EVENTS).lower(*args)
    want = np.asarray(program.compile(compiler_options=OP_BY_OP_ARITHMETIC)(*args))
    assert got.shape == want.shape == masked.shape
    assert want.max() > 1.0 and (want > 0).mean() > 0.25  # not degenerate
    np.testing.assert_allclose(got, want, atol=1e-4 * SCALE, rtol=0)
