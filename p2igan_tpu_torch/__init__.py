"""p2igan_tpu_torch -- the PyTorch / CUDA port of p2igan_tpu.

The JAX package ``p2igan_tpu`` stays the reference; this package re-implements
its stis serving path in PyTorch for an NVIDIA H100, with the Pallas kernels
of that path rewritten as CUDA kernels (``csrc/``). It never imports jax, flax
or optax; from ``p2igan_tpu`` it reuses only the jax-free ``config`` and
``data.zarrlite`` (and ``data.fake`` in tools and tests).

Layers:
  data       p2igan_tpu_torch.data       (masks, event readers, test loader)
  ops        p2igan_tpu_torch.ops        (DO-conv, factored IDW, pool-dup, kernels)
  models     p2igan_tpu_torch.models     (P2IGenerator, weight conversion)
  serving    p2igan_tpu_torch.inference  (sliding-window reconstruction)
  cli        scripts/infer_torch.py
"""

__version__ = "0.1.0"
