"""p2igan_tpu_torch -- the PyTorch / CUDA port of p2igan_tpu.

The JAX package ``p2igan_tpu`` stays the reference; this package re-implements
it in PyTorch for an NVIDIA H100, slice by slice, with the Pallas kernels of
each ported path rewritten as CUDA kernels (``csrc/``): so far the stis
serving path and hinge-GAN training of p2igan, the dk and stdk families in
serving and reconstruction-loss training, and the simple 3-D conv family with
its BatchNorm critic in serving and in both kinds of training. It imports neither jax, flax or
optax nor anything of ``p2igan_tpu``: the host modules it needs from there
(``config``, ``data.zarrlite``, ``data.fake``, ``utils.tracking``, the config
JSONs) are its own copies. Only the tests import both packages.

Layers:
  config     p2igan_tpu_torch.config     (loader; config/*.json the shipped configs)
  data       p2igan_tpu_torch.data       (zarrlite, masks, readers, loaders, fake data)
  ops        p2igan_tpu_torch.ops        (DO-conv, factored IDW, pool-dup, MLP tail, fused convs, kernels)
  models     p2igan_tpu_torch.models     (p2igan, dk, stdk, simple, weight conversion)
  training   p2igan_tpu_torch.training   (steps, trainer, checkpoints)
  serving    p2igan_tpu_torch.inference  (sliding-window reconstruction)
  cli        scripts/infer_torch.py, scripts/train_torch.py
"""

__version__ = "0.1.0"
