"""Operators of the port: convolutions, DO-conv, factored IDW and the
hand-written CUDA kernels with their plain PyTorch versions."""
