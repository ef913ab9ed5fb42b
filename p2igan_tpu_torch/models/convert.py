"""Weights across packages: JAX/flax P2I generator variables -> the port's
(reference-layout) torch state_dict.

The inverse of ``p2igan_tpu/models/torch_import.py::import_p2igan_generator``.
Accounting is strict both ways: every flax leaf must be used and every
state_dict key of the structure must be filled, else it raises. ``D_diag``
is a constant of the DO-conv and is not emitted.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


class _Exporter:
    def __init__(self, params: Dict[str, Any]):
        self.leaves: Dict[Tuple[str, ...], np.ndarray] = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                self.leaves[path] = np.asarray(node)

        walk(params, ())
        self.state: Dict[str, torch.Tensor] = {}

    def take(self, path: Tuple[str, ...]) -> np.ndarray:
        if path not in self.leaves:
            raise KeyError(f"missing flax leaf: {'/'.join(path)}")
        return self.leaves.pop(path)

    def put(self, key: str, value: np.ndarray) -> None:
        self.state[key] = torch.from_numpy(np.ascontiguousarray(value))

    def finish(self) -> Dict[str, torch.Tensor]:
        if self.leaves:
            raise ValueError("unused flax leaves: "
                             f"{['/'.join(p) for p in self.leaves]}")
        return self.state

    def doconv(self, fpath: Tuple[str, ...], tprefix: str, kernel_size: int) -> None:
        if kernel_size > 1:
            self.put(f"{tprefix}.W", self.take(fpath + ("W",)))
            self.put(f"{tprefix}.D", self.take(fpath + ("D",)))
        else:  # the importer stores a 1x1 DO-conv as a plain HWIO kernel
            w = self.take(fpath + ("W",))
            self.put(f"{tprefix}.W", np.transpose(w, (3, 2, 0, 1))
                     .reshape(w.shape[3], w.shape[2], 1))

    def conv(self, fpath: Tuple[str, ...], tprefix: str, perm) -> None:
        self.put(f"{tprefix}.weight", np.transpose(self.take(fpath + ("kernel",)),
                                                   perm))
        self.put(f"{tprefix}.bias", self.take(fpath + ("bias",)))


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax P2IGenerator variables ({"params": ...}, numpy or jax arrays) ->
    the reference-layout state_dict the port's ``P2IGenerator`` loads."""
    params = variables["params"]
    ex = _Exporter(params)
    depth = len([k for k in params["input"] if k.startswith("att")])
    for i in range(depth):
        ex.conv(("input", f"att{i}"), f"input.layers.{i}.conv", (2, 1, 0))
    ex.doconv(("Convsin_0", "conv"), "Convsin.0.main.0", 3)
    ex.doconv(("ConvsOut_0", "conv"), "ConvsOut.0.main.0", 1)
    num_res = len([k for k in params["Decoder_0"] if k.startswith("res")])
    for k in range(4):
        for i in range(num_res):
            for j in (0, 1):
                ex.doconv((f"Decoder_{k}", f"res{i}", f"conv{j + 1}", "conv"),
                          f"Decoder.{k}.layers.{i}.main.{j}.main.0", 3)
    for k in range(3):
        ex.put(f"UP.{k}.pos", np.transpose(ex.take((f"UP_{k}", "pos")),
                                           (0, 3, 1, 2)))
        ex.conv((f"UP_{k}", "proj"), f"UP.{k}.proj", (3, 2, 0, 1))
    return ex.finish()
