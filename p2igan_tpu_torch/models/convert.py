"""Weights across packages: JAX/flax variables -> the port's
(reference-layout) torch state_dicts, and JAX optimizer state -> the port's.

``state_dict_from_jax``, ``disc_state_dict_from_jax``,
``dk_state_dict_from_jax`` and ``simple_state_dict_from_jax`` are the inverses
of ``p2igan_tpu/models/torch_import.py::import_p2igan_generator``,
``import_p2igan_discriminator``, ``import_dk_generator`` and
``import_simple_generator``; ``simple_disc_state_dict_from_jax`` has no importer
to invert (the reference ships no simple critic checkpoint). Accounting is
strict both ways: every flax leaf must be used and every state_dict key of the
structure must be filled, else it raises. ``D_diag`` is a constant of the
DO-conv and is not emitted.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn


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
        self.state[key] = torch.from_numpy(np.array(value, order="C"))  # keeps 0-d

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


# spectral-norm conv kernels: HWIO -> OIHW, DHWIO -> OIDHW
_SN_PERM = {"d2d": (3, 2, 0, 1), "d3d": (4, 3, 0, 1, 2)}


def _disc_params(ex: _Exporter) -> None:
    for branch, perm in _SN_PERM.items():
        for idx in (0, 2, 4, 6, 8):
            ex.conv((f"{branch}_{idx}",), f"{branch}.{idx}", perm)
            key = f"{branch}.{idx}.weight"
            ex.state[f"{key}_orig"] = ex.state.pop(key)
    for name in ("alpha2d", "alpha3d"):
        ex.put(name, ex.take((name,)))


def disc_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax P2IDiscriminator variables ({"params", "spectral"}) -> the
    reference-layout state_dict the port's ``P2IDiscriminator`` loads,
    spectral ``u``/``v`` included."""
    ex = _Exporter(variables["params"])
    _disc_params(ex)
    spectral = _Exporter(variables["spectral"])
    for branch in _SN_PERM:
        for idx in (0, 2, 4, 6, 8):
            for vec in ("u", "v"):
                ex.put(f"{branch}.{idx}.weight_{vec}",
                       spectral.take((f"{branch}_{idx}", vec)))
    spectral.finish()
    return ex.finish()


_DK_LINEARS = ((0, "fc1"), (2, "fc2"), (4, "fc3"), (6, "fc4"))


def dk_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax DKGenerator / STDKGenerator variables ({"params": {"mlp": {fc1,
    b1, ...}}}, numpy or jax arrays) -> the reference-layout state_dict
    ``_mlp.net.{0,2,4,6}.{weight,bias}``: weights transposed to torch's
    (out, in), the (1, h) biases flattened."""
    ex = _Exporter(variables["params"])
    for tidx, fname in _DK_LINEARS:
        ex.put(f"_mlp.net.{tidx}.weight", ex.take(("mlp", fname)).T)
        ex.put(f"_mlp.net.{tidx}.bias", ex.take(("mlp", f"b{fname[-1]}"))[0])
    return ex.finish()


# DHWIO -> OIDHW; for a transposed conv (kt, kh, kw, out, in) -> torch's
# (in, out, kt, kh, kw)
_CONV3D_PERM = (4, 3, 0, 1, 2)
_SIMPLE_DECODER = ((0, "dec0"), (2, "dec1"), (4, "dec2"))


def _conv3d_blocks(ex: _Exporter, stats, blocks) -> None:
    """flax ``Conv3dBlock``s -> ``<prefix>.0`` (Conv3d) and ``<prefix>.1``
    (BatchNorm affine and, with ``stats``, its running statistics)."""
    for fname, tprefix in blocks:
        ex.conv((fname,), f"{tprefix}.0", _CONV3D_PERM)
        ex.put(f"{tprefix}.1.weight", ex.take((fname, "bn", "scale")))
        ex.put(f"{tprefix}.1.bias", ex.take((fname, "bn", "bias")))
        if stats is not None:
            ex.put(f"{tprefix}.1.running_mean", stats.take((fname, "bn", "mean")))
            ex.put(f"{tprefix}.1.running_var", stats.take((fname, "bn", "var")))


def _simple_params(ex: _Exporter, stats=None) -> None:
    _conv3d_blocks(ex, stats, [(f"enc{i}", f"encoder.{i}") for i in range(3)])
    for tidx, fname in _SIMPLE_DECODER:
        ex.put(f"decoder.{tidx}.weight",
               np.transpose(ex.take((f"{fname}_kernel",)), _CONV3D_PERM))
        ex.put(f"decoder.{tidx}.bias", ex.take((f"{fname}_bias",)))


def _simple_disc_params(ex: _Exporter, stats=None) -> None:
    _conv3d_blocks(ex, stats, [(f"f{i}", f"features.{i}") for i in range(3)])
    ex.put("head.weight", ex.take(("head_kernel",)).T)
    ex.put("head.bias", ex.take(("head_bias",)))


def _with_stats(variables: Dict[str, Any], fill) -> Dict[str, torch.Tensor]:
    ex, stats = _Exporter(variables["params"]), _Exporter(variables["batch_stats"])
    fill(ex, stats)
    stats.finish()
    return ex.finish()


def simple_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax SimpleGenerator variables ({"params", "batch_stats"}) -> the
    reference-layout state_dict the port's ``SimpleGenerator`` loads, running
    statistics included."""
    return _with_stats(variables, _simple_params)


def simple_disc_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax SimpleDiscriminator variables ({"params", "batch_stats"}) -> the
    port's ``SimpleDiscriminator`` state_dict (``features.{i}.{0,1}.*``,
    ``head.*``)."""
    return _with_stats(variables, _simple_disc_params)


def remap_dk_visible_columns(state: Dict[str, torch.Tensor], order: np.ndarray,
                             n_space: int, n_time: int = 0, t_blocks: int = 1
                             ) -> Dict[str, torch.Tensor]:
    """Permute the first layer's columns of the visible-value block(s) from a
    torch top-k ``order`` (the tie order of the device a checkpoint trained
    on) to the ascending-index order of ``select_visible``. Counterpart of
    ``p2igan_tpu/models/torch_import.py::remap_dk_visible_columns`` on the
    port's state_dict, where features are columns of ``_mlp.net.0.weight``.

    Feature layout (reference dk.py:191-194 / stdk.py:180-185):
    ``[phi_s (n_space) | phi_t (n_time) | z (t_blocks * k)]``."""
    k = len(order)
    pos = {int(g): j for j, g in enumerate(order)}
    perm = torch.tensor([pos[int(g)] for g in np.sort(order)], dtype=torch.long)
    out = dict(state)
    fc1 = state["_mlp.net.0.weight"].clone()       # (hidden, feature_dim)
    base = n_space + n_time
    if base + t_blocks * k != fc1.shape[1]:
        raise ValueError(
            f"visible-column remap layout mismatch: n_space+n_time={base} "
            f"plus {t_blocks} block(s) of {k} gauges != fc1 columns "
            f"{fc1.shape[1]}; a wrong offset would silently permute the "
            f"wrong columns")
    for b in range(t_blocks):
        off = base + b * k
        fc1[:, off:off + k] = fc1[:, off:off + k][:, perm]
    out["_mlp.net.0.weight"] = fc1
    return out


def params_from_jax(module: nn.Module, params: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """A flax params-shaped tree (the parameters, or an optimizer moment of
    them) -> {port parameter name: tensor}."""
    from .dk import DKGenerator
    from .p2igan import P2IDiscriminator, P2IGenerator
    from .simple import SimpleDiscriminator, SimpleGenerator

    for klass, fill in ((SimpleGenerator, _simple_params),
                        (SimpleDiscriminator, _simple_disc_params)):
        if isinstance(module, klass):
            ex = _Exporter(params)
            fill(ex)
            return ex.finish()
    if isinstance(module, P2IGenerator):
        return state_dict_from_jax({"params": params})
    if isinstance(module, DKGenerator):  # STDKGenerator too
        return dk_state_dict_from_jax({"params": params})
    if isinstance(module, P2IDiscriminator):
        ex = _Exporter(params)
        _disc_params(ex)
        return ex.finish()
    raise TypeError(f"no JAX layout known for {type(module).__name__}")


def optimizer_state_from_jax(opt_state: Any, optimizer: torch.optim.Optimizer,
                             module: nn.Module) -> None:
    """Load the JAX package's mu-free Adam state (``make_optimizer`` at
    beta1=0: a chain whose first element is ``_AdamNoMuState(count, nu)``)
    into the port's ``AdamNoMu``, which must have been built over
    ``module.parameters()`` in order."""
    count, nu = int(np.asarray(opt_state[0].count)), opt_state[0].nu
    moments = params_from_jax(module, nu)
    names = [name for name, _ in module.named_parameters()]
    if set(moments) != set(names):
        raise ValueError(f"optimizer moments {sorted(set(moments) ^ set(names))} "
                         f"do not match the module's parameters")
    state = optimizer.state_dict()
    state["state"] = {i: {"step": count, "nu": moments[name]}
                      for i, name in enumerate(names)}
    optimizer.load_state_dict(state)
