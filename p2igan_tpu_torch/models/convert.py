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

``module_state_from_jax`` and ``trainer_payload_from_jax`` take what a JAX
trainer checkpoint holds (decoded without flax by ``utils/flax_msgpack.py``)
to the port's modules, optimizers and trainer payload, for serving and resume.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..training.steps import AdamNoMu


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


def _norm(ex: _Exporter, fpath: Tuple[str, ...], tprefix: str) -> None:
    """A flax ``LayerNorm2d`` (scale, bias) -> ``<tprefix>weight/bias``."""
    ex.put(f"{tprefix}weight", ex.take(fpath + ("scale",)))
    ex.put(f"{tprefix}bias", ex.take(fpath + ("bias",)))


def layer_state_dict_from_jax(layer: nn.Module, variables: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """flax variables of one of the layer library's layers no model uses
    (``p2igan_tpu/ops/layers.py`` ``BasicConv``, ``ResBlockDOFFT``,
    ``LayerNorm2d``, ``STABEDBlock``, ``FFTBenchComplexConv``;
    ``ops/doconv.py`` ``SimAM``, which has none) -> the port layer's
    state_dict:

    - ``BasicConv``: ``conv/kernel`` HWIO -> ``main.0.weight`` OIHW (a
      transposed one's ``kernel`` (k, k, out, in) -> torch's (in, out, k, k)),
      ``bias``; ``bn/{scale,bias}`` and ``batch_stats`` ``bn/{mean,var}`` ->
      ``main.1.{weight,bias,running_mean,running_var}``;
    - ``ResBlockDOFFT``: ``conv1``/``conv2`` -> ``main.{0,1}.main.0``,
      ``fft1``/``fft2`` (1x1 DO-convs, plain HWIO kernels) ->
      ``main_fft.{0,1}.main.0``;
    - ``LayerNorm2d``: ``scale``/``bias`` -> ``weight``/``bias``;
    - ``STABEDBlock``: ``norm1``, ``norm2`` and the HWIO ``conv_double``,
      ``conv_single`` under their names;
    - ``FFTBenchComplexConv``: ``conv1``, ``conv2`` (1x1, HWIO)."""
    from ..ops.doconv import SimAM
    from ..ops.layers import (BasicConv, FFTBenchComplexConv, LayerNorm2d,
                              ResBlockDOFFT, STABEDBlock)

    ex = _Exporter(variables.get("params", {}))
    if isinstance(layer, BasicConv):
        stats = _Exporter(variables.get("batch_stats", {}))
        if layer.transpose:
            ex.put("main.0.weight", np.transpose(ex.take(("kernel",)), (3, 2, 0, 1)))
            if layer.main[0].bias is not None:
                ex.put("main.0.bias", ex.take(("bias",)))
        else:
            ex.put("main.0.weight", np.transpose(ex.take(("conv", "kernel")), (3, 2, 0, 1)))
            if layer.main[0].bias is not None:
                ex.put("main.0.bias", ex.take(("conv", "bias")))
        if len(layer.main) > 1:
            ex.put("main.1.weight", ex.take(("bn", "scale")))
            ex.put("main.1.bias", ex.take(("bn", "bias")))
            ex.put("main.1.running_mean", stats.take(("bn", "mean")))
            ex.put("main.1.running_var", stats.take(("bn", "var")))
        stats.finish()
    elif isinstance(layer, ResBlockDOFFT):
        for i, name in enumerate(("conv1", "conv2")):
            ex.doconv((name, "conv"), f"main.{i}.main.0", 3)
        for i, name in enumerate(("fft1", "fft2")):
            ex.doconv((name, "conv"), f"main_fft.{i}.main.0", 1)
    elif isinstance(layer, LayerNorm2d):
        _norm(ex, (), "")
    elif isinstance(layer, STABEDBlock):
        for name in ("norm1", "norm2"):
            _norm(ex, (name,), f"{name}.")
        for name in ("conv_double", "conv_single"):
            ex.conv((name,), name, (3, 2, 0, 1))
    elif isinstance(layer, FFTBenchComplexConv):
        for name in ("conv1", "conv2"):
            ex.put(f"{name}.weight", np.transpose(ex.take((name, "kernel")), (3, 2, 0, 1)))
            if getattr(layer, name).bias is not None:
                ex.put(f"{name}.bias", ex.take((name, "bias")))
    elif not isinstance(layer, SimAM):
        raise TypeError(f"no JAX layout known for {type(layer).__name__}")
    return ex.finish()


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


def _adam_fields(opt_state: Any) -> Dict[str, Any]:
    """The first element of a JAX optimizer chain (``make_optimizer``: the
    Adam state, then ``scale_by_learning_rate``'s empty one), from the live
    optax state (a tuple) or from a checkpoint (a dict keyed "0", "1")."""
    first = opt_state["0"] if isinstance(opt_state, dict) else opt_state[0]
    if isinstance(first, dict):
        return first
    return {name: getattr(first, name) for name in ("count", "mu", "nu")
            if hasattr(first, name)}


def optimizer_state_dict_from_jax(opt_state: Any, optimizer: torch.optim.Optimizer,
                                  module: nn.Module) -> Dict[str, Any]:
    """The JAX package's Adam state -> a state_dict for ``optimizer``, which
    must have been built over ``module.parameters()`` in order.

    - The port's ``AdamNoMu`` (beta1 = 0) takes ``step`` and ``nu`` of the
      JAX ``_AdamNoMuState(count, nu)``. The ``mu`` that checkpoints of
      ``optax.adam`` at beta1 = 0 carry is the last gradient and is dropped,
      as the JAX trainer's ``_migrate_opt_state`` drops it.
    - ``torch.optim.Adam`` (beta1 != 0) takes stock ``optax.adam``'s state:
      ``count`` as ``step``, ``mu`` as ``exp_avg``, ``nu`` as ``exp_avg_sq``."""
    fields = _adam_fields(opt_state)
    count = int(np.asarray(fields["count"]))
    names = [name for name, _ in module.named_parameters()]
    moments = {key: params_from_jax(module, fields[key])
               for key in ("mu", "nu") if key in fields}
    for key, tree in moments.items():
        if set(tree) != set(names):
            raise ValueError(f"optimizer {key} {sorted(set(tree) ^ set(names))} "
                             f"does not match the module's parameters")
    state = optimizer.state_dict()
    if isinstance(optimizer, AdamNoMu):
        state["state"] = {i: {"step": count, "nu": moments["nu"][name]}
                          for i, name in enumerate(names)}
    elif isinstance(optimizer, torch.optim.Adam):
        if "mu" not in moments:
            raise ValueError("torch.optim.Adam (beta1 != 0) needs the first moment "
                             "mu, which this JAX optimizer state does not carry")
        state["state"] = {i: {"step": torch.tensor(float(count)),
                              "exp_avg": moments["mu"][name],
                              "exp_avg_sq": moments["nu"][name]}
                          for i, name in enumerate(names)}
    else:
        raise TypeError(f"no JAX optimizer state maps to {type(optimizer).__name__}")
    return state


def optimizer_state_from_jax(opt_state: Any, optimizer: torch.optim.Optimizer,
                             module: nn.Module) -> None:
    """Load the JAX package's Adam state (:func:`optimizer_state_dict_from_jax`)
    into ``optimizer``."""
    optimizer.load_state_dict(optimizer_state_dict_from_jax(opt_state, optimizer, module))


def module_state_from_jax(module: nn.Module, entry: Dict[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """A JAX trainer checkpoint's ``generator`` or ``discriminator`` entry
    (``{"params", "extra"}``: the extra collections are the P2I critic's
    ``spectral`` vectors and the simple family's ``batch_stats``) -> the
    module's state_dict. dk/stdk need no visible-column remap: the JAX
    package and the port both take the visible pixels in ascending index
    order (``select_visible``); only reference torch checkpoints need
    :func:`remap_dk_visible_columns`. Strict: an entry with a collection the
    family does not have raises."""
    from .dk import DKGenerator
    from .p2igan import P2IDiscriminator, P2IGenerator
    from .simple import SimpleDiscriminator, SimpleGenerator

    variables = {"params": entry["params"], **(entry.get("extra") or {})}
    for klass, convert, collections in (
            (P2IGenerator, state_dict_from_jax, ()),
            (P2IDiscriminator, disc_state_dict_from_jax, ("spectral",)),
            (DKGenerator, dk_state_dict_from_jax, ()),  # STDKGenerator too
            (SimpleGenerator, simple_state_dict_from_jax, ("batch_stats",)),
            (SimpleDiscriminator, simple_disc_state_dict_from_jax, ("batch_stats",))):
        if isinstance(module, klass):
            extra = set(variables) - {"params", *collections}
            if extra:
                raise ValueError(f"unused JAX collections {sorted(extra)} for "
                                 f"{type(module).__name__}")
            return convert(variables)
    raise TypeError(f"no JAX layout known for {type(module).__name__}")


def split_state(module: nn.Module, state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A state_dict of ``module`` as the trainer payload's entry: ``params``
    (what the optimizer updates) and ``extra`` (the buffers)."""
    names = {n for n, _ in module.named_parameters()}
    return {"params": {k: v for k, v in state.items() if k in names},
            "extra": {k: v for k, v in state.items() if k not in names}}


def trainer_payload_from_jax(raw: Dict[str, Any], generator: nn.Module,
                             opt_g: torch.optim.Optimizer,
                             discriminator: Optional[nn.Module] = None,
                             opt_d: Optional[torch.optim.Optimizer] = None
                             ) -> Dict[str, Any]:
    """A decoded JAX trainer checkpoint (``p2igan_tpu/training/trainer.py``
    ``Trainer._save``: ``epoch``, ``global_step``, ``best_val``,
    ``generator{params,extra}``, ``optimizer_g`` and, from a GAN run,
    ``discriminator`` and ``optimizer_d``) -> the payload the port's trainer
    writes, for the port's modules and optimizers built from the same
    config. The discriminator's entries are converted where ``discriminator``
    is given and the checkpoint has them."""
    payload: Dict[str, Any] = {"epoch": int(raw.get("epoch", 0)),
                               "global_step": int(raw.get("global_step", 0))}
    if "best_val" in raw:
        payload["best_val"] = float(raw["best_val"])
    parts = [("generator", "optimizer_g", generator, opt_g)]
    if discriminator is not None and "discriminator" in raw:
        parts.append(("discriminator", "optimizer_d", discriminator, opt_d))
    for key, opt_key, module, optimizer in parts:
        payload[key] = split_state(module, module_state_from_jax(module, raw[key]))
        payload[opt_key] = optimizer_state_dict_from_jax(raw[opt_key], optimizer, module)
    return payload
