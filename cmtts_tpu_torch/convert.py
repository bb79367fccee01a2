"""The one bridge from a flax param tree (a nested dict of numpy arrays, as
``flax.linen.Module.init`` or a flat ``a/b/c`` npz gives it) to a port
module's ``state_dict``.

The port's modules carry the flax module names, so the mapping is
mechanical: ``a/b/c/<leaf>`` -> ``a.b.c.<name>``, with these layout rules:

- ``kernel`` of a Dense (in, out) -> ``Linear.weight`` (out, in);
- ``kernel`` of a Conv (k, in, out) -> ``Conv1d.weight`` (out, in, k);
- ``kernel`` of a 2-D Conv (kh, kw, in, out) -> ``Conv2d.weight``
  (out, in, kh, kw);
- ``kernel`` of a ConvTranspose (k, in, out) -> ``ConvTranspose1d.weight``
  (in, out, k) with the taps flipped;
- ``scale`` (LayerNorm, BatchNorm) and ``embedding`` (Embed) -> ``weight``;
- a BatchNorm's ``mean`` / ``var``, which flax keeps in the separate
  ``batch_stats`` tree -> ``running_mean`` / ``running_var``;
- the encoder's fused ``qkv`` Dense (C, 3C) splits into ``q``, ``k``, ``v``;
- a scanned stack (the denoiser's ``blocks``) carries a leading axis of N
  layers, which maps onto an ``nn.ModuleList``;
- an ``OptimizedLSTMCell`` named ``<name>_<k>`` is layer k of the
  ``nn.LSTM`` called ``<name>``: its input kernels ``i{i,f,g,o}`` (no bias)
  stack into ``weight_ih_l<k>`` and its hidden kernels ``h{i,f,g,o}`` into
  ``weight_hh_l<k>``, rows in torch's gate order (i, f, g, o); the hidden
  biases become ``bias_ih_l<k>`` and ``bias_hh_l<k>`` is 0.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_GATES = "ifgo"


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, dtype=np.float32)


def _kernel(module: nn.Module, w: np.ndarray) -> np.ndarray:
    if isinstance(module, nn.Linear):
        return w.T
    if isinstance(module, nn.ConvTranspose1d):
        return np.transpose(w[::-1], (1, 2, 0))
    if isinstance(module, nn.Conv1d):
        return np.transpose(w, (2, 1, 0))
    if isinstance(module, nn.Conv2d):
        return np.transpose(w, (3, 2, 0, 1))
    raise TypeError(f"no kernel rule for {type(module).__name__}")


def _lstm_layer(model: nn.Module, cell_path: tuple):
    """(name of the nn.LSTM, layer index) that the flax cell at
    ``cell_path`` maps onto, or None when it is no such cell."""
    name, _, k = cell_path[-1].rpartition("_")
    if not (name and k.isdigit()):
        return None
    mod_name = ".".join(cell_path[:-1] + (name,))
    try:
        module = model.get_submodule(mod_name)
    except AttributeError:
        return None
    return (mod_name, int(k)) if isinstance(module, nn.LSTM) else None


def flax_to_state_dict(params: dict, model: nn.Module,
                       batch_stats: dict | None = None) -> dict:
    """Map a flax param tree (and its ``batch_stats``) onto ``model``'s
    parameter and buffer names."""
    out: dict[str, torch.Tensor] = {}

    def put(path: tuple, leaf: str, value: np.ndarray):
        if leaf == "kernel" and path[-1] == "qkv":
            for name, part in zip("qkv", np.split(value, 3, axis=-1)):
                put(path[:-1] + (name,), leaf, part)
            return
        for i in range(len(path)):
            if (isinstance(model.get_submodule(".".join(path[:i + 1])),
                           nn.ModuleList)
                    and not (i + 1 < len(path) and path[i + 1].isdigit())):
                # scanned stack: the leading axis is the layer index
                for n in range(value.shape[0]):
                    put(path[:i + 1] + (str(n),) + path[i + 1:], leaf,
                        value[n])
                return
        mod_name = ".".join(path)
        if leaf == "kernel":
            value = _kernel(model.get_submodule(mod_name), value)
            name = "weight"
        elif leaf in ("scale", "embedding"):
            name = "weight"
        else:
            name = leaf
        out[f"{mod_name}.{name}"] = torch.from_numpy(np.array(value))

    cells: dict[tuple, dict] = {}
    for path, value in _flatten(params):
        gate = path[-2] if len(path) >= 3 else ""
        if (len(gate) == 2 and gate[0] in "ih" and gate[1] in _GATES
                and _lstm_layer(model, path[:-2])):
            cells.setdefault(path[:-2], {})[(gate, path[-1])] = value
        else:
            put(path[:-1], path[-1], value)
    for cell_path, leaves in cells.items():
        mod_name, k = _lstm_layer(model, cell_path)

        def stack(src, leaf):
            return np.concatenate([leaves[(src + g, leaf)].T
                                   for g in _GATES], axis=0)

        bias_ih = stack("h", "bias")
        for name, value in ((f"weight_ih_l{k}", stack("i", "kernel")),
                            (f"weight_hh_l{k}", stack("h", "kernel")),
                            (f"bias_ih_l{k}", bias_ih),
                            (f"bias_hh_l{k}", np.zeros_like(bias_ih))):
            out[f"{mod_name}.{name}"] = torch.from_numpy(
                np.ascontiguousarray(value))

    for path, value in _flatten(batch_stats or {}):
        mod_name = ".".join(path[:-1])
        out[f"{mod_name}.running_{path[-1]}"] = torch.from_numpy(value)
        out[f"{mod_name}.num_batches_tracked"] = torch.tensor(0)
    return out


def load_flax_params(model: nn.Module, params: dict,
                     batch_stats: dict | None = None) -> nn.Module:
    """Load a flax param tree (and the ``batch_stats`` of its BatchNorms)
    into ``model`` with ``strict=True``."""
    model.load_state_dict(flax_to_state_dict(params, model, batch_stats),
                          strict=True)
    return model
