"""The one bridge from a flax param tree (a nested dict of numpy arrays, as
``flax.linen.Module.init`` or a flat ``a/b/c`` npz gives it) to a port
module's ``state_dict``.

The port's modules carry the flax module names, so the mapping is
mechanical: ``a/b/c/<leaf>`` -> ``a.b.c.<name>``, with these layout rules:

- ``kernel`` of a Dense (in, out) -> ``Linear.weight`` (out, in);
- ``kernel`` of a Conv (k, in, out) -> ``Conv1d.weight`` (out, in, k);
- ``kernel`` of a ConvTranspose (k, in, out) -> ``ConvTranspose1d.weight``
  (in, out, k) with the taps flipped;
- ``scale`` (LayerNorm) and ``embedding`` (Embed) -> ``weight``;
- the encoder's fused ``qkv`` Dense (C, 3C) splits into ``q``, ``k``, ``v``;
- a scanned stack (the denoiser's ``blocks``) carries a leading axis of N
  layers, which maps onto an ``nn.ModuleList``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


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
    raise TypeError(f"no kernel rule for {type(module).__name__}")


def flax_to_state_dict(params: dict, model: nn.Module) -> dict:
    """Map a flax param tree onto ``model``'s parameter names."""
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

    for path, value in _flatten(params):
        put(path[:-1], path[-1], value)
    return out


def load_flax_params(model: nn.Module, params: dict) -> nn.Module:
    """Load a flax param tree into ``model`` with ``strict=True``."""
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return model
