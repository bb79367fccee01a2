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
  biases become ``bias_ih_l<k>`` and ``bias_hh_l<k>`` is 0; the cells
  ``<name>_fwd`` and ``<name>_bwd`` (a flax ``nn.RNN`` pair, the second
  reversed) are the two directions of the bidirectional one-layer
  ``nn.LSTM`` called ``<name>`` (``..._l0`` and ``..._l0_reverse``);
- a weight-normalised conv (``WNConv``) keeps its leaves: ``v`` in the
  flax kernel layout (k..., in/groups, out) -> (out, in/groups, k...),
  ``g`` and ``bias`` as they are.

:func:`state_dict_to_flax` is the inverse: a port module's parameters as
the flax tree, every rule undone (an LSTM layer's two biases fold into the
``h*`` biases, ``bias_ih + bias_hh``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cmtts_tpu_torch.models.hifigan_disc import WNConv

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
    if isinstance(module, (nn.Conv1d, nn.Conv2d, WNConv)):
        # (k..., in, out) -> (out, in, k...)
        return np.transpose(w, (w.ndim - 1, w.ndim - 2, *range(w.ndim - 2)))
    raise TypeError(f"no kernel rule for {type(module).__name__}")


def _flax_kernel(module: nn.Module, w: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_kernel`."""
    if isinstance(module, nn.Linear):
        return w.T
    if isinstance(module, nn.ConvTranspose1d):
        return np.transpose(w, (2, 0, 1))[::-1]
    # (out, in, k...) -> (k..., in, out)
    return np.transpose(w, (*range(2, w.ndim), 1, 0))


_DIRECTIONS = {"fwd": "", "bwd": "_reverse"}


def _lstm_layer(model: nn.Module, cell_path: tuple):
    """(name of the nn.LSTM, the suffix of its parameters for this cell,
    ``l<k>`` or ``l0[_reverse]``) that the flax cell at ``cell_path`` maps
    onto, or None when it is no such cell."""
    name, _, k = cell_path[-1].rpartition("_")
    if not (name and (k.isdigit() or k in _DIRECTIONS)):
        return None
    mod_name = ".".join(cell_path[:-1] + (name,))
    try:
        module = model.get_submodule(mod_name)
    except AttributeError:
        return None
    if not isinstance(module, nn.LSTM) or \
            module.bidirectional != (k in _DIRECTIONS):
        return None
    return mod_name, (f"l{k}" if k.isdigit() else f"l0{_DIRECTIONS[k]}")


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
        if leaf == "kernel" or (leaf == "v" and isinstance(
                model.get_submodule(mod_name), WNConv)):
            value = _kernel(model.get_submodule(mod_name), value)
            name = "weight" if leaf == "kernel" else leaf
        elif leaf in ("scale", "embedding"):
            name = "weight"
        else:
            name = leaf
        key = f"{mod_name}.{name}" if mod_name else name
        out[key] = torch.from_numpy(np.array(value))

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
        for name, value in ((f"weight_ih_{k}", stack("i", "kernel")),
                            (f"weight_hh_{k}", stack("h", "kernel")),
                            (f"bias_ih_{k}", bias_ih),
                            (f"bias_hh_{k}", np.zeros_like(bias_ih))):
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


def state_dict_to_flax(model: nn.Module,
                       params: dict[str, torch.Tensor] | None = None) -> dict:
    """The flax param tree (nested dicts of float32 numpy arrays) of
    ``model``'s parameters, those named in ``params`` (by
    ``named_parameters`` name) taken from there: :func:`flax_to_state_dict`
    undone.  BatchNorm statistics, which flax keeps apart in
    ``batch_stats``, are not params and are left out."""
    params = {**dict(model.named_parameters()), **(params or {})}
    tree: dict = {}
    stacks: dict[tuple, dict[int, np.ndarray]] = {}

    def put(path: tuple, value: np.ndarray):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(value)

    def place(mod_path: tuple, rest: tuple, value: np.ndarray):
        """Put the leaf ``rest`` of the module at ``mod_path``."""
        for i in range(1, len(mod_path)):
            if isinstance(model.get_submodule(".".join(mod_path[:i])),
                          nn.ModuleList):
                # a scanned stack: layer n is index n of a leading axis
                flat = mod_path[:i] + mod_path[i + 1:] + rest
                stacks.setdefault(flat, {})[int(mod_path[i])] = value
                return
        put(mod_path + rest, value)

    def get(name: str) -> np.ndarray:
        return params[name].detach().cpu().float().numpy()

    for mod_name, m in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        own = [n for n, _ in m.named_parameters(recurse=False)]
        if not own:
            continue
        full = {n: f"{mod_name}.{n}" if mod_name else n for n in own}
        if isinstance(m, nn.LSTM):
            H = m.hidden_size
            cell = prefix[:-1]
            layers = ([(f"l0{sfx}", d) for d, sfx in _DIRECTIONS.items()]
                      if m.bidirectional else
                      [(f"l{k}", str(k)) for k in range(m.num_layers)])
            for k, tag in layers:
                w_ih, w_hh = get(full[f"weight_ih_{k}"]), \
                    get(full[f"weight_hh_{k}"])
                bias = get(full[f"bias_ih_{k}"]) + get(full[f"bias_hh_{k}"])
                for g, gate in enumerate(_GATES):
                    rows = slice(g * H, (g + 1) * H)
                    at = (f"{prefix[-1]}_{tag}",)
                    place(cell, at + (f"i{gate}", "kernel"), w_ih[rows].T)
                    place(cell, at + (f"h{gate}", "kernel"), w_hh[rows].T)
                    place(cell, at + (f"h{gate}", "bias"), bias[rows])
            continue
        for n in own:
            value = get(full[n])
            leaf = n
            if n == "weight" and isinstance(m, (nn.Linear, nn.Conv1d,
                                                nn.Conv2d,
                                                nn.ConvTranspose1d)):
                value, leaf = _flax_kernel(m, value), "kernel"
            elif n == "v" and isinstance(m, WNConv):
                value = _flax_kernel(m, value)
            elif n == "weight" and isinstance(m, nn.Embedding):
                leaf = "embedding"
            elif n == "weight":      # LayerNorm, BatchNorm
                leaf = "scale"
            place(prefix, (leaf,), value)
    for path, layers in stacks.items():
        put(path, np.stack([layers[n] for n in sorted(layers)]))
    _fuse_qkv(tree)
    return tree


def _fuse_qkv(tree: dict):
    """Fold sibling ``q``, ``k``, ``v`` Dense kernels (no biases) back into
    the fused ``qkv`` (C, 3C) of the flax attention."""
    for node in tree.values():
        if isinstance(node, dict):
            _fuse_qkv(node)
    qkv = [tree.get(n) for n in "qkv"]
    if all(isinstance(x, dict) and set(x) == {"kernel"} for x in qkv):
        tree["qkv"] = {"kernel": np.concatenate([x["kernel"] for x in qkv],
                                                axis=-1)}
        for n in "qkv":
            del tree[n]
