"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``cmtts_tpu/parallel/sharding.py``).

The JAX package shards a batch over a device mesh and lets XLA insert the
collectives.  Here each rank is one process: the "mesh" is a pair of
process groups, ``data`` (ranks holding the same denoiser shard, which
split the batch) and ``model`` (ranks holding the shards of one denoiser,
which see the same rows).  World = dp x tp; rank r has data index
r // tp and model index r % tp.

- Data parallelism: every rank draws the global batch's noise from one
  shared generator and keeps its own contiguous rows (:func:`rank_rows`),
  the losses divide by global denominators, and the gradients are summed
  by one all-reduce of a flat buffer (:func:`all_reduce_grads`), so that a
  step over N ranks computes the one-device step over the global batch.
- Tensor parallelism (the Megatron split of the denoiser blocks, JAX's
  ``_TP_BLOCK_SPECS``): ``conv_gate`` and ``conv_filt`` split their output
  channels, ``out_proj`` its input features, with its bias added once after
  the reduce (:class:`CopyToGroup` / :class:`ReduceFromGroup`).

Collectives on CUDA tensors over a gloo group (several ranks on one card,
where NCCL refuses to run) go through a host copy, explicitly: gloo stages
CUDA tensors through host memory in any case.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

# the denoiser blocks' Megatron split: (layer, leaf) -> the dim cut
_TP_SPLIT = {("conv_gate", "weight"): 0, ("conv_gate", "bias"): 0,
             ("conv_filt", "weight"): 0, ("conv_filt", "bias"): 0,
             ("out_proj", "weight"): 1}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The two process groups of a (data x model) layout; a group is None
    when its degree is 1."""
    data: dist.ProcessGroup | None
    model: dist.ProcessGroup | None
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int


SINGLE = Mesh(None, None, 1, 1, 0, 0)


def init_distributed(device: str | torch.device,
                     backend: str | None = None) -> tuple[int, int,
                                                          torch.device]:
    """Join the process group that ``torchrun`` (env:// variables RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) describes; ->
    (rank, world, device).  Without RANK the process runs alone and no
    group is made.

    The backend is ``nccl`` on ``cuda`` and ``gloo`` on the CPU unless
    ``backend`` says otherwise (gloo on the card lets several ranks share
    one card).  On ``cuda`` without an index the device is
    ``cuda:LOCAL_RANK``; an explicit index is kept.  A group that exists
    already is joined as it is."""
    device = torch.device(device)
    if "RANK" not in os.environ and not dist.is_initialized():
        return 0, 1, device
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(
            backend, device_id=device if backend == "nccl" else None)
    return dist.get_rank(), dist.get_world_size(), device


def make_mesh(tp: int = 1) -> Mesh:
    """Split the world into ``world // tp`` data-parallel replicas of a
    ``tp``-way split denoiser (the counterpart of ``make_mesh_2d``).  Every
    rank must call it, in the same order as the other ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp < 1 or world % tp:
        raise ValueError(f"--tp {tp} does not divide the world size {world}")
    if world == 1:
        return SINGLE
    rank, dp = dist.get_rank(), world // tp
    data = model = None
    if dp > 1:
        for j in range(tp):
            g = dist.new_group(list(range(j, world, tp)))
            if j == rank % tp:
                data = g
    if tp > 1:
        for d in range(dp):
            g = dist.new_group(list(range(d * tp, (d + 1) * tp)))
            if d == rank // tp:
                model = g
    return Mesh(data, model, dp, tp, rank // tp, rank % tp)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (returns it)."""
    if _via_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in group
    rank order."""
    src = t.detach().contiguous()
    host = _via_host(src, group)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` in place from global rank ``src`` of ``group``."""
    if _via_host(t, group):
        h = t.cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


class AllReduceSum(torch.autograd.Function):
    """A sum over the ranks that every rank's loss uses: all-reduce forward
    and backward (the gradient of the ranks' summed objective)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class CopyToGroup(torch.autograd.Function):
    """Megatron's "copy to the group": identity forward, all-reduce
    backward (the input of column-parallel layers)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """Megatron's "reduce from the group": all-reduce forward, identity
    backward (the output of a row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (``x`` itself when None)."""
    return x if group is None else AllReduceSum.apply(x, group)


def global_count(x: torch.Tensor, group) -> torch.Tensor:
    """A denominator (no gradient) summed over ``group``."""
    x = x.detach()
    return x if group is None else all_reduce_(x.clone(), group)


# -- batches -----------------------------------------------------------------

def _map_rows(fn, tree, B: int):
    if isinstance(tree, dict):
        return {k: _map_rows(fn, v, B) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.ndim > 0 and tree.shape[0] == B:
        return fn(tree)
    return tree


def _leading_size(tree) -> int:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            return _leading_size(v)
        if isinstance(v, np.ndarray) and v.ndim > 0:
            return v.shape[0]
    raise ValueError("the batch holds no array")


# Copied from cmtts_tpu/parallel/sharding.py:75-102 (pad_batch_to_multiple,
# jax.tree_util.tree_map replaced by a walk over nested dicts).
def pad_batch_to_multiple(batch: dict, multiple: int) -> tuple[dict, int]:
    """Pad batch axis 0 up to a device-count multiple (repeating the last
    sample); returns (batch, original_size).

    A ``sample_valid`` mask (1 for real rows, 0 for duplicates) is added
    so the train step can zero the duplicates' loss contribution exactly
    (cm weights rescaled, variance masks zeroed — see
    ``cm/losses.variance_loss``); without it the duplicates would
    slightly re-weight the gradient.
    """
    B = _leading_size(batch)
    rem = B % multiple
    if rem == 0:
        return batch, B
    pad_n = multiple - rem

    def pad(x):
        return np.concatenate([x, np.repeat(x[-1:], pad_n, axis=0)], axis=0)

    out = _map_rows(pad, batch, B)
    out["sample_valid"] = np.concatenate(
        [np.ones(B, np.float32), np.zeros(pad_n, np.float32)])
    return out, B


def rank_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous rows of a numpy batch whose size divides
    by ``world`` (pad it first); host lists such as ``ids`` are cut the
    same way."""
    B = _leading_size(batch)
    if B % world:
        raise ValueError(f"batch of {B} rows does not split over {world} "
                         "ranks; pad it with pad_batch_to_multiple")
    n = B // world
    rows = slice(rank * n, (rank + 1) * n)
    out = _map_rows(lambda x: x[rows], batch, B)
    for k, v in batch.items():
        if isinstance(v, list) and len(v) == B:
            out[k] = v[rows]
    return out


def rank_share(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous rows of a tensor of the global batch."""
    if group is None:
        return x
    n = x.shape[0] // group_size(group)
    return x[group_rank(group) * n:][:n]


def gather_per_sample(x: torch.Tensor, group=None) -> np.ndarray:
    """A per-sample output of the ranks' rows (indices, per-sample losses)
    as host numpy in the global row order: the LSM sampler's history must
    see every sample of the global batch (the reference all-gathers them,
    resample.py:117-153)."""
    if group is not None:
        x = all_gather_cat(x, group)
    return x.detach().cpu().numpy()


def all_reduce_grads(grads: dict, group) -> dict:
    """Sum the gradients over ``group`` with one all-reduce of a flat
    buffer."""
    if group is None:
        return grads
    names = list(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in names])
    all_reduce_(flat, group)
    out, at = {}, 0
    for k in names:
        n = grads[k].numel()
        out[k] = flat[at:at + n].view_as(grads[k])
        at += n
    return out


def broadcast_params(params: dict, src: int = 0, group=None) -> None:
    """Every tensor of ``params`` in place from rank ``src``."""
    for v in params.values():
        broadcast_(v, src, group)


def broadcast_state(state, src: int = 0) -> None:
    """A train state (params, optimizer moments, EMAs, target) in place
    from rank ``src`` of the world, so that every rank starts alike."""
    for tree in (state.params, state.opt_state["mu"], state.opt_state["nu"],
                 state.target_params, *state.ema_params):
        broadcast_params(tree, src)


# -- tensor parallelism -------------------------------------------------------

def tp_split_dim(name: str) -> int | None:
    """The dim that the Megatron split cuts in the parameter ``name``
    (``.../blocks/<i>/<layer>/<leaf>`` at any prefix depth, as the JAX
    package's ``_tp_spec_for_path``), or None for a replicated one."""
    parts = name.split(".")
    if len(parts) >= 4 and parts[-4] == "blocks":
        return _TP_SPLIT.get((parts[-2], parts[-1]))
    return None


def tp_shard_params(params: dict, rank: int, tp: int) -> dict:
    """Rank ``rank``'s shard of every split parameter; the others as they
    are."""
    out = {}
    for k, v in params.items():
        d = tp_split_dim(k)
        if d is not None and tp > 1:
            if v.shape[d] % tp:
                raise ValueError(f"{k} {tuple(v.shape)} does not split "
                                 f"{tp} ways along dim {d}")
            v = v.chunk(tp, d)[rank].contiguous()
        out[k] = v
    return out


def tp_gather_params(params: dict, group) -> dict:
    """The whole parameters from the shards of ``group``."""
    if group is None:
        return params
    return {k: (v if tp_split_dim(k) is None
                else all_gather_cat(v, group, tp_split_dim(k)))
            for k, v in params.items()}


def _map_state(state, fn):
    return dataclasses.replace(
        state, params=fn(state.params), target_params=fn(state.target_params),
        ema_params=tuple(fn(e) for e in state.ema_params),
        opt_state=dict(state.opt_state, mu=fn(state.opt_state["mu"]),
                       nu=fn(state.opt_state["nu"])))


def tp_shard_state(state, rank: int, tp: int):
    """A train state's params, EMAs, target and RAdam moments split by
    :func:`tp_split_dim` (the counterpart of ``tp_shard_tree``)."""
    return _map_state(state, lambda p: tp_shard_params(p, rank, tp))


def tp_gather_state(state, group):
    """The whole train state from its shards: a checkpoint written from it
    is the single-device run's, and resumes at any tp."""
    if group is None:
        return state
    return _map_state(state, lambda p: tp_gather_params(p, group))


def set_tp_group(denoiser, group) -> None:
    """Run ``denoiser``'s blocks split over ``group`` (None: whole)."""
    for block in denoiser.blocks:
        block.tp_group = group


def shard_module(denoiser, group) -> None:
    """Cut ``denoiser``'s own block parameters to this rank's shards in
    place and run its blocks split over ``group`` (the inference path,
    which calls the module directly)."""
    tp, rank = group_size(group), group_rank(group)
    with torch.no_grad():
        for name, p in denoiser.named_parameters():
            d = tp_split_dim(name)
            if d is not None:
                p.data = p.data.chunk(tp, d)[rank].contiguous()
    set_tp_group(denoiser, group)
