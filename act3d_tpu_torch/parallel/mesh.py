"""Process group, device mesh, batch split and module sharding.

Counterpart of ``act3d_tpu/parallel/mesh.py``.  JAX runs one program over
a ``("dp",)`` or ``("dp", "fsdp")`` mesh of devices; the port runs one
process per device (``torchrun``), each holding ``1/world`` of one global
batch of ``--batch_size`` rows:

* ``fsdp = 1``: DDP (``DistributedDataParallel``) over the 1-D ``("dp",)``
  mesh, every parameter and moment replicated, gradients averaged;
* ``fsdp = F > 1``: FSDP2 (``torch.distributed.fsdp.fully_shard``) per
  block and at the root over the 2-D ``("dp", "fsdp")`` mesh of shape
  ``(world / F, F)`` (hybrid sharding: trainable parameters, gradients and
  AdamW moments sharded over ``fsdp``, replicated over ``dp``).

The numerics are the one-device run's: the batch splits over every rank,
the random draws are made at the global batch (``nn/dropout.py``), the
diffusion loss divides by the global count of valid points, and both
wrappers average gradients over the ranks.  FSDP2 shards dim 0 of each
parameter (JAX shards its largest divisible axis): a layout, not a
numeric, difference.

The frozen CLIP trunk is left out of both wrappers (``ignored_params``):
replicated on every rank.  It has no gradient and no moments, so sharding
it would save only its 1/F share of weights while adding an all-gather of
them to every step.

Checkpoints stay in the one-device layout (:func:`full_state_dict`,
:func:`full_optimizer_state`): no ``module.`` prefix, no DTensor, gathered
by every rank and written by rank 0.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ..nn.layers import FeedforwardLayer, ParallelAttentionLayer, RelativeCrossAttentionLayer

__all__ = ["BLOCK_TYPES", "batch_rows", "full_optimizer_state", "full_state_dict",
           "host_group", "init_distributed", "launched", "load_full_optimizer_state",
           "load_full_state_dict", "local_batch_size", "local_rank", "make_mesh",
           "set_gradient_sync", "shard_module", "shutdown_distributed", "world_size"]

# the modules FSDP2 wraps one by one (each called through its forward)
BLOCK_TYPES = (ParallelAttentionLayer, RelativeCrossAttentionLayer, FeedforwardLayer)

_HOST_GROUP = None
_OWNS_GROUP = False


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _backend(device: torch.device) -> str:
    """NCCL when each rank has a card of its own, else gloo (the CPU, or
    several ranks sharing one card, which NCCL refuses)."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device) -> Tuple[int, int]:
    """(rank, world).  A process group the caller has initialised is used
    as it is; under a launcher one is initialised from ``env://``; else
    (one process) nothing is and the world is 1."""
    global _HOST_GROUP, _OWNS_GROUP
    if not dist.is_initialized():
        if not launched():
            return 0, 1
        dist.init_process_group(_backend(torch.device(device)), init_method="env://")
        _OWNS_GROUP = True
    if _HOST_GROUP is None:
        # host-side flags and metric objects go over gloo, so that reading
        # them never waits for the card's queue
        _HOST_GROUP = (dist.new_group(backend="gloo")
                       if dist.get_backend() != "gloo" else dist.group.WORLD)
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed():
    """Destroy the process group :func:`init_distributed` initialised (one a
    caller initialised is left to the caller)."""
    global _HOST_GROUP, _OWNS_GROUP
    if _OWNS_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP, _OWNS_GROUP = None, False


def host_group():
    """The gloo group of host-side collectives (None without a process
    group)."""
    return _HOST_GROUP if dist.is_initialized() else None


def make_mesh(num_devices: Optional[int] = None, fsdp: int = 1, device_type: str = "cuda"):
    """The ``("dp",)`` mesh (``fsdp <= 1``) or the ``("dp", "fsdp")`` mesh of
    shape ``(n / fsdp, fsdp)`` over the ``n`` ranks; None on one process
    without a process group (the plain module).  ``num_devices`` None or
    < 0 means the launched world size; another count than that raises, as
    does an ``fsdp`` that does not divide it (JAX's message)."""
    world = world_size()
    n = world if num_devices is None or num_devices < 0 else num_devices
    if fsdp > 1 and n % fsdp != 0:
        raise ValueError(f"fsdp={fsdp} does not divide the {n} devices")
    if n != world:
        raise ValueError(f"--num_devices {n} asks for {n} devices but {world} process(es) "
                         f"run: launch one per device, e.g. torchrun --nproc_per_node {n}")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    if fsdp <= 1:
        return init_device_mesh(device_type, (n,), mesh_dim_names=("dp",))
    return init_device_mesh(device_type, (n // fsdp, fsdp), mesh_dim_names=("dp", "fsdp"))


def local_batch_size(batch_size: int, world: int) -> int:
    """Rows per rank of a global batch; JAX's ``shard_batch`` error when
    the batch does not divide over the devices."""
    if batch_size % world != 0:
        raise ValueError(
            f"batch size {batch_size} is not divisible by the {world}-device dp mesh; pick "
            f"a multiple (e.g. --batch_size {-(-batch_size // world) * world}) or fewer "
            "devices (--num_devices)")
    return batch_size // world


def batch_rows(rank: int, world: int, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch (arrays, tensors or lists with a
    leading batch dim): rows ``rank x b .. (rank + 1) x b - 1`` of each,
    ``b = B / world``."""
    if world == 1:
        return batch
    b = local_batch_size(len(next(iter(batch.values()))), world)
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def shard_module(module: nn.Module, mesh, param_dtype: Optional[torch.dtype] = None
                 ) -> nn.Module:
    """``module`` wrapped for ``mesh``: as it is without a mesh, in DDP on a
    1-D mesh, and on a 2-D mesh sharded in place by ``fully_shard``, each
    :data:`BLOCK_TYPES` submodule and then the root.  Frozen parameters
    (``requires_grad`` False, set before this call) are left out of both
    wrappers.  ``param_dtype`` (FSDP2 only): the dtype the sharded
    parameters are gathered in for compute, gradients reduced in float32;
    DDP's mixed precision is the loss function's own cast
    (``train/flagship.py``)."""
    if mesh is None:
        return module
    frozen = {p for p in module.parameters() if not p.requires_grad}
    if mesh.ndim == 1:
        from torch.nn.parallel import DistributedDataParallel

        dev = next(p for p in module.parameters() if p.requires_grad).device
        # find_unused_parameters: an FPN level the model does not read gets
        # no gradient; broadcast_buffers off: the buffers are constants
        return DistributedDataParallel(
            module, device_ids=[dev.index] if dev.type == "cuda" else None,
            device_mesh=mesh, broadcast_buffers=False, find_unused_parameters=True)
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    policy = MixedPrecisionPolicy(
        param_dtype=param_dtype, reduce_dtype=torch.float32 if param_dtype else None,
        cast_forward_inputs=False)
    blocks = [m for m in module.modules() if isinstance(m, BLOCK_TYPES)]
    for block in reversed(blocks):
        fully_shard(block, mesh=mesh, mp_policy=policy, ignored_params=frozen)
    fully_shard(module, mesh=mesh, mp_policy=policy, ignored_params=frozen)
    return module


def set_gradient_sync(wrapped: nn.Module, sync: bool):
    """A context for one micro-batch's forward and backward: without
    ``sync`` the wrapper keeps the gradients local (DDP's ``no_sync``,
    FSDP2's ``set_requires_gradient_sync(False)``), as on the micro-batches
    of a gradient accumulation that do not step."""
    import contextlib

    from torch.nn.parallel import DistributedDataParallel

    if sync:
        return contextlib.nullcontext()
    if isinstance(wrapped, DistributedDataParallel):
        return wrapped.no_sync()
    if hasattr(wrapped, "set_requires_gradient_sync"):
        @contextlib.contextmanager
        def no_sync():
            wrapped.set_requires_gradient_sync(False)
            try:
                yield
            finally:
                wrapped.set_requires_gradient_sync(True)
        return no_sync()
    return contextlib.nullcontext()


# ------------------------------------------------------------ state dicts
def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _full(t):
    """A DTensor gathered to its full tensor (a collective over its shard
    groups), else ``t``.  FSDP2 cuts each sharded dim as ``torch.chunk``
    does (the last shards short or empty): every shard is padded to the
    longest, gathered with ``dist.all_gather``, and the padding cut off.
    (``DTensor.full_tensor``'s functional collectives crash over gloo with
    CUDA tensors on torch 2.11; these plain ones do not.)"""
    if not _is_dtensor(t):
        return t
    out = t.to_local()
    for mesh_dim, placement in enumerate(t.placements):
        if not placement.is_shard():
            continue
        dim, n = placement.dim, t.device_mesh.size(mesh_dim)
        longest = -(-t.shape[dim] // n)
        pad = list(out.shape)
        pad[dim] = longest - out.shape[dim]
        padded = torch.cat([out, out.new_zeros(pad)], dim).contiguous()
        parts = [torch.empty_like(padded) for _ in range(n)]
        dist.all_gather(parts, padded, group=t.device_mesh.get_group(mesh_dim))
        out = torch.cat(parts, dim).narrow(dim, 0, t.shape[dim])
    return out


def _like(full: torch.Tensor, ref):
    """``full`` laid out as ``ref``: when ref is a DTensor, this rank's
    ``torch.chunk`` shard of ``full`` on ref's mesh and placements (every
    rank holds ``full``, so no collective), else ``full`` itself."""
    if not _is_dtensor(ref):
        return full
    from torch.distributed.tensor import DTensor

    local = full.to(device=ref.device, dtype=ref.dtype)
    for mesh_dim, placement in enumerate(ref.placements):
        if placement.is_shard():
            chunks = torch.chunk(local, ref.device_mesh.size(mesh_dim), dim=placement.dim)
            coord = ref.device_mesh.get_local_rank(mesh_dim)
            local = (chunks[coord] if coord < len(chunks)
                     else local.narrow(placement.dim, 0, 0))
    return DTensor.from_local(local.contiguous(), ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape, stride=ref.stride())


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded entry gathered: the
    one-device layout.  Every rank calls it (a collective under FSDP2)."""
    return {k: _full(v) for k, v in module.state_dict().items()}


def load_full_state_dict(module: nn.Module, state: Dict[str, torch.Tensor]):
    """Load a one-device state dict, sharding each entry as ``module``'s own
    (every rank calls it)."""
    current = module.state_dict()
    module.load_state_dict({k: _like(v, current[k]) if k in current else v
                            for k, v in state.items()})


def full_optimizer_state(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with sharded moments gathered (the
    one-device layout; every rank calls it)."""
    state = optimizer.state_dict()
    state["state"] = {i: {k: _full(v) for k, v in s.items()}
                      for i, s in sorted(state["state"].items())}
    return state


def load_full_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict[str, Any]):
    """Load a one-device optimizer state, each moment sharded as its
    parameter (every rank calls it)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    ids = [i for g in state["param_groups"] for i in g["params"]]
    by_id = dict(zip(ids, params))
    state = dict(state)
    state["state"] = {
        i: {k: _like(v, by_id[i]) if torch.is_tensor(v) and v.shape == by_id[i].shape else v
            for k, v in s.items()}
        for i, s in sorted(state["state"].items())}
    optimizer.load_state_dict(state)
