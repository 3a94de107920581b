"""Device meshes and the torch.distributed layer (port of
``unirec_tpu/parallel/mesh.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` with axes
``("dp", "tp", "sp")``.  The port maps it onto PyTorch's two idioms:

* inference (the item-token sweep, serving) is one process over N devices:
  ``make_mesh`` lays the devices out as JAX does, each device holds a replica
  of the weights, and a batch is split over the ``dp`` axis;
* training is one process a rank.  The ranks of a ``torch.distributed``
  world are laid out as ``arange(world).reshape(dp, tp, sp)``, JAX's device
  order (sp the fastest axis).  ``DistMesh`` holds this rank's place and
  the groups of its axes: the dp group (the ranks with its tp and sp
  index), the tp group (the ranks with its dp and sp index) and the sp
  group (the ranks with its dp and tp index).  Gradients are summed over
  the ranks with this rank's tp index (the world when tp = 1) in a few flat
  buckets (``all_reduce_sum``) and divided by dp: with each sp rank's loss
  scaled by 1/sp that is the dp mean of the sp sum
  (``ops/sharded_attention.py``).  The tp ranks of one dp index hold
  shards of the Qwen3 base (``parallel/tensor.py``) or, in the item and
  user trainers, replicas that compute one step;
* the pipeline's ranks are laid out ``arange(world).reshape(dp, pp)``, pp
  the fastest axis (JAX's ``make_pp_mesh``): ``PipeMesh`` holds this
  rank's stage, its neighbours and the pp and dp groups
  (``parallel/pipeline.py``).

``init_distributed`` is the counterpart of ``initialize_multihost``: it
reads ``torchrun``'s environment or takes the address, world size and rank
itself, with NCCL on the card and gloo on the CPU (gloo on the card only
when the caller names it).  Every group it makes has an explicit timeout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from unirec_tpu_torch.configs import MeshConfig

DP_AXIS, TP_AXIS, SP_AXIS = "dp", "tp", "sp"
AXES = (DP_AXIS, TP_AXIS, SP_AXIS)
DEFAULT_TIMEOUT_S = 1800.0
# the gradient all-reduce's bucket: a few collectives for the joint
# model's 654 leaves rather than one a leaf
BUCKET_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices (or ranks) laid out ``[dp, tp, sp]``; ``shape`` maps each
    axis to its size, as ``jax.sharding.Mesh.shape`` does."""

    devices: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def dp_devices(self) -> List[Any]:
        """The devices of the dp axis at tp = sp = 0: where an inference
        replica of each batch shard runs."""
        return list(self.devices[:, 0, 0])


def visible_devices() -> List[torch.device]:
    """Every visible card, ``jax.devices()`` for the port."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(config: MeshConfig = MeshConfig(),
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """The JAX ``make_mesh``: explicit sizes take the first dp*tp*sp
    devices and raise when there are fewer; ``dp=-1`` takes every device
    (``MeshConfig.axis_sizes``).  ``devices`` defaults to every visible
    card; an explicit list may name one device more than once (replicas
    that share it)."""
    devices = list(devices if devices is not None else visible_devices())
    tp, sp = max(1, config.tp), max(1, config.sp)
    if config.dp > 0:
        need = config.dp * tp * sp
        if need > len(devices):
            raise ValueError(f"mesh {config.dp}x{tp}x{sp} needs {need} "
                             f"devices, have {len(devices)}")
        devices = devices[:need]
        dp = config.dp
    else:
        dp, tp, sp = config.axis_sizes(len(devices))
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, tp, sp))


def inference_mesh(dp: int, device) -> Optional[Mesh]:
    """The sweep's and serving's ``--dp``: None for one device; otherwise
    ``dp`` cards (-1: every visible card), or ``dp`` replicas that share the
    CPU when ``device`` is the CPU.  More cards than there are raises."""
    device = torch.device(device)
    if device.type == "cpu":
        n = max(dp, 1)
        return make_mesh(MeshConfig(dp=n), [device] * n) if n > 1 else None
    mesh = make_mesh(MeshConfig(dp=dp))
    return mesh if mesh.size > 1 else None


def pad_batch(batch: Dict[str, np.ndarray], multiple: int
              ) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad the leading axis of every array up to a multiple by repeating
    the last row; returns (padded batch, original size).  For inference,
    whose padded rows are trimmed from the outputs."""
    sizes = {x.shape[0] for x in batch.values()}
    assert len(sizes) == 1, f"inconsistent batch dims: {sizes}"
    n = sizes.pop()
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    return {k: np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
            for k, x in batch.items()}, n


def shard_rows(n: int, shards: int, index: int) -> slice:
    """The rows of shard ``index`` of ``n`` split into ``shards`` equal
    blocks (JAX's ``P("dp")`` layout)."""
    if n % shards:
        raise ValueError(f"batch of {n} rows not divisible by dp mesh size "
                         f"{shards}")
    per = n // shards
    return slice(index * per, (index + 1) * per)


# -- torch.distributed ----------------------------------------------------------


def backend_for(device, backend: Optional[str] = None) -> str:
    """NCCL for the card, gloo for the CPU; gloo on the card only when the
    caller names it (two ranks that share one card: NCCL refuses them)."""
    if backend is not None:
        return backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a local world's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def init_distributed(device="cuda", *, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join a torch.distributed world and return its size.

    Without arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); ``init_method``
    (``tcp://127.0.0.1:PORT``), ``world_size`` and ``rank`` name the world
    explicitly.  On the card each rank takes ``cuda:LOCAL_RANK`` unless
    ``device`` names one.  Already initialised: returns the world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None:
        init_method = "env://"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {}
    if backend_for(device, backend) == "nccl":
        kw["device_id"] = device
    global _TIMEOUT
    _TIMEOUT = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend_for(device, backend), init_method=init_method,
        world_size=world_size, rank=rank, timeout=_TIMEOUT, **kw)
    return world_size


def is_writer() -> bool:
    """Whether this process writes checkpoints, metrics and logs: rank 0
    of a world, or a process outside one."""
    return not dist.is_initialized() or dist.get_rank() == 0


@contextlib.contextmanager
def writer_first():
    """Rank 0 runs the block before the other ranks do (it writes what they
    then read, such as a field cache); outside a world, just the block."""
    world = dist.is_initialized() and dist.get_world_size() > 1
    if world and not is_writer():
        dist.barrier()
    yield
    if world and is_writer():
        dist.barrier()


@dataclasses.dataclass
class DistMesh:
    """This rank's place in a (dp, tp, sp) world and its axes' groups.
    ``grad_group`` holds the ranks with this rank's tp index, over which
    gradients are reduced (None: the world, when tp = 1), and
    ``grad_src`` its first rank."""

    mesh: Mesh  # of ranks
    dp_index: int
    sp_index: int
    dp_group: Any
    sp_group: Any
    tp_index: int = 0
    tp_group: Any = None
    grad_group: Any = None
    grad_src: int = 0

    @property
    def dp_size(self) -> int:
        return self.mesh.shape[DP_AXIS]

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[TP_AXIS]

    @property
    def sp_size(self) -> int:
        return self.mesh.shape[SP_AXIS]


_GROUPS: Dict[Tuple, Any] = {}
# the world's timeout, which the axes' groups take too
_TIMEOUT = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def _new_groups(lists: Iterable[Sequence[int]], rank: int):
    """One group per list of ranks (every rank makes every group, in one
    order); returns the group holding ``rank``, or None."""
    mine = None
    for members in lists:
        members = [int(r) for r in members]
        g = dist.new_group(members, timeout=_TIMEOUT)
        if rank in members:
            mine = g
    return mine


def dist_mesh(config: MeshConfig) -> Optional[DistMesh]:
    """This rank's ``DistMesh`` for ``config`` over the initialised world
    (made once per layout: every rank makes every group, in one order), or
    None outside a world when the mesh is one device.  A mesh of more than
    one device outside a world raises."""
    if not dist.is_initialized():
        dp, tp, sp = (max(config.dp, 1), max(config.tp, 1),
                      max(config.sp, 1))
        if dp * tp * sp > 1:
            raise ValueError(
                f"mesh dp={dp} x tp={tp} x sp={sp} needs a torch.distributed "
                f"world of {dp * tp * sp} ranks (parallel.init_distributed, "
                "torchrun, or the training CLI's --dp / --tp / --sp)")
        return None
    world = dist.get_world_size()
    mesh = make_mesh(config, list(range(world)))
    if mesh.size != world:
        raise ValueError(f"mesh {mesh.shape} covers {mesh.size} of the "
                         f"world's {world} ranks")
    key = (world,) + tuple(mesh.devices.shape)
    if key not in _GROUPS:
        ranks = mesh.devices.astype(np.int64)
        rank = dist.get_rank()
        dp, tp, sp = ranks.shape
        dp_group = _new_groups((ranks[:, t, s] for t in range(tp)
                                for s in range(sp)), rank)
        sp_group = _new_groups((ranks[d, t, :] for d in range(dp)
                                for t in range(tp)), rank)
        d, t, s = (int(i[0]) for i in np.nonzero(ranks == rank))
        tp_group = grad_group = None
        grad_src = 0
        if tp > 1:
            tp_group = _new_groups((ranks[d_, :, s_] for d_ in range(dp)
                                    for s_ in range(sp)), rank)
            grad_group = _new_groups((ranks[:, t_, :].reshape(-1)
                                      for t_ in range(tp)), rank)
            grad_src = int(ranks[0, t, 0])
        _GROUPS[key] = DistMesh(mesh, d, s, dp_group, sp_group, t, tp_group,
                                grad_group, grad_src)
    return _GROUPS[key]


@dataclasses.dataclass
class PipeMesh:
    """This rank's place in a ``(dp, pp)`` world (pp the fastest axis, as
    JAX's ``make_pp_mesh``): its stage and dp index, the ranks of the
    previous and next stage (None at the ends), the pp group (the ranks
    with its dp index) and the dp group (the ranks of its stage)."""

    ranks: np.ndarray  # [dp, pp]
    dp_index: int
    stage: int
    pp_group: Any
    dp_group: Any

    @property
    def dp_size(self) -> int:
        return int(self.ranks.shape[0])

    @property
    def num_stages(self) -> int:
        return int(self.ranks.shape[1])

    @property
    def prev_rank(self) -> Optional[int]:
        return (None if self.stage == 0
                else int(self.ranks[self.dp_index, self.stage - 1]))

    @property
    def next_rank(self) -> Optional[int]:
        return (None if self.stage == self.num_stages - 1
                else int(self.ranks[self.dp_index, self.stage + 1]))

    @property
    def last_rank(self) -> int:
        """The last stage's rank of this rank's pipeline."""
        return int(self.ranks[self.dp_index, -1])


def pipe_mesh(pp: int, dp: Optional[int] = None) -> PipeMesh:
    """This rank's ``PipeMesh`` over the initialised world: ``dp`` pipelines
    of ``pp`` stages (``dp`` None: world / pp).  Outside a world only the
    one-stage, one-pipeline layout exists."""
    if not dist.is_initialized():
        if pp * (dp or 1) > 1:
            raise ValueError(
                f"mesh {dp or 1}x{pp} needs a torch.distributed world of "
                f"{pp * (dp or 1)} ranks (the training CLI's --pp / --dp)")
        return PipeMesh(np.zeros((1, 1), np.int64), 0, 0, None, None)
    world = dist.get_world_size()
    if dp is None:
        dp = world // pp
    if dp * pp != world:
        raise ValueError(f"mesh {dp}x{pp} needs {dp * pp} ranks, the world "
                         f"has {world}")
    key = ("pp", world, dp, pp)
    if key not in _GROUPS:
        ranks = np.arange(world, dtype=np.int64).reshape(dp, pp)
        rank = dist.get_rank()
        pp_group = _new_groups((ranks[d, :] for d in range(dp)), rank)
        dp_group = _new_groups((ranks[:, s] for s in range(pp)), rank)
        d, s = (int(i[0]) for i in np.nonzero(ranks == rank))
        _GROUPS[key] = PipeMesh(ranks, d, s, pp_group, dp_group)
    return _GROUPS[key]


def all_reduce_sum(tensors: Iterable[torch.Tensor], group=None,
                   scale: float = 1.0,
                   bucket_bytes: int = BUCKET_BYTES) -> List[torch.Tensor]:
    """Every tensor summed over ``group`` and multiplied by ``scale``, in
    flat buckets of one dtype and device (few collectives for many
    leaves); returns new tensors in the input order."""
    tensors = list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    buckets: Dict[Tuple, List[List[int]]] = {}
    for i, t in enumerate(tensors):
        lists = buckets.setdefault((t.dtype, t.device), [[]])
        size = sum(tensors[j].numel() for j in lists[-1]) * t.element_size()
        if lists[-1] and size + t.numel() * t.element_size() > bucket_bytes:
            lists.append([])
        lists[-1].append(i)
    for lists in buckets.values():
        for idx in lists:
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=group)
            if scale != 1.0:
                flat.mul_(scale)
            for i, part in zip(idx, flat.split([tensors[i].numel()
                                                for i in idx])):
                out[i] = part.view_as(tensors[i])
    return out  # type: ignore[return-value]


def replicate(tree, devices: Optional[Sequence[Any]] = None, *,
              group=None, src: int = 0):
    """Inference: ``{device: tree moved there}`` for each distinct device
    (replicas that share a device share one copy).  Training (no
    ``devices``): the tensors of ``tree`` (a module or a list) overwritten
    in place with those of rank ``src`` of ``group`` (default: rank 0 of
    the initialised world)."""
    if devices is not None:
        out = {}
        for dev in devices:
            dev = torch.device(dev)
            if dev not in out:
                out[dev] = {k: v.to(dev) for k, v in tree.items()}
        return out
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        tensors = (list(tree.state_dict().values())
                   if isinstance(tree, torch.nn.Module) else list(tree))
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=src, group=group)
    return tree
