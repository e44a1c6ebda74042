"""The multi-device runtime's rank grid.

Port of the meshes of movi_tpu/parallel/mesh.py:34 (`make_mesh`, one
'data' axis) and sharded_index.py:31 (`make_2d_mesh`, 'data' x 'model').
A `jax.sharding.Mesh` is one controller over several devices; PyTorch's
idiom is one process per device under `torch.distributed`, so here every
rank holds a `Mesh`: its (data, model) coordinates on a grid of
rank = d * model + m, one process group per axis, and its device.

The backend follows the device the caller names (NCCL for CUDA, gloo for
the CPU) unless `backend=` names one: two ranks that share a card need
gloo, since NCCL refuses two ranks on one device.  Nothing here falls
back to another backend or device.  A one-rank mesh needs no process
group: without `torch.distributed` initialised, `make_mesh(1)` is that
mesh, and its collectives are the identity.

`make_2d_mesh` also gathers every rank's host name once and records
whether this rank's 'model' group lies on one host: there the sharded
scans read their peers' shards where they lie (parallel/sharded_index.py)
instead of exchanging rows every step.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def backend_for(device: torch.device, backend: Optional[str] = None) -> str:
    """The collective backend of `device`: NCCL for CUDA, gloo for the
    CPU, or the one named."""
    return backend or ("nccl" if device.type == "cuda" else "gloo")


def init_process_group(init_method: str, world_size: int, rank: int,
                       device: DeviceLike = None,
                       backend: Optional[str] = None):
    """torch.distributed.init_process_group with the backend of `device`
    (or the one named), e.g. init_method="tcp://localhost:29500"."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev, backend),
                            init_method=init_method, world_size=world_size,
                            rank=rank)


@dataclass
class Mesh:
    data: int                   # axis sizes
    model: int
    d: int                      # this rank's coordinates
    m: int
    device: torch.device
    backend: Optional[str]      # None for the one-rank mesh
    data_group: object = None   # the ranks of this rank's 'data' column
    model_group: object = None  # the ranks of this rank's 'model' row
    model_on_one_host: bool = True  # every rank of the 'model' row
    # the sharded record tables made on this mesh (sharded_index.py)
    tables: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    def lane_slice(self, lanes: int) -> slice:
        """This rank's lanes of a batch of `lanes`: the JAX rule that
        lanes divide by the 'data' axis is kept."""
        if lanes % self.data:
            raise ValueError(f"{lanes} lanes do not divide over the "
                             f"{self.data}-way 'data' axis; pad the batch")
        per = lanes // self.data
        return slice(self.d * per, (self.d + 1) * per)

    def _host_side(self, t: torch.Tensor) -> bool:
        # gloo reduces on the host: its CUDA paths copy there anyway
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_reduce_model(self, t: torch.Tensor):
        """Sum t over the 'model' axis, in place (the psum of
        sharded_index.py)."""
        if self.model_group is None:
            return
        if self._host_side(t):
            h = t.cpu()
            dist.all_reduce(h, group=self.model_group)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=self.model_group)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole batch from every rank's lane shard: an all_gather
        over the 'data' axis, concatenated along `dim`."""
        if self.data_group is None:
            return t
        src = t.cpu() if self._host_side(t) else t
        if src.dtype == torch.bool:   # not every backend gathers bool
            src = src.to(torch.uint8)
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.data)]
        dist.all_gather(parts, src, group=self.data_group)
        return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)


def host_name() -> str:
    """This process's host name, as the mesh compares it."""
    return socket.gethostname()


def make_2d_mesh(data: int, model: int, device: DeviceLike = None,
                 backend: Optional[str] = None) -> Mesh:
    """The (data, model) grid over the ranks of the initialised default
    process group (world size data * model; every rank calls this, in
    the same order).  The axis groups take `backend`, or the one of
    `device`; every rank's host name is gathered once over the default
    group."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be positive, got ({data}, "
                         f"{model})")
    dev = resolve_device(device)
    if not dist.is_initialized():
        if data * model != 1:
            raise RuntimeError(f"a {data} x {model} mesh needs "
                               f"torch.distributed initialised with "
                               f"{data * model} ranks")
        return Mesh(1, 1, 0, 0, dev, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks, the process group has {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    be = backend_for(dev, backend)
    d, m = divmod(rank, model)
    data_group = model_group = None
    # every rank creates every group, in the same order
    for mm in range(model):
        g = dist.new_group([dd * model + mm for dd in range(data)],
                           backend=be)
        if mm == m:
            data_group = g
    for dd in range(data):
        g = dist.new_group([dd * model + mm for mm in range(model)],
                           backend=be)
        if dd == d:
            model_group = g
    hosts = [None] * world
    dist.all_gather_object(hosts, host_name())
    one_host = len(set(hosts[d * model:(d + 1) * model])) == 1
    return Mesh(data, model, d, m, dev, be, data_group, model_group,
                one_host)


def make_mesh(n_devices: Optional[int] = None, device: DeviceLike = None,
              backend: Optional[str] = None) -> Mesh:
    """The one-axis 'data' mesh over n_devices ranks (default: the world
    size, or one rank without torch.distributed)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return make_2d_mesh(n_devices, 1, device, backend)
