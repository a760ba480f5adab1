"""The rank mesh and its three collectives.

Counterpart of lidar_slam_tpu/parallel/mesh.py. The JAX package runs its
multi-device layer from one controller (shard_map with psum, pmax and
all_gather over a jax.sharding.Mesh); the port runs one process a rank
over torch.distributed (parallel/launch.run_ranks starts them), and every
sharded function is the program of one rank: it slices its shard, runs
the port's single-device function on it and combines through the three
collectives below. They are the only calls into torch.distributed in the
layer, so the backend is chosen and used in this one module:

  - psum is all_reduce(SUM), pmax is all_reduce(MAX);
  - all_gather is all_gather_into_tensor under NCCL; under gloo it is an
    all_reduce(SUM) of a zeroed buffer with one slot a rank, each rank
    writing its own slot. That is exact, as x + 0 = x (a -0.0 comes back
    +0.0), and is how gloo gathers here on every device.

The backend is NCCL when every rank has a card of its own, and gloo when
ranks share a card (NCCL refuses two ranks on one GPU) or run on the CPU
(pick_backend). Every rank's compute stays on its device either way: gloo
moves CUDA tensors through host buffers inside the collective.

Each Mesh counts its collectives: calls, bytes (the collective's result
buffer on this rank) and host seconds around each call. On a CUDA device
the layer synchronizes the device before and after each collective, so
the host clock reads the collective alone and not the work queued before
it.
"""

from __future__ import annotations

import math
import time
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def mesh_shape(n_devices: int, axes: Tuple[str, ...],
               shape: Tuple[int, ...] | None = None) -> Tuple[int, ...]:
    """The mesh's shape as the JAX package's make_mesh chooses it: one axis
    takes every rank; two axes split them as evenly as possible, the
    larger first (8 -> (4, 2), 4 -> (2, 2))."""
    if shape is not None:
        if math.prod(shape) != n_devices or len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} does not hold "
                             f"{n_devices} ranks on axes {axes}")
        return tuple(shape)
    if len(axes) == 1:
        return (n_devices,)
    if len(axes) == 2:
        a = int(math.isqrt(n_devices))
        while n_devices % a:
            a -= 1
        return (n_devices // a, a)
    raise ValueError("provide an explicit shape for >2 axes")


def pick_backend(world_size: int, device) -> str:
    """"nccl" where every rank has a card of its own, else "gloo"."""
    dev = torch.device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """Rank `rank`'s device: card rank mod the card count (so ranks share
    a card when there are fewer cards than ranks), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


class Mesh:
    """This rank's view of a named mesh: the torch DeviceMesh, the backend
    the process group runs, the rank's device, and the collectives'
    counters (calls, bytes, seconds; reset_counters() zeroes them)."""

    def __init__(self, device_mesh: DeviceMesh, backend: str,
                 device: torch.device):
        self.device_mesh = device_mesh
        self.backend = backend
        self.device = device
        self.axes = tuple(device_mesh.mesh_dim_names)
        self.shape = {a: int(device_mesh.size(i))
                      for i, a in enumerate(self.axes)}
        self.reset_counters()

    def reset_counters(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def _timed(self, fn, nbytes: int):
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize(self.device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += nbytes


def make_mesh(n_devices: int | None = None, axes: Tuple[str, ...] = ("dp",),
              shape: Tuple[int, ...] | None = None,
              device="cuda") -> Mesh:
    """This rank's Mesh over the initialized process group's ranks.

    n_devices must be the world size (None takes it). The device defaults
    to the card (this rank's, rank_device); pass device="cpu" for CPU
    ranks. Raises on NCCL with two ranks on one card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/launch.run_ranks starts one a rank)")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of "
                         f"{world}: the port's mesh spans the world")
    backend = dist.get_backend()
    dev = rank_device(device, dist.get_rank())
    if backend == "nccl" and pick_backend(world, dev) != "nccl":
        raise ValueError(f"NCCL needs a card a rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards")
    dims = mesh_shape(n_devices, tuple(axes), shape)
    dm = DeviceMesh(dev.type, torch.arange(n_devices).reshape(dims),
                    mesh_dim_names=tuple(axes))
    return Mesh(dm, backend, dev)


def shard_slice(n: int, mesh: Mesh, axis: str, what: str = "length"
                ) -> slice:
    """This rank's contiguous block of n items on `axis`; raises unless n
    is a multiple of the axis size."""
    d = mesh.size(axis)
    if n % d:
        raise ValueError(f"{what}: {n} is not divisible by the {d}-way "
                         f"'{axis}' axis (pad it first)")
    b = n // d
    r = mesh.index(axis)
    return slice(r * b, (r + 1) * b)


def batch_sharding(x: torch.Tensor, mesh: Mesh, axis: str = "dp",
                   dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of x along `dim` (a padded batch: its
    length a multiple of the axis size), on the rank's device."""
    sl = shard_slice(x.shape[dim], mesh, axis, f"dimension {dim}")
    return x.narrow(dim, sl.start, sl.stop - sl.start).to(mesh.device)


def replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole of x on this rank's device."""
    return x.to(mesh.device)


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of x over the ranks of `axis` (a new tensor)."""
    out = x.clone(memory_format=torch.contiguous_format)
    mesh._timed(lambda: dist.all_reduce(out, dist.ReduceOp.SUM,
                                        group=mesh.group(axis)),
                out.numel() * out.element_size())
    return out


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Elementwise max of x over the ranks of `axis` (a new tensor)."""
    out = x.clone(memory_format=torch.contiguous_format)
    mesh._timed(lambda: dist.all_reduce(out, dist.ReduceOp.MAX,
                                        group=mesh.group(axis)),
                out.numel() * out.element_size())
    return out


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(D, *x.shape): every rank's x on `axis`, in axis order."""
    d = mesh.size(axis)
    out = x.new_zeros((d,) + tuple(x.shape))
    nbytes = out.numel() * out.element_size()
    if mesh.backend == "nccl":
        src = x.contiguous()
        mesh._timed(lambda: dist.all_gather_into_tensor(
            out, src, group=mesh.group(axis)), nbytes)
    else:
        out[mesh.index(axis)] = x
        mesh._timed(lambda: dist.all_reduce(out, dist.ReduceOp.SUM,
                                            group=mesh.group(axis)), nbytes)
    return out
