"""Start the ranks of a mesh: one process a rank over torch.distributed.

The JAX package needs no launcher (one controller drives every device);
the port runs each rank as a process. run_ranks spawns them with
torch.multiprocessing, joins their process group over a FileStore in a
temporary directory (so no port is fixed), and returns rank 0's result.

Spawned children unpickle `fn` by its module's name, so rank functions live
in a module that imports torch and not JAX (a test file would drag JAX into
every rank). On the card the kernels' library is built once here, before
the spawn; the ranks only load it.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh as mesh_lib


def _record(tmp: str, exc: BaseException) -> None:
    """Pickle the first exception of the run (the first rank to get here;
    its peers then fail on the closed connections) for run_ranks."""
    try:
        blob = pickle.dumps(exc)
    except (pickle.PicklingError, TypeError, AttributeError):
        blob = pickle.dumps(RuntimeError(traceback.format_exc()))
    try:
        fd = os.open(os.path.join(tmp, "error.pkl"),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return
    with os.fdopen(fd, "wb") as f:
        f.write(blob)


def _rank_main(rank: int, fn, world_size: int, backend: str, device: str,
               tmp: str, args: tuple) -> None:
    try:
        dev = mesh_lib.rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // world_size))
        store = dist.FileStore(os.path.join(tmp, "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
    except BaseException as exc:
        _record(tmp, exc)
        raise
    try:
        out = fn(dev, *args)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.pt"))
    except BaseException as exc:
        _record(tmp, exc)  # before the connections close
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: str | None = None,
              device="cuda", *args):
    """Run fn(rank_device, *args) in world_size spawned ranks and return
    rank 0's result, its tensors on the CPU.

    backend None takes mesh.pick_backend(world_size, device). device
    defaults to the card (rank r on card r mod the card count); pass "cpu"
    for CPU ranks. The first exception any rank raised is raised here,
    chained to the failure torch.multiprocessing reports; the other ranks
    are stopped.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks(device='cuda'): CUDA is not "
                               "available (pass device='cpu')")
        from ..kernels import build
        build.build()
    if backend is None:
        backend = mesh_lib.pick_backend(world_size, dev)
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        try:
            mp.start_processes(_rank_main, nprocs=world_size,
                               args=(fn, world_size, backend, dev.type, tmp,
                                     args),
                               join=True, start_method="spawn")
        except mp.ProcessRaisedException as err:
            path = os.path.join(tmp, "error.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    raise pickle.load(f) from err
            raise
        return torch.load(os.path.join(tmp, "result.pt"), map_location="cpu",
                          weights_only=False)
