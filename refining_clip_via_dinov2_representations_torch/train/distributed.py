"""The process group and host coordination of multi-GPU training.

The port of the JAX package's ``train/distributed.py`` on
``torch.distributed``. One process drives one GPU (torchrun's model): a
rank is a process; the ranks form the ``(data, model)`` mesh of
``parallel/mesh.py`` (``data_group``, ``model_group``).
The launcher's variables (torchrun, SLURM, OMPI), read in the JAX
package's order, give the rank, the local rank and the world size.

``init_distributed_device(args)`` joins the group when the world size is
above 1 (or when ``--dist-url`` names an init method): ``--dist-backend``,
else NCCL on CUDA and gloo on the CPU; ``--dist-url``, else ``env://``
(``MASTER_ADDR``/``MASTER_PORT``). A rank's device is ``cuda:LOCAL_RANK``
(``--device cuda`` too) unless ``--no-set-device-rank`` keeps the current
card, or ``--device`` names one; the CPU only under ``--force-cpu``. A
failed join raises: nothing falls back to one process.
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, Tuple

import torch
import torch.distributed as dist

_LOCAL_RANK_VARS = ("LOCAL_RANK", "MPI_LOCALRANKID", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")
_RANK_VARS = ("RANK", "PMI_RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
_WORLD_VARS = ("WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")


def _first(names, default: int) -> int:
    for v in names:
        if v in os.environ:
            return int(os.environ[v])
    return default


def world_info_from_env() -> Tuple[int, int, int]:
    """(local_rank, global_rank, world_size) from the launcher's variables."""
    return _first(_LOCAL_RANK_VARS, 0), _first(_RANK_VARS, 0), _first(_WORLD_VARS, 1)


def is_using_distributed() -> bool:
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"]) > 1
    if "SLURM_NTASKS" in os.environ:
        return int(os.environ["SLURM_NTASKS"]) > 1
    return False


def init_distributed_device(args) -> torch.device:
    """Joins the process group where the launch asks for one and fills
    ``args.{rank, local_rank, world_size, distributed, device}``. Returns
    the device. A launch with ``WORLD_SIZE=1`` and a ``MASTER_ADDR`` (or a
    ``--dist-url``) also joins: a group of one rank."""
    local_rank, rank, world_size = world_info_from_env()
    dist_url = getattr(args, "dist_url", None)
    join = is_using_distributed() or dist_url is not None or (
        "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ)
    if getattr(args, "device", None):
        device = torch.device(args.device)
    elif getattr(args, "force_cpu", False):
        device = torch.device("cpu")
    else:
        device = torch.device("cuda")
    if device.type == "cuda" and join:
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device()
                                  if getattr(args, "no_set_device_rank", False) else local_rank)
        torch.cuda.set_device(device)
    if join and not dist.is_initialized():
        backend = getattr(args, "dist_backend", None) or (
            "nccl" if device.type == "cuda" else "gloo")
        # NCCL binds the group to this rank's card (no guess from the rank)
        bind = {"device_id": device} if backend == "nccl" and device.index is not None else {}
        dist.init_process_group(backend=backend, init_method=dist_url or "env://",
                                world_size=world_size, rank=rank, **bind)
        logging.info("joined the process group: rank %d of %d (%s, %s)", rank, world_size,
                     backend, device)
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    args.rank, args.local_rank, args.world_size = rank, local_rank, world_size
    args.distributed = dist.is_initialized()
    args.device = str(device)
    return device


def is_master(args, local: bool = False) -> bool:
    if local:
        return getattr(args, "local_rank", 0) == 0
    return getattr(args, "rank", 0) == 0


def broadcast_object(args, obj: Any, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank; the identity in one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(args, obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order; ``[obj]`` in one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def data_group():
    """The data axis's process group (``parallel/mesh.py:create_mesh``; every
    rank before a mesh is built), or None in one process or where the axis
    holds one rank. The batch, the gathered losses, the gradient mean and
    the evaluations' shares run over it."""
    from ..parallel.mesh import DATA_AXIS, axis_group

    return axis_group(DATA_AXIS)


def model_group():
    """The model axis's process group (the ranks that hold parts of one
    model, ``parallel/tensor.py``), or None where it holds one rank."""
    from ..parallel.mesh import MODEL_AXIS, axis_group

    return axis_group(MODEL_AXIS)


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether ``flag`` is set on some rank, over every rank of both axes (a
    collective where there is a group), so that every rank stops at the
    same step."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
