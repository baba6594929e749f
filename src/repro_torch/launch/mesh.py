"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

Functions, not module constants: importing this module starts no process
group.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
dimensions carry the JAX package's axis names: ``pod`` and ``data`` (data
parallel, outer to inner), ``model`` (tensor parallel), ``pipe``
(pipeline stages, on pipeline meshes only).  One process per device.

``init_process_group(device)`` starts the group: NCCL on the card, gloo
only where the caller asks for the CPU; the rendezvous comes from the
``torchrun`` environment (``python -m torch.distributed.run``), else from
the ``init_method`` the caller passes (``file://...`` or
``tcp://localhost:<port>``), else, for a world of one, from a file store of
its own.  Without CUDA and without an explicit CPU request it raises, as
``launch.serve.resolve_device`` does; it never swaps NCCL for gloo.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.serve import resolve_device

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def init_process_group(device=None, init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None) -> torch.device:
    """Start the default process group (if none is running) and return
    this rank's device: ``cuda:<LOCAL_RANK>`` on the card (NCCL), the CPU
    when ``device="cpu"`` (gloo)."""
    dev = resolve_device(device)
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(dev.type)
    if backend is None:
        raise ValueError(f"no process-group backend for device {dev}")
    if dev.type == "cuda":
        local = (int(os.environ.get("LOCAL_RANK", 0)) if _torchrun_env()
                 else (rank or 0) % torch.cuda.device_count())
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if _torchrun_env():
        dist.init_process_group(backend, init_method="env://")
    elif init_method is not None:
        if world_size is None or rank is None:
            raise ValueError("an init_method needs world_size and rank")
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    elif (world_size or 1) == 1:
        fd, path = tempfile.mkstemp(prefix="repro_torch_pg_")
        os.close(fd)
        os.unlink(path)
        dist.init_process_group(backend, init_method=f"file://{path}",
                                world_size=1, rank=0)
    else:
        raise ValueError(f"a world of {world_size} needs the torchrun "
                         "environment or an init_method")
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type=None):
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over the
    running process group (its world must be the product of ``shape``).
    ``device_type``: default the card, ``"cpu"`` on request."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise ValueError(f"a mesh of {shape} needs a world of {n} "
                         f"processes, have {world}")
    dev_type = resolve_device(device_type).type
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh: 16 x 16 single-pod (256
    devices) or 2 x 16 x 16 multi-pod (512)."""
    return PRODUCTION_SHAPES[bool(multi_pod)]


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The production mesh; the world must hold 256 (or, multi-pod, 512)
    processes."""
    shape, axes = production_shape(multi_pod)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{n} devices, have {world}")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(tp: int = 1, device_type=None):
    """(data, model) mesh over every process of the world, ``model`` =
    min(tp, world) (CPU tests, elastic restarts)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    tp = min(tp, n)
    return make_mesh((n // tp, tp), ("data", "model"), device_type)
