"""Device meshes over ``torch.distributed`` — port of
``repro/launch/mesh.py``.

Every function here builds its mesh when called, never at import.  A mesh
of N cards needs N processes with the default process group initialised
(``torch.distributed.init_process_group`` with ``tcp://localhost:<port>``,
the world size and the rank: nothing on the card's machine announces a
cluster); a one-card mesh initialises a single-process group itself.
Sharded execution waits for a machine with more than one visible card
(``ROADMAP.md``); the dry-run reads the sharding plan off a mesh's axis
sizes alone (``launch/sharding.py``).
"""
from __future__ import annotations

import math
import socket


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group (``init_device_mesh``); with no group and one device, a
    single-process group on ``localhost`` (NCCL on the card, gloo on the
    CPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(
                f"a {tuple(shape)} mesh needs {math.prod(shape)} processes: start them "
                "and call torch.distributed.init_process_group in each first")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_card_mesh(device_type: str = "cuda"):
    """1×1 mesh on the one local card — the counterpart of the reference's
    ``make_smoke_mesh`` (the sharding rules' code paths without a
    cluster)."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of any object with a
    ``shape`` dict (the reference's mock meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def data_axes(mesh) -> tuple:
    """Mesh axes used for batch/data parallelism (pod folds into data)."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))
