"""Meshes for the port (port of ``repro/launch/mesh.py``: the production
mesh, ``parse_mesh_arg`` and ``make_host_mesh``; and the pipeline's stage
mesh).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dim names
("data", "model") over the ranks of one ``torch.distributed`` job:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.serve --arch granite-8b --reduced --mesh 1x4

``init_mesh`` reads the ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE`` that ``torch.distributed.run`` sets and picks the
backend by a stated rule (``mesh_backend``), never by trying one and
falling back: ``nccl`` on ``cuda:LOCAL_RANK`` when every rank has a card of
its own (a node's ranks no more than its cards), ``gloo`` when
ranks share a card or run on the CPU (gloo stages CUDA tensors through
the host for its collectives). ``make_host_mesh`` builds the mesh of a
job whose gloo group is already initialized, on the CPU (tests).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

MESH_DIMS = ("data", "model")


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """A mesh of ``shape`` cards over ``axis_names``, described rather than
    joined (see ``make_production_mesh``)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def extents(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def join(self, rank: int = 0):
        """This process as ``rank`` of the mesh's world through a fake
        process group (``torch.testing._internal.distributed.fake_pg``:
        every collective returns at once and moves nothing), and the
        DeviceMesh over it: what a dry run on ``meta`` tensors needs of
        the mesh without ``size`` processes. A fake group joined before
        is left first; a real one raises, and is left as it is."""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if dist.is_initialized():
            if dist.get_backend() != "fake":
                raise RuntimeError(
                    f"a {dist.get_backend()} process group is initialized: the "
                    f"dry run joins a fake group of {self.size} ranks of its "
                    f"own, so run it outside a distributed job")
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=self.size)
        return init_device_mesh("cpu", self.shape, mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """(16, 16) data x model; (2, 16, 16) pod x data x model across two
    pods: the reference's extents, so cells compare one to one. On nodes of
    8 H100s joined by NVLink, with ranks row-major over the axes (model
    innermost, a node 8 consecutive ranks), a model group of 16 is two
    nodes and a data or pod group spans 16 or 2 nodes: every axis crosses
    nodes, so its collectives run at the network rate between nodes
    (``roofline.hw.LINK_BW``); 32 nodes for one pod, 64 for two."""
    if multi_pod:
        return ProductionMesh((2, 16, 16), ("pod", "data", "model"))
    return ProductionMesh((16, 16), ("data", "model"))


def parse_mesh_arg(spec: str, world_size: Optional[int] = None
                   ) -> Optional[Tuple[int, int]]:
    """CLI '--mesh DPxTP' (e.g. '1x4') -> (dp, tp); None for 1x1. The job
    must have dp * tp ranks (``world_size``, default the ``WORLD_SIZE``
    that ``torch.distributed.run`` sets, 1 outside it)."""
    try:
        dp, tp = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DPxTP (e.g. 1x4), got {spec!r}")
    if dp < 1 or tp < 1:
        raise SystemExit(f"--mesh dims must be >= 1, got {spec!r}")
    if dp * tp == 1:
        return None
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if dp * tp != world_size:
        raise SystemExit(
            f"--mesh {spec} needs {dp * tp} devices, have {world_size} ranks "
            f"(run it under python -m torch.distributed.run --nproc-per-node "
            f"{dp * tp})")
    return dp, tp


def mesh_backend(local_ranks: int, device_type: str, n_cards: int
                 ) -> Tuple[str, str]:
    """(backend, why): ``nccl`` when the ranks run on CUDA and each has a
    card of its own, that is the ranks of a node (``local_ranks``, the
    ``LOCAL_WORLD_SIZE`` of ``torch.distributed.run``) are no more than its
    cards (``n_cards``); else ``gloo``."""
    if device_type == "cuda" and local_ranks <= n_cards:
        return "nccl", (f"{local_ranks} ranks on this node's {n_cards} "
                        f"cards: one card per rank")
    if device_type == "cuda":
        return "gloo", (f"{local_ranks} ranks share this node's {n_cards} card"
                        f"{'s' if n_cards != 1 else ''}: NCCL takes one card "
                        f"per rank")
    return "gloo", f"{local_ranks} ranks on the CPU"


def rank_device(device_type: str, local_rank: int, n_cards: int) -> torch.device:
    """The device a rank runs on: ``cuda:LOCAL_RANK`` (ranks that share
    cards take them in turn), or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank % n_cards)
    return torch.device("cpu")


def make_host_mesh(data: int = 2, model: int = 4):
    """The ("data", "model") mesh of an initialized job of data * model
    ranks, for tensors on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (data, model), mesh_dim_names=MESH_DIMS)


def make_stage_mesh(n_stages: int, device_type: str = "cpu"):
    """The 1-D ("stage",) mesh of a GPipe job of ``n_stages`` ranks
    (``distributed.pipeline``), on ``device_type``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n_stages,), mesh_dim_names=("stage",))


def init_mesh(dp: int, tp: int, device: DeviceLike = None):
    """Join the job that ``torch.distributed.run`` started (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT``) with
    the backend of ``mesh_backend`` and build its (dp, tp) mesh. Returns
    (mesh, this rank's device, backend, why)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != dp * tp:
        raise SystemExit(f"--mesh {dp}x{tp} needs {dp * tp} devices, have "
                         f"{world} ranks")
    kind = resolve_device(device).type
    n_cards = torch.cuda.device_count() if kind == "cuda" else 0
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend, why = mesh_backend(local, kind, n_cards)
    dev = rank_device(kind, int(os.environ.get("LOCAL_RANK", "0")), n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(dev.type, (dp, tp), mesh_dim_names=MESH_DIMS)
    return mesh, dev, backend, why
