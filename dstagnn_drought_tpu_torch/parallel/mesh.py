"""Process meshes for the port's two parallel axes.

Counterpart of ``dstagnn_drought_tpu/parallel/mesh.py``. JAX runs one SPMD
program over a ``Mesh`` of devices; here one process is one rank, and rank
``d·G + g`` is the device at ``(d, g)`` of a (data D) × (graph G) mesh, the
order of JAX's ``np.asarray(devices).reshape(d, g)``:

  * ``'data'`` — batch parallelism. Ranks that share a graph coordinate g
    (a *graph column*) hold different rows of each batch; their gradients
    are summed in :attr:`Mesh.data_group`.
  * ``'graph'`` — node partitioning. Ranks that share a data coordinate d
    (a *data row*) hold the same batch rows; each owns a block of target
    nodes inside the partitioned spatial convs, and they exchange halos in
    :attr:`Mesh.graph_group`.

A world of one process (no process group) is the 1 × 1 mesh, and every
collective of :mod:`~dstagnn_drought_tpu_torch.parallel.comm` is then the
identity.

Backend rule (:func:`choose_backend`), fixed by the topology: NCCL when
every rank of the host has a card of its own; gloo on the CPU and when
ranks share a card (NCCL refuses two ranks on one device). A backend is
never switched after an error.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def choose_backend() -> tuple[str, str]:
    """(backend, reason) for this host's ranks: ``LOCAL_WORLD_SIZE`` ranks
    (``WORLD_SIZE`` without it) against ``torch.cuda.device_count()``."""
    if not torch.cuda.is_available():
        return "gloo", "no CUDA device"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    cards = torch.cuda.device_count()
    if cards >= local:
        return "nccl", f"{local} rank(s) on this host, {cards} card(s): one card a rank"
    return "gloo", f"{local} ranks share {cards} card(s)"


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """The device of this rank for an entry point's ``device`` (``None``
    means ``cuda``): with a process group, ``cuda:LOCAL_RANK % cards`` (a
    card a rank under NCCL; ranks that share a card under gloo); the CPU,
    a device with an index and a single process stay as they are."""
    dev = torch.device("cuda" if device is None else device)
    if (dev.type != "cuda" or dev.index is not None or not dist.is_initialized()
            or not torch.cuda.is_available()):
        return dev  # without a card resolve_device raises
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def maybe_initialize_distributed() -> bool:
    """Initialise the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), and only
    when that environment is present: a single-process run never pays the
    rendezvous (JAX: ``maybe_initialize_distributed`` and
    ``jax.distributed.initialize``). The backend is :func:`choose_backend`'s,
    printed once. Returns True when this call initialised the group."""
    if dist.is_initialized() or not all(os.environ.get(k) for k in _ENV):
        return False
    backend, reason = choose_backend()
    if backend == "nccl":
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://")
    if dist.get_rank() == 0:
        print(f"distributed: backend {backend} ({reason}), world size "
              f"{dist.get_world_size()}", flush=True)
    return True


def factor_devices(n: int, graph_axis: int | None = None) -> tuple[int, int]:
    """Choose (data, graph) axis sizes for n ranks: with no request, up to 4
    ways on 'graph', the rest on 'data' (JAX's rule)."""
    if graph_axis is not None:
        if n % graph_axis:
            raise ValueError(f"graph_axis={graph_axis} must divide device count {n}")
        return n // graph_axis, graph_axis
    g = 1
    for cand in (4, 2):
        if n % cand == 0 and n >= cand:
            g = cand
            break
    return n // g, g


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, graph) mesh: the axis sizes, its
    coordinates ``(d, g)`` and the groups of its graph column
    (``data_group``, the ranks that share g) and its data row
    (``graph_group``, the ranks that share d). A group of one rank is
    ``None``: nothing to exchange on that axis."""

    data: int
    graph: int
    d: int = 0
    g: int = 0
    data_group: object = None
    graph_group: object = None
    backend: str | None = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "graph": self.graph}

    @property
    def size(self) -> int:
        return self.data * self.graph


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(data_axis: int | None = None, graph_axis: int | None = None) -> Mesh:
    """The mesh of this rank over the world (1 without a process group).
    ``data_axis · graph_axis`` must equal the world size, else ValueError
    (JAX's check). Every rank must call it: the groups are made
    collectively, every graph column and then every data row, in order."""
    n = world_size()
    if data_axis is not None and graph_axis is not None:
        if data_axis * graph_axis != n:
            raise ValueError(
                f"data_axis*graph_axis = {data_axis * graph_axis} != {n} devices")
        d, g = data_axis, graph_axis
    else:
        d, g = factor_devices(n, graph_axis)
    if n == 1:
        return Mesh(1, 1)
    rank = dist.get_rank()
    columns = [dist.new_group([i * g + j for i in range(d)]) for j in range(g)]
    rows = [dist.new_group([i * g + j for j in range(g)]) for i in range(d)]
    di, gi = divmod(rank, g)
    return Mesh(d, g, di, gi,
                data_group=columns[gi] if d > 1 else None,
                graph_group=rows[di] if g > 1 else None,
                backend=dist.get_backend())
