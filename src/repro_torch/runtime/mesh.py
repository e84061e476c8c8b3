"""Meshes of ranks on ``torch.distributed``; the port of
``repro.runtime.mesh``.

A rank is one process driving one device.  A ``Mesh`` lays the ranks of
the process group out on a grid with named axes, wraps that grid as a
``torch.distributed.device_mesh.DeviceMesh``, and hands out one process
group per tuple of axis names (the ranks that differ only along those
axes, the tuple's axes flattened in mesh order):

    make_mesh({"data": 2, "model": 2})              # preferred form
    make_mesh((2, 2), ("data", "model"))            # legacy positional
    make_mesh({"data": 4}, backend="gloo")          # four ranks on one card
    make_local_mesh()                               # every rank

Every rank builds every group of a mesh once, in the same order, when
the mesh is made: ``new_group`` is collective, and a rank that skipped
one would hang the job.  So every rank of the process group makes every
mesh, in the same order.

``backend`` is the process groups' backend: unless given, that of the
default process group (the one ``init_process_group`` or
``runtime.cluster.init_cluster`` made), else ``"nccl"`` on CUDA and
``"gloo"`` on the CPU; nothing picks another one.  NCCL refuses two
ranks on one card, so several ranks that share one card use gloo
(which reduces CUDA tensors through the host).

Without a process group a process is one rank: a mesh of size 1 then
has no groups (``group`` returns None) and reduces nothing.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device

AxesSpec = Union[Dict[str, int], Sequence[int]]


def _normalize_axes(axes: AxesSpec, names: Optional[Sequence[str]]):
    if isinstance(axes, dict):
        return tuple(axes.values()), tuple(axes.keys())
    axes = tuple(axes)
    if names is not None:
        return axes, tuple(names)
    if axes and isinstance(axes[0], (tuple, list)):  # [("data", 2), ...]
        return tuple(int(s) for _, s in axes), tuple(a for a, _ in axes)
    raise TypeError(
        "make_mesh expects a {name: size} dict, (shape, names), or a "
        f"sequence of (name, size) pairs; got {axes!r}")


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world() -> Tuple[int, int]:
    """(this process's rank, the process group's size); (0, 1) without
    a process group."""
    dist = _dist()
    if dist is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` if given, else the card numbered
    rank modulo the visible cards (every rank on card 0 when there is
    one), and a missing card raises as every entry point does."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    rank, _ = world()
    return torch.device("cuda", rank % torch.cuda.device_count())


class Mesh:
    """Ranks on a grid with named axes.

    ``shape[a]`` is axis ``a``'s size, ``axis_names`` the axes in order,
    ``devices`` the grid of ranks (the reference's grid of devices),
    ``device`` this rank's torch device, ``coords[a]`` this rank's place
    along ``a``, ``device_mesh`` the ``DeviceMesh`` of the grid (None
    without a process group) and ``group(axes)`` the process group of
    this rank's ranks along ``axes``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 ranks: Sequence[int], *, backend: Optional[str] = None,
                 device=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.devices = np.asarray(list(ranks), dtype=np.int64).reshape(
            tuple(self.shape.values()))
        self.device = rank_device(device)
        dist = _dist()
        if backend is None and dist is not None:
            backend = str(dist.get_backend())
        self.backend = backend or ("nccl" if self.device.type == "cuda"
                                   else "gloo")
        self.rank, self.world_size = world()
        where = np.argwhere(self.devices == self.rank)
        self.coords = ({a: int(i) for a, i in zip(self.axis_names, where[0])}
                       if len(where) else None)
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        if dist is not None:
            from torch.distributed.device_mesh import DeviceMesh

            self.device_mesh = DeviceMesh(
                self.device.type, torch.as_tensor(self.devices),
                mesh_dim_names=self.axis_names, _init_backend=False)
            self._make_groups()

    def _make_groups(self) -> None:
        """One process group per non-empty tuple of axes, by size, then
        in mesh order: the same calls in the same order on every rank."""
        dist = _dist()
        n = len(self.axis_names)
        for k in range(1, n + 1):
            for dims in itertools.combinations(range(n), k):
                rest = [d for d in range(n) if d not in dims]
                # one group per place along the other axes: move those
                # axes first and flatten the chosen ones
                grid = np.transpose(self.devices, rest + list(dims))
                members = grid.reshape(-1, math.prod(
                    self.devices.shape[d] for d in dims)).tolist()
                mine, _ = dist.new_subgroups_by_enumeration(
                    members, backend=self.backend)
                self._groups[tuple(self.axis_names[d] for d in dims)] = mine

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise KeyError(f"axes {unknown} not in mesh {self.shape}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of this rank's ranks along ``axes`` (a name
        or a tuple, flattened in mesh order); None without a process
        group, where a mesh has one rank."""
        return self._groups.get(self._axes(axes))

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's place along ``axes`` flattened (row-major in mesh
        order): its block of a dimension sharded over them."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, backend={self.backend!r}, "
                f"device={self.device}, rank={self.rank})")


def make_mesh(axes: AxesSpec, names: Optional[Sequence[str]] = None, *,
              backend: Optional[str] = None, devices=None, device=None):
    """Build a ``Mesh`` over ranks 0..N-1 (or the ranks ``devices``
    lists), with a readable error when the process group is too small.
    Every rank of the process group calls it (it builds the groups)."""
    shape, axis_names = _normalize_axes(axes, names)
    needed = math.prod(shape)
    _, size = world()
    avail = size if devices is None else len(list(devices))
    if needed > avail:
        raise RuntimeError(
            f"mesh {dict(zip(axis_names, shape))} needs {needed} ranks "
            f"but only {avail} are in the process group; launch {needed} "
            f"processes, one a device (torchrun --nproc-per-node "
            f"{needed}, or REPRO_NUM_PROCESSES={needed} with "
            "runtime.cluster.init_cluster), each calling "
            f"torch.distributed.init_process_group(world_size={needed})")
    ranks = list(range(needed)) if devices is None \
        else list(devices)[:needed]
    return Mesh(shape, axis_names, ranks, backend=backend, device=device)


def _default_pod_count() -> int:
    """Pod axis = process granularity.  Single-process keeps the legacy
    2-pod production grid; in a cluster the pod axis matches the
    process count."""
    from . import cluster

    n = cluster.pod_count()
    return n if n > 1 else 2


def make_production_mesh(*, multi_pod: bool = False,
                         pods: Optional[int] = None,
                         grid: Tuple[int, int] = (16, 16),
                         backend: Optional[str] = None, device=None):
    """16x16 = 256 ranks a pod; ``multi_pod`` adds a leading pod axis
    (``pods`` of them, by default the cluster's process count).  ``grid``
    shrinks the per-pod grid for tests."""
    rows, cols = grid
    if multi_pod:
        if pods is None:
            pods = _default_pod_count()
        return make_mesh({"pod": int(pods), "data": rows, "model": cols},
                         backend=backend, device=device)
    return make_mesh({"data": rows, "model": cols}, backend=backend,
                     device=device)


def _near_square(n: int) -> Tuple[int, int]:
    rows = max(1, n // 2)
    while n % rows:
        rows -= 1
    return rows, n // rows


def make_cluster_mesh(axis_names: Tuple[str, ...] = ("pod", "data", "model"),
                      *, backend: Optional[str] = None, device=None):
    """Process-spanning mesh: the pod axis is the cluster's processes
    (``cluster.pod_count``), each pod's ranks a near-square (data,
    model) grid, ranks in order so that a pod's block is contiguous.  A
    single process gets a 1-pod mesh over the process group."""
    from . import cluster

    _, size = world()
    pods = max(1, cluster.pod_count())
    per_pod = size // pods
    if per_pod * pods != size:
        raise RuntimeError(
            f"{size} ranks do not divide into {pods} pods; "
            "heterogeneous pods are not supported")
    rows, cols = _near_square(per_pod)
    return make_mesh((pods, rows, cols), axis_names, backend=backend,
                     device=device)


def make_local_mesh(axis_names: Tuple[str, str] = ("data", "model"), *,
                    backend: Optional[str] = None, device=None):
    """Near-square 2-D mesh over every rank of the process group (one
    rank without a process group)."""
    _, size = world()
    return make_mesh(_near_square(size), axis_names, backend=backend,
                     device=device)
