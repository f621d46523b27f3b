"""Device meshes and placements.

Port of sqlite_vector_tpu/parallel/mesh.py. A mesh is a grid of torch
devices with axis names, driven by ONE process: shard i of a row-sharded
matrix lives on the mesh's i-th device (row-major over the grid), the
sharded scans launch on every shard's device back to back, and the
candidate merge gathers onto the first device (parallel/ops.py). This is
how FAISS shards an index over GPUs (IndexShards), and it keeps the JAX
package's single-controller API: one Dataset, one connection, one server.

A device may repeat: one card then holds several shards (the tests put 8
shards on "cpu", as the JAX tests put 8 virtual devices on one host).

The placements (row_sharding, block_sharding_2d, ...) are what
Dataset(sharding=) accepts: a row sharding lays a dataset out as its mesh
does, a block sharding as its 2-D mesh does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

ROWS_AXIS = "rows"
DIM_AXIS = "dim"


def _device(d: Any) -> torch.device:
    """A torch.device with an explicit index for CUDA ("cuda" -> cuda:0)."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"mesh: unsupported device '{dev}': expected 'cuda' or 'cpu'")
    return dev


class Mesh:
    """A grid of torch devices with one name per axis. `devices` is an
    object array of that grid's shape; `shape` maps each axis name to its
    extent, as jax.sharding.Mesh.shape does."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = _device(given[pos])
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or grid.ndim not in (1, 2):
            raise ValueError(
                f"mesh: a {grid.ndim}-D device grid needs {grid.ndim} axis names, "
                f"got {axis_names} (meshes are 1-D or 2-D)"
            )
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh: axis names must differ, got {axis_names}")
        if grid.size == 0:
            raise ValueError("mesh: no devices")
        self.devices = grid
        self.axis_names = axis_names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def grid(self) -> list[list[torch.device]]:
        """The devices as rows x columns: a 1-D mesh's one column, a 2-D
        mesh's grid (rows over the first axis)."""
        return [list(r) for r in self.devices.reshape(self.devices.shape[0], -1)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def _grid(devices: list, shape: tuple) -> np.ndarray:
    """The devices, row-major, as an object array of `shape`."""
    grid = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        grid[i] = _device(d)
    return grid.reshape(shape)


def _all_cuda_devices() -> list[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    n_devices: int | None = None,
    devices: Sequence[Any] | None = None,
    axis_name: str = ROWS_AXIS,
) -> Mesh:
    """A 1-D mesh over `devices` (default: every CUDA device; it raises
    where there is none and never falls back to the CPU). `n_devices`
    (without `devices`) must not exceed the CUDA device count."""
    if devices is None:
        devices = _all_cuda_devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"make_mesh: requested {n_devices} devices but only "
                    f"{len(devices)} are available"
                )
            devices = devices[:n_devices]
    devices = list(devices)
    if not devices:
        raise ValueError("make_mesh: no devices available")
    return Mesh(_grid(devices, (len(devices),)), (axis_name,))


def make_mesh_2d(
    rows: int,
    dims: int,
    devices: Sequence[Any] | None = None,
    axis_names: tuple[str, str] = (ROWS_AXIS, DIM_AXIS),
) -> Mesh:
    """A 2-D (rows x dim) mesh for very wide rows: the (r, c) device holds
    the [N/rows, d/dims] block; scans sum the partial components over the
    dim axis and merge candidates over the rows axis (default devices:
    every CUDA device)."""
    if devices is None:
        devices = _all_cuda_devices()
    devices = list(devices)[: rows * dims]
    if len(devices) < rows * dims:
        raise ValueError(f"make_mesh_2d: need {rows * dims} devices, have {len(devices)}")
    return Mesh(_grid(devices, (rows, dims)), axis_names)


@dataclasses.dataclass(frozen=True)
class Placement:
    """How an array lies on a mesh: `spec` names, per array axis, the mesh
    axis it is split over (None: whole on every device of that axis), as a
    jax PartitionSpec does."""

    mesh: Mesh
    spec: tuple


def row_sharding(mesh: Mesh, axis_name: str = ROWS_AXIS) -> Placement:
    """Rows split over `axis_name`; everything else whole."""
    return Placement(mesh, (axis_name,))


def replicated_sharding(mesh: Mesh) -> Placement:
    """Whole on every device (queries, scalars)."""
    return Placement(mesh, ())


def block_sharding_2d(mesh: Mesh) -> Placement:
    """Rows over the first mesh axis, features over the second."""
    names = mesh.axis_names
    return Placement(mesh, (names[0], names[1]))


def dim_sharding_2d(mesh: Mesh) -> Placement:
    """Queries on a 2-D mesh: whole over rows, split over features."""
    return Placement(mesh, (None, mesh.axis_names[1]))
