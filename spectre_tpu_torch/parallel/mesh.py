"""Device meshes for the mesh prove path (the port of
`spectre_tpu/parallel/mesh.py`).

A mesh is a ("data", "win") grid of torch devices held by one controller,
the process that runs the prover: "data" shards MSM points, NTT rows and
the quotient's extended columns, "win" shards Pippenger windows. There is
no process group; each shard's work is launched on its device from this
process, and a device may appear more than once in the grid (four shards
of one card are the counterpart of the reference's virtual host devices).

`SPECTRE_MESH_SHAPE` overrides the default grid: "4x2" -> data=4, win=2; a
bare "8" means data=8, win=1. A shape over a subset of the devices takes
the first D*W of them. A shape that needs more devices than exist, or that
is not a positive DxW grid, raises `MeshShapeError` instead of collapsing
to one device.
"""

from __future__ import annotations

import os

import torch

DATA_AXIS = "data"
WIN_AXIS = "win"


class MeshShapeError(ValueError):
    """Requested mesh shape cannot be built from the available devices."""


class Mesh:
    """A grid of torch devices over named axes: ("data", "win") by default,
    `devices[d][w]` shard (d, w); ("batch",) for the flat mesh of the
    batched MSM, `devices[i][0]` shard i. Devices may repeat."""

    def __init__(self, grid, axis_names=(DATA_AXIS, WIN_AXIS)):
        self.devices = tuple(tuple(torch.device(x) for x in row) for row in grid)
        if not self.devices or not self.devices[0] or \
                len({len(row) for row in self.devices}) != 1:
            raise MeshShapeError("a mesh is a non-empty rectangular device grid")
        self.axis_names = tuple(axis_names)
        dims = (len(self.devices), len(self.devices[0]))
        if len(self.axis_names) == 1 and dims[1] != 1:
            raise MeshShapeError("a one-axis mesh has one device a row")
        self.shape = dict(zip(self.axis_names, dims))

    @property
    def flat(self) -> tuple:
        return tuple(d for row in self.devices for d in row)

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.flat]})"


def local_devices(kind: str | None = None) -> list:
    """Every device of one kind this process can reach: the CUDA cards when
    `kind` is "cuda" (or None and a card is present), else the CPU."""
    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _parse_shape(spec: str) -> tuple[int, int]:
    parts = spec.lower().replace("×", "x").split("x")
    try:
        dims = [int(p) for p in parts if p != ""]
    except ValueError:
        dims = []
    if len(dims) == 1:
        dims.append(1)
    if len(dims) != 2 or dims[0] < 1 or dims[1] < 1:
        raise MeshShapeError(
            f"SPECTRE_MESH_SHAPE={spec!r}: expected 'DATAxWIN' with positive "
            f"integers (e.g. '4x2', '8', '2x1')")
    return dims[0], dims[1]


def make_mesh(n_devices: int | None = None, data_axis: int | None = None,
              devices: list | None = None) -> Mesh:
    """A mesh over `devices` (default: `local_devices()`), the first
    n_devices of them when given. The data axis defaults to n // 2 when
    n >= 4, else n."""
    devs = list(devices) if devices is not None else local_devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise MeshShapeError(
                f"make_mesh: {n_devices} devices requested but only {len(devs)} "
                f"available; a collapsed mesh would validate nothing")
        devs = devs[:n_devices]
    n = len(devs)
    if data_axis is None:
        data_axis = n // 2 if n >= 4 else n
    if data_axis < 1 or n % data_axis != 0:
        raise MeshShapeError(f"make_mesh: data axis {data_axis} does not divide {n} devices")
    w = n // data_axis
    return Mesh([devs[d * w:(d + 1) * w] for d in range(data_axis)])


def default_mesh(devices: list | None = None) -> Mesh:
    """The mesh over `devices` (default: `local_devices()`), honouring
    SPECTRE_MESH_SHAPE: the requested DxW grid is carved from the first D*W
    devices; needing more than exist is a MeshShapeError."""
    devs = list(devices) if devices is not None else local_devices()
    spec = os.environ.get("SPECTRE_MESH_SHAPE", "").strip()
    if not spec:
        return make_mesh(devices=devs)
    d, w = _parse_shape(spec)
    if d * w > len(devs):
        raise MeshShapeError(
            f"SPECTRE_MESH_SHAPE={spec!r} needs {d * w} devices but only "
            f"{len(devs)} are available")
    return make_mesh(n_devices=d * w, data_axis=d, devices=devs)
