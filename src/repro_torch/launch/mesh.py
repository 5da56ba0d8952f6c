"""Device meshes: named axes over an array of `torch.device`s.

A function per mesh (not a module-level constant), so importing this
module touches no device. The alignment engine shards a dispatch slice's
batch over the mesh's "pod" / "data" axes, one block per shard, with no
communication between shards (`core.engine.AlignmentEngine(mesh=...)`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """`devices` (an object array of `torch.device`, one axis per name)
    under the names `axis_names`."""
    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        devices = np.asarray(self.devices, dtype=object)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict:
        """Size of each axis, by name."""
        return dict(zip(self.axis_names, self.devices.shape))

    def shard_devices(self, axes) -> tuple:
        """The devices a batch sharded over `axes` runs on, in shard order
        (row-major over `axes`). Along every other axis the shards are
        replicas with identical work, so only index 0 of it is used."""
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown or not axes:
            raise ValueError(f"batch axes {tuple(axes)} not among the mesh "
                             f"axes {self.axis_names}")
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        grid = np.transpose(self.devices, order + rest)
        grid = grid[(Ellipsis,) + (0,) * len(rest)]
        return tuple(grid.reshape(-1))


def _devices(count: int, device) -> list:
    """`count` devices of the type of `device`: the first `count` visible
    cards, or the CPU repeated (a mesh of CPU shards exists for tests)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * count
    if kind != "cuda":
        raise ValueError(f"mesh devices must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < count:
        raise RuntimeError(
            f"a mesh of {count} CUDA devices was asked for but "
            f"{visible} are visible (torch.cuda.is_available() is "
            f"{torch.cuda.is_available()})")
    return [torch.device("cuda", i) for i in range(count)]


def make_debug_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                    *, device="cuda") -> DeviceMesh:
    """A small (data, model) or (pod, data, model) mesh over the first
    visible cards; raises when fewer are visible than it needs. With
    ``device="cpu"`` every entry is the CPU (tests)."""
    shape = (pod, data, model) if pod else (data, model)
    axes = ("pod", "data", "model") if pod else ("data", "model")
    if min(shape) < 1:
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    devs = _devices(int(np.prod(shape)), device)
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return DeviceMesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Every visible card on "data", "model" = 1. There is no multi-node
    path (ROADMAP A11d): ``multi_pod=True`` raises."""
    if multi_pod:
        raise NotImplementedError(
            "multi_pod meshes span several hosts; no multi-node path is "
            "ported (ROADMAP A11d)")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return make_debug_mesh(data=max(count, 1), model=1)
