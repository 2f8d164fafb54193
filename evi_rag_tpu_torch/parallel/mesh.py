"""The data-axis mesh and placement on it.

Counterpart of ``evi_rag_tpu/parallel/mesh.py``.  A ``Mesh`` is an ordered
list of ``torch.device``s along the one data axis.  An entry may repeat a
device, as a JAX mesh over virtual devices repeats one chip: the CPU tests
use ``["cpu"] * 8`` and one card can stand in for four with
``[cuda:0] * 4``; each entry then holds its own shard and the shards run one
after another.

* ``make_mesh`` -- every CUDA device by default (raises without one), or
  the ``devices`` named;
* ``shard_batch`` -- the leading axis of every tensor split into equal
  blocks, block i on entry i;
* ``per_device`` / ``place_replicated`` -- something made once per
  distinct device (a tree copied there), listed per entry: entries that
  repeat a device share it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, TypeVar

import torch

from evi_rag_tpu_torch.ops.graph import map_tensors

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices along the data axis."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d: Any) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {d!r} (use cuda or cpu devices)")
    return dev


def make_mesh(num_devices: int | None = None, *, devices: Sequence[Any] | None = None) -> Mesh:
    """1-D data-parallel mesh over the first ``num_devices`` of ``devices``
    (default: every CUDA device; without one this raises, and the CPU is
    used only where ``devices`` names it)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu', ...] to mesh the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(f"requested {num_devices} devices, have {len(devices)}")
        devices = devices[:num_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


def shard_batch(batch: Any, mesh: Mesh) -> list[Any]:
    """Split the leading axis of every tensor of ``batch`` (a tensor, or a
    dict / dataclass tree of them) into ``mesh.size`` equal blocks: block i
    on ``mesh.devices[i]`` (a view where it already lies there).  Raises
    unless every leading axis divides evenly."""
    n = mesh.size

    def block(i: int, dev: torch.device):
        def fn(t: torch.Tensor) -> torch.Tensor:
            if t.ndim == 0 or t.shape[0] % n:
                raise ValueError(f"leading axis of shape {tuple(t.shape)} does not divide over {n} devices")
            per = t.shape[0] // n
            return t[i * per:(i + 1) * per].to(dev)
        return fn

    return [map_tensors(batch, block(i, dev)) for i, dev in enumerate(mesh.devices)]


def per_device(mesh: Mesh, make: Callable[[torch.device], T]) -> list[T]:
    """``make(device)`` once per distinct device of the mesh, listed per
    entry (the entries that repeat a device share one result)."""
    made: dict[torch.device, T] = {}
    for dev in mesh.devices:
        if dev not in made:
            made[dev] = make(dev)
    return [made[dev] for dev in mesh.devices]


def place_replicated(tree: Any, mesh: Mesh) -> list[Any]:
    """``tree`` on each entry's device: one copy per distinct device, shared
    by the entries that repeat it."""
    return per_device(mesh, lambda dev: map_tensors(tree, lambda t: t.to(dev)))
