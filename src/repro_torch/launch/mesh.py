"""Meshes — the counterpart of ``repro.launch.mesh``.  Functions, not
module constants: importing this module touches no device.

The fleet meshes are built from the devices present (or one device split
into data slabs).  The production meshes are the reference's:

Single pod:  (data=16, model=16)          = 256 devices
Multi-pod:   (pod=2, data=16, model=16)   = 512 devices

By default their every entry is ``torch.device("meta")``: a planning mesh
for the dry run (``launch.dryrun``), which traces each cell on ``meta`` and
allocates nothing, as the reference plans on 512 forced host devices.
Given a real device type they take its first n visible devices, or raise.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.distributed.sharding import MeshInfo


def _visible(device) -> list:
    """Every visible device of ``device``'s type (the card by default)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


class Mesh(NamedTuple):
    """Devices laid out row-major over named axes."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False, device="meta") -> Mesh:
    """The reference's (16, 16) ``("data", "model")`` mesh, or (2, 16, 16)
    ``("pod", "data", "model")`` with ``multi_pod``.  On ``meta`` (the
    default) every entry is the meta device; given a real device type,
    the first n visible devices of it, or a RuntimeError naming the
    count."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    dev = torch.device(device)
    if dev.type == "meta":
        return Mesh((torch.device("meta"),) * n, axes, shape)
    devs = _visible(dev)
    if len(devs) < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}; have {len(devs)} "
            f"{dev.type} devices — plan on device='meta' (the dry run) or "
            f"build a host-sized mesh with make_fleet_mesh_info()")
    return Mesh(tuple(devs[:n]), axes, shape)


def make_mesh_info(*, multi_pod: bool = False, device="meta") -> MeshInfo:
    """The production mesh with its roles: data axes ``("data",)``, or
    ``("pod", "data")`` with ``multi_pod``; the model axis ``"model"``."""
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    dp = ("pod", "data") if multi_pod else ("data",)
    return MeshInfo(mesh.devices, mesh.axis_names, mesh.axis_sizes,
                    dp_axes=dp)


def make_fleet_mesh_info(n_data: int = None, device=None) -> MeshInfo:
    """A 1-D data mesh over the devices ACTUALLY present of ``device``'s
    type: ``torch.cuda.device_count()`` cards, or the one CPU.

    ``n_data`` defaults to every such device; a 1-device mesh is valid and
    the ``StreamEngine`` takes its single-device dispatch path for it."""
    avail = _visible(device)
    n = len(avail) if n_data is None else int(n_data)
    if n < 1:
        raise ValueError(f"n_data must be ≥ 1, got {n}")
    if n > len(avail):
        raise RuntimeError(
            f"n_data={n} exceeds the {len(avail)} visible devices — use "
            f"split_mesh_info(device, {n}) to split one device into {n} "
            f"data slabs")
    return MeshInfo(tuple(avail[:n]), ("data",), (n,), dp_axes=("data",))


def split_mesh_info(device, n_data: int) -> MeshInfo:
    """A 1-D data mesh of ``n_data`` slabs on ONE device (the card, or the
    CPU when named): every entry of the mesh is that device.  It stands for
    the reference's ``--xla_force_host_platform_device_count``, which splits
    the host CPU into ``n_data`` XLA devices, so the sharded dispatch runs
    on one card as it would over ``n_data``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = int(n_data)
    if n < 1:
        raise ValueError(f"n_data must be ≥ 1, got {n}")
    return MeshInfo((dev,) * n, ("data",), (n,), dp_axes=("data",))


def make_debug_mesh_info(n_data: int = 1, n_model: int = 1,
                         device=None) -> MeshInfo:
    """A ``(data, model)`` mesh over the visible devices of ``device``'s
    type."""
    avail = _visible(device)
    n = int(n_data) * int(n_model)
    if n < 1 or n > len(avail):
        raise RuntimeError(f"a ({n_data}, {n_model}) mesh needs {n} "
                           f"devices; {len(avail)} visible")
    return MeshInfo(tuple(avail[:n]), ("data", "model"),
                    (int(n_data), int(n_model)), dp_axes=("data",))
