"""Fleet meshes — the counterpart of ``repro.launch.mesh``'s small-mesh
constructors.  Functions, not module constants: importing this module
touches no device.

The reference's production meshes (``make_production_mesh``,
``make_mesh_info``: 256 and 512 chips) serve its dry run and land with it
(ROADMAP.md, queue A item A5).
"""
from __future__ import annotations

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
