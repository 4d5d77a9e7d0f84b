"""Lane sharding over devices: a data-parallel split with zero collectives.

flo's lanes (a lossless (frame, channel), a lossy channel row, a file's
blocks) are independent, so scaling over devices needs no communication: a
chunk's batch axis is cut into equal contiguous shards, each shard is
uploaded to its own device and the same device functions run there (the hand
kernels launch on ``torch.cuda.current_stream`` of their tensors' device).
The host joins the shards in lane order; that gather is the only
synchronisation between devices.

The bulk pipelines take a mesh as ``mesh=`` or ambiently through
:func:`use_mesh`::

    with flo_torch.parallel.use_mesh(pipeline.device_mesh()):
        datas = lossless.encoder.encode_many(clips, 44100, 2)

Each chunk then pads its frame axis (lossless) or its lane axis (lossy) to a
mesh multiple with inert lanes (``nvalid = 0``, zero blocks) that are dropped
again on the host. A mesh overrides ``device=``. Lossless bytes equal the
unsharded path's; lossy decodes lie within 1.5 i16 steps of it (float32
FFT sums may take another order on another device).

flo_tpu's ``batch_sharding`` (a ``jax.sharding.NamedSharding`` of the
'batch' axis) has no twin: :class:`Mesh` is an ordered tuple of devices, and
:func:`split_batch` / :func:`put_batch` cut axis 0 into its shards. Shape
buckets (``use_shape_buckets``, ``shape_buckets_on``, ``bucket_count``)
stay behind: they bound the number of compiled TPU programs, and the port
compiles nothing per shape.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

# The search step with the reference's signature: the CUDA kernel on a CUDA
# tensor, the plain version on a CPU one. A sharded search runs it per shard.
from ..ops.select import encode_select_best as encode_select_step

__all__ = [
    "Mesh",
    "active_mesh",
    "decode_step",
    "device_mesh",
    "encode_select_step",
    "mesh_size",
    "pad_batch",
    "put_batch",
    "put_replicated",
    "shard_batch",
    "split_batch",
    "use_mesh",
]


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices, one shard each. A device may repeat (two
    shards on one card, or several on the CPU): every shard gets its own
    buffers all the same."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def device_mesh(devices=None, n: int | None = None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device of the host), cut
    to the first ``n``. Raises where there are fewer than ``n`` devices, or
    none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device_mesh: this host has no CUDA device")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n is not None:
        if len(devices) < n:
            raise RuntimeError(f"device_mesh: {n} devices asked for, {len(devices)} present")
        devices = devices[:n]
    return Mesh(tuple(devices))


#: Ambient mesh stack for the bulk pipelines (see use_mesh).
_MESH_STACK: list[Mesh] = []


@contextmanager
def use_mesh(mesh: Mesh):
    """Route every bulk pipeline dispatched inside the block over ``mesh``."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def active_mesh(mesh: Mesh | None = None) -> Mesh | None:
    """The effective mesh: the explicit argument, else the ambient one, else
    None (the unsharded path)."""
    if mesh is not None:
        return mesh
    return _MESH_STACK[-1] if _MESH_STACK else None


def mesh_size(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.size


def pad_batch(n: int, mesh: Mesh | None) -> int:
    """``n`` rounded up to a mesh multiple."""
    d = mesh_size(mesh)
    return -(-n // d) * d


def split_batch(x, mesh: Mesh, unit: int = 1) -> list:
    """Axis 0 of ``x`` (numpy) zero-padded to a multiple of ``mesh.size *
    unit`` rows and cut into ``mesh.size`` equal contiguous shards (views of
    the padded array). ``unit`` keeps a shard's rows whole groups: ``unit=C``
    cuts lanes on frame boundaries."""
    x = np.asarray(x)
    rows = pad_batch(-(-x.shape[0] // unit), mesh) * unit
    if rows != x.shape[0]:
        x = np.concatenate([x, np.zeros((rows - x.shape[0], *x.shape[1:]), x.dtype)])
    return np.split(x, mesh.size)


def put_batch(x, mesh: Mesh, unit: int = 1) -> list:
    """:func:`split_batch`, each shard copied to its own device (a fresh
    buffer even where the device repeats or is the CPU)."""
    return [
        torch.from_numpy(np.ascontiguousarray(s)).to(d, copy=True)
        for s, d in zip(split_batch(x, mesh, unit), mesh.devices)
    ]


def put_replicated(x, mesh: Mesh) -> list:
    """One copy of ``x`` on each device of the mesh."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return [t.to(d, copy=True) for d in mesh.devices]


def shard_batch(mesh: Mesh, *arrays, unit: int = 1) -> tuple:
    """:func:`put_batch` of each array: one list of shards per array."""
    return tuple(put_batch(a, mesh, unit) for a in arrays)


def decode_step(rows, coeffs, shifts, orders, is_fixed, mid_side, channels: int) -> list:
    """Sharded decode step: each argument a list of shards (lanes cut on
    frame boundaries, so a shard's ``mid_side`` is its own frames' flags);
    the reconstruction, mid/side undo and float32 scale run on each shard's
    device. Returns the shards' [F_i, S, C] float32 in lane order."""
    from ..lossless.decoder import _device_decode

    return [
        _device_decode(*shard, channels=channels)
        for shard in zip(rows, coeffs, shifts, orders, is_fixed, mid_side)
    ]
