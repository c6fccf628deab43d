"""A device mesh for one process (after ``stereo_reconstruction_cv_tpu/parallel/mesh.py``).

The reference's mesh has two axes:

  'data'  - batch parallelism over stereo pairs (no communication)
  'space' - image rows sharded across devices, with halo rows (or DP
            carries) handed between neighbouring shards

and one Python process drives every device of it (``shard_map`` inside one
``jit``). The port keeps that single controller: a ``Mesh`` is an
(n_data, n_space) grid of ``torch.device``s, a sharded tensor is a grid of
tensors placed on them (``Sharded``), and the collectives are tensor copies
between devices. A device may appear more than once, so a 1x4 or 2x2 mesh
runs on one card (``[torch.device("cuda:0")] * 4``) or on the CPU
(``[torch.device("cpu")] * 4``); on a machine with more cards each shard's
work goes to its own. A copy to the device a tensor is already on returns
that tensor, so a received block may alias its sender's: clone it before
writing into it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


class Mesh:
    """An (n_data, n_space) grid of devices; ``shape`` maps each axis name to
    its size, ``devices[i][j]`` is the device of data index i, row shard j."""

    def __init__(self, devices: Sequence[Sequence]):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices: List[List[torch.device]] = grid
        self.shape = {"data": len(grid), "space": len(grid[0])}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.devices]})"


def make_mesh(n_data: Optional[int] = None, n_space: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'space') mesh of the first n_data * n_space of `devices`,
    row-major. Defaults as the reference's: every visible CUDA device, all on
    'data'. With no `devices` and no CUDA device it raises: the mesh never
    falls back to the CPU on its own (pass ``[torch.device("cpu")] * n``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                               "(for example [torch.device('cpu')] * 4) to build a mesh "
                               "without one")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_space
    if n_data < 1 or n_space < 1 or n_data * n_space > len(devices):
        raise ValueError(f"need {n_data}x{n_space} devices, have {len(devices)}")
    return Mesh([devices[i * n_space:(i + 1) * n_space] for i in range(n_data)])


@dataclass(frozen=True)
class Sharding:
    """Which leading axes of a tensor a mesh splits: spec[0] names the mesh
    axis of the batch axis, spec[1] that of the row axis; a missing entry
    replicates over the mesh axis left unnamed."""
    mesh: Mesh
    spec: Tuple[str, ...]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis batch split over 'data' (rows whole on every shard)."""
    return Sharding(mesh, ("data",))


def batch_row_sharding(mesh: Mesh) -> Sharding:
    """(batch, rows, ...) tensors: batch over 'data', rows over 'space'."""
    return Sharding(mesh, ("data", "space"))


def replicated(mesh: Mesh) -> Sharding:
    """The whole tensor on every device of the mesh."""
    return Sharding(mesh, ())


class Sharded:
    """A tensor of `shape` split by `sharding`: ``blocks[i][j]`` is the part
    that mesh.devices[i][j] holds."""

    def __init__(self, sharding: Sharding, blocks: List[List[torch.Tensor]], shape):
        self.sharding = sharding
        self.blocks = blocks
        self.shape = tuple(shape)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def __repr__(self) -> str:
        return f"Sharded({self.shape}, spec={self.sharding.spec}, mesh={self.mesh.shape})"


def block_ranges(shape, sharding: Sharding):
    """(batch ranges by data index, row ranges by space index)."""
    nd, ns = sharding.mesh.shape["data"], sharding.mesh.shape["space"]
    spec = sharding.spec
    B = shape[0]
    H = shape[1] if len(shape) > 1 else 1
    if "data" in spec and B % nd:
        raise ValueError(f"batch {B} does not split over {nd} data shards")
    if "space" in spec and H % ns:
        raise ValueError(f"{H} rows do not split over {ns} space shards")
    b = B // nd if "data" in spec else B
    h = H // ns if "space" in spec else H
    return ([(i * b, (i + 1) * b) if "data" in spec else (0, B) for i in range(nd)],
            [(j * h, (j + 1) * h) if "space" in spec else (0, H) for j in range(ns)])


def place(x: torch.Tensor, sharding: Sharding) -> Sharded:
    """Copy `x` (B, H, ...) onto the mesh (the counterpart of
    ``jax.device_put(x, sharding)``); every block is a tensor of its own."""
    if sharding.spec not in ((), ("data",), ("data", "space")):
        raise ValueError(f"spec {sharding.spec}: one of (), ('data',), ('data', 'space')")
    brs, rrs = block_ranges(x.shape, sharding)
    blocks = [[x[b0:b1, r0:r1].to(dev, copy=True).contiguous()
               for (r0, r1), dev in zip(rrs, row)]
              for (b0, b1), row in zip(brs, sharding.mesh.devices)]
    return Sharded(sharding, blocks, x.shape)


def gather(xs: Sharded, device=None) -> torch.Tensor:
    """The whole tensor on `device` (default: the mesh's first device)."""
    dev = torch.device(device) if device is not None else xs.mesh.devices[0][0]
    spec = xs.sharding.spec
    rows = [torch.cat([blk.to(dev) for blk in row], 1) if "space" in spec else row[0].to(dev)
            for row in xs.blocks]
    return torch.cat(rows, 0) if "data" in spec else rows[0]


def from_prev(blocks: Sequence[torch.Tensor], n: int, dim: int = 0) -> List[Optional[torch.Tensor]]:
    """Along 'space' (one row of a mesh's blocks): shard j receives the last
    n entries along `dim` of shard j - 1, on its own device (``ppermute``
    i -> i + 1). The first shard, at the true image edge, receives None."""
    return [None] + [b.narrow(dim, b.shape[dim] - n, n).to(nxt.device, non_blocking=True)
                     for b, nxt in zip(blocks[:-1], blocks[1:])]


def from_next(blocks: Sequence[torch.Tensor], n: int, dim: int = 0) -> List[Optional[torch.Tensor]]:
    """Along 'space': shard j receives the first n entries along `dim` of
    shard j + 1 (``ppermute`` i + 1 -> i); the last shard receives None."""
    return [b.narrow(dim, 0, n).to(prv.device, non_blocking=True)
            for prv, b in zip(blocks[:-1], blocks[1:])] + [None]
