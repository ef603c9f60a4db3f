"""Device grids and (z, y)-block-sharded volumes.

Port of ``visfd_tpu/parallel/mesh.py``.  The JAX package partitions a
(Z, Y, X) voxel grid over a named ("z", "y") ``jax.sharding.Mesh`` and
runs each stage under ``shard_map``; the port keeps the same partition
explicitly: a ``Mesh`` is a (nz_m, ny_m) grid of ``torch.device``s and a
``ShardedVolume`` holds one (Z/nz_m, Y/ny_m, X) block per grid cell, on
that cell's device.  X (the fastest axis) stays whole, so every stencil
along X is local; stencils across a z or y block boundary take halo
rows from the neighbouring blocks (``parallel.halo``).

A grid may name one device more than once: the CPU tests build an
8-block mesh on ``cpu`` and ``chip_smoke.py`` a (2, 2) mesh on one
card.  What a block holds does not depend on where it lives.

In a multi-process cluster (``parallel.distributed``) the grid is drawn
from every rank's devices, in rank order, and each cell belongs to the
rank of its device (``Mesh.ranks``).  A ``ShardedVolume`` holds the
blocks of its own rank and ``None`` for the others; ``cells``,
``with_blocks``, ``bmap``, ``shard``, ``place`` and ``scatter_flat``
touch the local blocks only, and ``gather_flat`` all-gathers what each
rank's blocks hold.  With one process every block is local.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.utils.transfer import to_device

AXIS_NAMES = ("z", "y")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (nz_m, ny_m) grid of torch devices with axis names ("z", "y").
    ``ranks`` gives each cell's owning process (None: all of them this
    one's), ``rank`` this process; a cell of another rank names that
    rank's device."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = AXIS_NAMES
    ranks: Optional[Tuple[Tuple[int, ...], ...]] = None
    rank: int = 0

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    def owner(self, iz: int, iy: int) -> int:
        return self.rank if self.ranks is None else self.ranks[iz][iy]

    def is_local(self, iz: int, iy: int) -> bool:
        return self.owner(iz, iy) == self.rank

    @property
    def spans_processes(self) -> bool:
        """True when another rank owns a cell: halos, gathers and
        reductions then cross ranks."""
        return self.ranks is not None and any(
            r != self.rank for row in self.ranks for r in row)

    def all_cells(self):
        """(iz, iy) of every cell, local or not, z-major: the one order
        in which every rank walks a cross-rank plan."""
        nz_m, ny_m = self.shape
        return [(iz, iy) for iz in range(nz_m) for iy in range(ny_m)]


def _grid_shape(n: int) -> Tuple[int, int]:
    """n = nz * ny with nz >= ny and ny as large as possible (the JAX
    package's near-square factorization: 4 -> (2, 2), 8 -> (4, 2))."""
    best = (n, 1)
    for ny in range(1, int(np.sqrt(n)) + 1):
        if n % ny == 0:
            best = (n // ny, ny)
    return best


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (z, y) mesh over ``devices`` (default: every visible CUDA card;
    in an NCCL cluster, the rank's card), of which the first
    ``n_devices`` are used, like the JAX package's ``devs[:n_devices]``.
    ``devices`` may repeat a device.  In a multi-process cluster
    ``devices`` are this rank's, and the grid is drawn from every
    rank's, all-gathered in rank order (as ``jax.devices()`` orders
    them): block (iz, iy) goes to global device ``iz * ny_m + iy``.
    Every rank must own a block, and under NCCL a rank drives one
    card."""
    if devices is None:
        if D.backend() == "nccl":
            devices = [D.comm_device()]
        elif not torch.cuda.is_available():
            raise RuntimeError("visfd_tpu_torch: no CUDA device is visible "
                               "to build a -mesh over")
        else:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    owners = [0] * len(devs)
    if D.backend() == "nccl" and len(set(devs)) > 1:
        raise ValueError(f"make_mesh: under NCCL a rank drives one card; "
                         f"got {[str(d) for d in devs]}")
    if D.backend() is not None:
        names = D.allgather_arrays(np.frombuffer(
            "\n".join(str(d) for d in devs).encode(), np.uint8))
        per_rank = [bytes(n).decode().split("\n") for n in names]
        devs = [torch.device(d) for names_r in per_rank for d in names_r]
        owners = [r for r, names_r in enumerate(per_rank) for _ in names_r]
    if n_devices is not None:
        devs, owners = devs[:n_devices], owners[:n_devices]
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    nz, ny = _grid_shape(len(devs))
    grid = tuple(tuple(devs[iz * ny:(iz + 1) * ny]) for iz in range(nz))
    if D.backend() is None:
        return Mesh(grid)
    idle = sorted(set(range(D.process_count())) - set(owners))
    if idle:
        raise ValueError(f"make_mesh: {len(devs)} devices leave process(es) "
                         f"{idle} of {D.process_count()} without a block; "
                         f"every process needs one")
    return Mesh(grid, ranks=tuple(tuple(owners[iz * ny:(iz + 1) * ny])
                                  for iz in range(nz)),
                rank=D.process_index())


@dataclasses.dataclass(frozen=True)
class ShardedVolume:
    """A volume of global ``shape`` (C..., Z, Y, X) split into (z, y)
    blocks: ``blocks[iz][iy]`` is (C..., Z/nz_m + 2 hz, Y/ny_m + 2 hy, X)
    on ``mesh.devices[iz][iy]``, where ``halo = (hz, hy)`` counts the
    neighbour rows a halo exchange added (0 for a plain partition), or
    None where another rank owns the cell.  The leading channel axes
    (``lead`` of them) are never split.  ``ghosts`` holds the rows of
    other ranks' blocks that ``parallel.halo.with_ghosts`` received:
    {(jz, jy): [(z0, z1, y0, y1, tensor)]}, block-local planes and
    rows."""

    blocks: Tuple[Tuple[Optional[torch.Tensor], ...], ...]
    mesh: Mesh
    shape: Tuple[int, ...]
    halo: Tuple[int, int] = (0, 0)
    ghosts: Optional[dict] = dataclasses.field(default=None, compare=False)

    @property
    def lead(self) -> int:
        return len(self.shape) - 3

    @property
    def block_shape(self) -> Tuple[int, int]:
        """(bz, by): the rows of the global volume each block owns."""
        nz_m, ny_m = self.mesh.shape
        z, y = self.shape[self.lead:self.lead + 2]
        return z // nz_m, y // ny_m

    @property
    def local_block(self) -> torch.Tensor:
        """The first block this process holds (for its device and
        dtype)."""
        return next(b for _, _, b in self.cells())

    def cells(self):
        """(iz, iy, block) for every block this process holds,
        z-major."""
        for iz, row in enumerate(self.blocks):
            for iy, b in enumerate(row):
                if b is not None:
                    yield iz, iy, b

    def with_blocks(self, fn: Callable[[int, int, torch.Tensor],
                                       torch.Tensor]) -> "ShardedVolume":
        """A volume of the same partition whose blocks are
        ``fn(iz, iy, block)`` (shapes then taken from the new blocks)."""
        return from_blocks([[None if b is None else fn(iz, iy, b)
                             for iy, b in enumerate(row)]
                            for iz, row in enumerate(self.blocks)],
                           self.mesh)


def from_blocks(blocks, mesh: Mesh) -> ShardedVolume:
    """A ShardedVolume from a [iz][iy] grid of un-haloed blocks (None
    where another rank owns the cell)."""
    b0 = next(b for row in blocks for b in row if b is not None)
    lead = b0.ndim - 3
    nz_m, ny_m = mesh.shape
    shape = (tuple(b0.shape[:lead]) + (b0.shape[lead] * nz_m,
                                       b0.shape[lead + 1] * ny_m)
             + tuple(b0.shape[lead + 2:]))
    return ShardedVolume(tuple(tuple(r) for r in blocks), mesh, shape)


def divides(shape, mesh: Mesh, lead: int = 0) -> bool:
    """True when the mesh splits the (Z, Y) axes of ``shape`` evenly."""
    nz_m, ny_m = mesh.shape
    return shape[lead] % nz_m == 0 and shape[lead + 1] % ny_m == 0


def shard(x, mesh: Mesh, lead: int = 0, report=None) -> ShardedVolume:
    """Split a (C..., Z, Y, X) numpy array or tensor into even (z, y)
    blocks, each a fresh float32 copy on its mesh device (the
    counterpart of ``device_put`` with ``grid_sharding``); a ``Report``
    counts each z slab's copy to the device.  Raises if the mesh does
    not divide Z and Y."""
    if not divides(x.shape, mesh, lead):
        raise ValueError(f"shard: {tuple(x.shape)} is not divisible by the "
                         f"{mesh.shape} device grid")
    nz_m, ny_m = mesh.shape
    bz, by = x.shape[lead] // nz_m, x.shape[lead + 1] // ny_m
    pre = (slice(None),) * lead
    blocks = []
    for iz, row in enumerate(mesh.devices):
        local = [iy for iy in range(ny_m) if mesh.is_local(iz, iy)]
        if not local:
            blocks.append([None] * ny_m)
            continue
        slab = x[pre + (slice(iz * bz, (iz + 1) * bz),)]
        if isinstance(slab, np.ndarray):
            # one host-to-device copy of the z slab, split into its y
            # blocks on the device
            slab = to_device(slab, row[local[0]], report)
        blocks.append([slab[pre + (slice(None),
                                   slice(iy * by, (iy + 1) * by))].to(
            dev, torch.float32, copy=True).contiguous()
            if iy in local else None for iy, dev in enumerate(row)])
    return from_blocks(blocks, mesh)


def as_blocks(t) -> ShardedVolume:
    """A ShardedVolume as it is, or a tensor as the one block of a 1 x 1
    grid on its own device (no copy): the stages that walk blocks run a
    whole volume this way."""
    if isinstance(t, ShardedVolume):
        return t
    return from_blocks([[t]], Mesh(((t.device,),)))


def unwrap(vol: ShardedVolume, like):
    """``vol`` back in the form of ``like``: the tensor of a 1 x 1 grid
    unless ``like`` is a ShardedVolume."""
    return vol if isinstance(like, ShardedVolume) else vol.blocks[0][0]


def place(arr: np.ndarray, like: ShardedVolume) -> ShardedVolume:
    """A host (Z, Y, X) array split into the blocks of ``like``'s
    partition, on their devices, keeping its dtype."""
    bz, by = like.block_shape
    return like.with_blocks(lambda iz, iy, b: to_device(
        arr[iz * bz:(iz + 1) * bz, iy * by:(iy + 1) * by], b.device))


def _block_of(vol: ShardedVolume, flat: np.ndarray):
    """(block row, block column, flat index inside the block) of global
    raster indices of a (Z, Y, X) volume."""
    _, ny, nx = vol.shape
    bz, by = vol.block_shape
    z, y, x = flat // (ny * nx), (flat // nx) % ny, flat % nx
    return z // bz, y // by, ((z % bz) * by + y % by) * nx + x


def gather_flat(vol: ShardedVolume, flat) -> np.ndarray:
    """The values of a (Z, Y, X) volume at global raster indices, as a
    host array: each block gathers its own on its device.  Over a mesh
    that spans ranks every rank calls it with the same indices, and the
    values of each rank's blocks are all-gathered: every index has one
    owner, so every rank returns the one-process array."""
    flat = np.asarray(flat, np.int64)
    bzi, byi, loc = _block_of(vol, flat)
    out = None
    for iz, iy, b in vol.cells():
        sel = (bzi == iz) & (byi == iy)
        vals = b.reshape(-1)[torch.as_tensor(loc[sel], device=b.device)]
        if out is None:
            out = np.zeros(len(flat), vals.cpu().numpy().dtype)
        out[sel] = vals.cpu().numpy()
    if vol.mesh.spans_processes:
        owner = np.asarray(vol.mesh.ranks)[bzi, byi]
        for r, v in enumerate(D.allgather_arrays(
                out[owner == vol.mesh.rank])):
            out[owner == r] = v
    return out


def scatter_flat(vol: ShardedVolume, flat, values) -> None:
    """Write ``values`` (one per index, or a scalar) at global raster
    indices of a (Z, Y, X) volume, in place."""
    flat = np.asarray(flat, np.int64)
    values = np.broadcast_to(np.asarray(values), flat.shape)
    bzi, byi, loc = _block_of(vol, flat)
    for iz, iy, b in vol.cells():
        sel = (bzi == iz) & (byi == iy)
        if sel.any():
            b.reshape(-1)[torch.as_tensor(loc[sel], device=b.device)] = \
                torch.as_tensor(values[sel], dtype=b.dtype, device=b.device)


def bmap(fn: Callable, *args):
    """``fn(*args)``, block by block when any argument is a
    ShardedVolume (all such arguments share one partition; other
    arguments pass through whole).  The elementwise steps of the CLI run
    through this, sharded or not."""
    vols = [a for a in args if isinstance(a, ShardedVolume)]
    if not vols:
        return fn(*args)
    v0 = vols[0]
    for v in vols:
        if (v.mesh != v0.mesh or v.halo != (0, 0)
                or v.block_shape != v0.block_shape):
            raise ValueError("bmap: volumes of different partitions")

    def cell(iz, iy, _):
        return fn(*[a.blocks[iz][iy] if isinstance(a, ShardedVolume) else a
                    for a in args])
    return v0.with_blocks(cell)
