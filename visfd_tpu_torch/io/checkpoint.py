"""Sharded phase checkpoints: every rank writes and reads its own blocks.

Port of ``visfd_tpu/io/checkpoint.py``.  The reference's only
checkpoint is ``-save-progress F`` / ``-load-progress F``: the six
tensor-voting channels as host ``F_tensor_{0..5}.rec`` files, which
funnel the whole volume through one host.  The JAX package adds an orbax
checkpoint whose arrays keep their mesh sharding; orbax is a JAX format,
so the port writes a directory of its own, from plain numpy, with the
same promises: each process writes only the blocks it holds, and a
restore reads, for each block of any target partition (any mesh shape,
any number of ranks, or none), only the saved blocks that meet it.

A checkpoint ``P`` is a directory:

* ``P/<name>.<iz>.<iy>.npy``: block (iz, iy) of array ``name``, an
  ``.npy`` file of (C..., z1 - z0, y1 - y0, X) (the leading channel axes
  and X whole);
* ``P/metadata.json``: ``{"format": FORMAT, "version": VERSION,
  "arrays": {name: {"shape", "dtype", "layout", "blocks": [{"file",
  "z": [z0, z1], "y": [y0, y1]}, ...]}}}``.

The arrays are channel-major, as the port holds them: ``filter_mrc``
saves ``vote`` (6, Z, Y, X) in the order of the ``.rec`` channels,
``saliency`` (Z, Y, X) and ``direction`` (3, Z, Y, X).  Unlike the JAX
CLI, which re-shards a process-local state onto its default mesh first,
a save keeps the run's own partition: a restore re-blocks anyway.

A save replaces ``P`` whole, as orbax's ``force=True``: rank 0 makes
``P.partial`` (removing a stale one), every rank writes its blocks into
it, and after a barrier rank 0 writes ``metadata.json`` last, removes
the old ``P`` (only a checkpoint of this format: anything else is
refused before a byte is written) and renames the directory to ``P``.  A
rank that fails raises at once and never reaches the barrier, so rank 0
publishes nothing; a reader never sees a half-written checkpoint (for a
moment between the removal and the rename it sees none; the files are
not synced to the disk: the promise covers a failed process, not a lost
host).  No volume crosses the process group: each block goes to its file
from one device-to-host copy of that block, and comes back through one
host buffer per target block and one host-to-device copy.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from visfd_tpu_torch.cli.settings import InputError
from visfd_tpu_torch.parallel import distributed as D
from visfd_tpu_torch.parallel.mesh import ShardedVolume, divides, from_blocks

FORMAT = "visfd_tpu_torch.checkpoint"
VERSION = 1
METADATA = "metadata.json"
LAYOUT = "channel-major (C..., Z, Y, X)"


def _blocks(a):
    """[(iz, iy, (z0, z1), (y0, y1), tensor or None)] of a tensor (one
    block) or a ShardedVolume (its partition; None where another rank
    holds the block)."""
    if not isinstance(a, ShardedVolume):
        z, y = a.shape[-3:-1]
        return [(0, 0, (0, z), (0, y), a)]
    if a.halo != (0, 0):
        raise ValueError("save_sharded: the volume still carries halos")
    bz, by = a.block_shape
    return [(iz, iy, (iz * bz, (iz + 1) * bz), (iy * by, (iy + 1) * by),
             a.blocks[iz][iy]) for iz, iy in a.mesh.all_cells()]


def _is_checkpoint(path: str) -> bool:
    try:
        with open(os.path.join(path, METADATA)) as fh:
            return json.load(fh).get("format") == FORMAT
    except (OSError, ValueError, AttributeError):
        return False


def save_sharded(path: str, tree: Dict[str, object]) -> int:
    """Save ``tree`` (names to tensors or ShardedVolumes, each (C..., Z,
    Y, X)) as the checkpoint directory ``path``, replacing one that is
    there.  Every rank of a cluster calls it with its own blocks; a
    ShardedVolume's blocks are written by the ranks that hold them, a
    whole tensor (which every rank holds) by rank 0 alone.  Returns the
    bytes this rank wrote.  Raises ``InputError`` where ``path`` is
    something other than a checkpoint of this format, and
    ``ValueError`` for a volume that still carries halos."""
    path = os.path.abspath(path)
    partial = path + ".partial"
    rank0 = D.process_index() == 0
    plans = {}
    for name, a in tree.items():
        if not re.fullmatch(r"[A-Za-z0-9_]+", name):
            raise ValueError(f"save_sharded: array name {name!r} is not "
                             f"a plain word")
        plans[name] = _blocks(a)
    if os.path.lexists(path) and not _is_checkpoint(path):
        raise InputError(f'Error: "{path}" exists and is not a '
                         f'{FORMAT} checkpoint; refusing to replace it')
    if rank0:
        if os.path.lexists(partial):
            shutil.rmtree(partial)
        os.makedirs(partial)
    D.barrier()
    arrays, written = {}, 0
    for name, plan in plans.items():
        a = tree[name]
        whole = not isinstance(a, ShardedVolume)
        arrays[name] = {"shape": list(a.shape), "dtype": str(
            (a if whole else a.local_block).dtype).replace("torch.", ""),
            "layout": LAYOUT, "blocks": []}
        for iz, iy, zr, yr, b in plan:
            fname = f"{name}.{iz}.{iy}.npy"
            arrays[name]["blocks"].append({"file": fname, "z": list(zr),
                                           "y": list(yr)})
            if b is not None and (rank0 or not whole):
                host = b.detach().cpu().numpy()   # one copy of the block
                with open(os.path.join(partial, fname), "wb") as fh:
                    np.lib.format.write_array(fh, host, allow_pickle=False)
                written += host.nbytes
    D.barrier()
    if rank0:
        with open(os.path.join(partial, METADATA), "w") as fh:
            json.dump({"format": FORMAT, "version": VERSION,
                       "arrays": arrays}, fh, indent=1)
        if os.path.lexists(path):     # a checkpoint: checked above
            shutil.rmtree(path)
        os.rename(partial, path)
    D.barrier()
    return written


def _read_metadata(path: str) -> dict:
    """The ``metadata.json`` of checkpoint ``path``; ``InputError`` for
    an unfinished save (``P.partial``), a directory that holds none, or
    another format."""
    path = os.path.abspath(path)
    if path.endswith(".partial"):
        raise InputError(f'Error: "{path}" is an unfinished save; load the '
                         f'checkpoint it was to replace')
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        hint = (f' ("{path}.partial" is an unfinished save)'
                if os.path.lexists(path + ".partial") else "")
        raise InputError(f'Error: "{path}" is not a checkpoint: no '
                         f'{METADATA}{hint}')
    with open(meta_path) as fh:
        meta = json.load(fh)
    if meta.get("format") != FORMAT or meta.get("version") != VERSION:
        raise InputError(f'Error: "{path}" is not a {FORMAT} checkpoint '
                         f'of version {VERSION}')
    return meta


def load_sharded(path: str, like=None, device=None,
                 names: Optional[Iterable[str]] = None,
                 zyx=None) -> Dict[str, object]:
    """Restore the arrays ``names`` (default: all) of the checkpoint at
    ``path`` onto the partition ``like``: a ``Mesh`` or a
    ``ShardedVolume`` (its mesh) gives ShardedVolumes with this rank's
    blocks, None whole tensors on ``device`` (default: the card).  Each
    target block reads only the saved blocks that meet it, from memory
    maps, into one host buffer, then one host-to-device copy.  ``zyx``
    (default: ``like``'s, for a ShardedVolume) is the (Z, Y, X) every
    array must end in; a mismatch raises ``InputError`` naming both."""
    meta = _read_metadata(path)
    path = os.path.abspath(path)
    mesh = like.mesh if isinstance(like, ShardedVolume) else like
    if zyx is None and isinstance(like, ShardedVolume):
        zyx = like.shape[-3:]
    out = {}
    for name in (meta["arrays"] if names is None else names):
        if name not in meta["arrays"]:
            raise InputError(f'Error: checkpoint "{path}" holds no array '
                             f'"{name}" (it holds '
                             f'{sorted(meta["arrays"])})')
        a = meta["arrays"][name]
        shape = tuple(a["shape"])
        if zyx is not None and shape[-3:] != tuple(zyx):
            raise InputError(
                f'Error: checkpoint "{path}": "{name}" is {shape[-3:]} (Z, '
                f'Y, X), the run\'s volume {tuple(zyx)}')
        z, y = shape[-3:-1]
        if mesh is None:
            dev = torch.device(device if device is not None else "cuda")
            out[name] = _read_box(path, a, (0, z), (0, y), dev)
            continue
        lead = len(shape) - 3
        if not divides(shape, mesh, lead):
            raise ValueError(f"load_sharded: {shape} is not divisible by "
                             f"the {mesh.shape} device grid")
        nz_m, ny_m = mesh.shape
        bz, by = z // nz_m, y // ny_m
        out[name] = from_blocks(
            [[_read_box(path, a, (iz * bz, (iz + 1) * bz),
                        (iy * by, (iy + 1) * by), mesh.devices[iz][iy])
              if mesh.is_local(iz, iy) else None for iy in range(ny_m)]
             for iz in range(nz_m)], mesh)
    return out


def _read_box(path, a, zr, yr, device) -> torch.Tensor:
    """Rows ``zr`` x ``yr`` of array ``a`` (its metadata) on
    ``device``."""
    shape = tuple(a["shape"])
    lead = shape[:-3]
    buf = np.empty(lead + (zr[1] - zr[0], yr[1] - yr[0], shape[-1]),
                   np.dtype(a["dtype"]))
    pre = (slice(None),) * len(lead)
    covered = 0
    for blk in a["blocks"]:
        (z0, z1), (y0, y1) = blk["z"], blk["y"]
        lo_z, hi_z = max(z0, zr[0]), min(z1, zr[1])
        lo_y, hi_y = max(y0, yr[0]), min(y1, yr[1])
        if lo_z >= hi_z or lo_y >= hi_y:
            continue
        src = np.load(os.path.join(path, blk["file"]), mmap_mode="r",
                      allow_pickle=False)
        if src.shape != lead + (z1 - z0, y1 - y0, shape[-1]):
            raise InputError(f'Error: checkpoint "{path}": {blk["file"]} '
                             f'is {src.shape}, its metadata says '
                             f'{lead + (z1 - z0, y1 - y0, shape[-1])}')
        buf[pre + (slice(lo_z - zr[0], hi_z - zr[0]),
                   slice(lo_y - yr[0], hi_y - yr[0]))] = \
            src[pre + (slice(lo_z - z0, hi_z - z0),
                       slice(lo_y - y0, hi_y - y0))]
        covered += (hi_z - lo_z) * (hi_y - lo_y)
    if covered != (zr[1] - zr[0]) * (yr[1] - yr[0]):
        raise InputError(f'Error: checkpoint "{path}": the blocks of '
                         f'"{a["blocks"][0]["file"].split(".")[0]}" do not '
                         f'tile rows {zr} x {yr} once')
    return torch.from_numpy(buf).to(device)
