"""Multi-process runs on ``torch.distributed``.

Port of ``visfd_tpu/parallel/distributed.py``.  In the JAX package every
process joins one ``jax.distributed`` runtime, its meshes span every
process's devices, and the halos and reductions of ``shard_map`` cross
processes for free.  Here the (z, y) blocks of a ``parallel.mesh``
grid are owned by the processes ("ranks") whose devices hold them, and
what crosses ranks goes through the three helpers of this module:

* ``barrier``: every rank waits for the others (the sharded checkpoint's
  phases, ``io.checkpoint``);
* ``allreduce_sum``: host counts and flags (int64, float64), summed;
* ``allgather_arrays``: variable-length host arrays, in rank order;
* ``exchange``: point-to-point sends and receives of tensors (the halo
  rows of ``parallel.halo.with_ghosts``, the blocks that
  ``parallel.gather.to_host_np`` collects).

What a multi-process launch needs:

1. every process runs the same command, with ``VISFD_COORDINATOR``
   (``host:port`` of process 0, used as ``tcp://host:port``),
   ``VISFD_NUM_PROCESSES`` and ``VISFD_PROCESS_ID`` set, e.g. two
   processes::

       VISFD_COORDINATOR=10.0.0.1:8476 VISFD_NUM_PROCESSES=2 \\
       VISFD_PROCESS_ID=0 python -m visfd_tpu_torch.cli.filter_mrc \\
           -mesh -1 -in big.rec -out out.rec ...      # and ..._ID=1

2. ``init_distributed`` runs before the mesh is built (``filter_mrc``
   calls it when ``-mesh`` is given);
3. ``parallel.mesh.make_mesh`` then all-gathers every rank's devices.

The backend is NCCL when the ranks drive cards and gloo on the CPU.
NCCL refuses two ranks on one card, so it takes one card a rank; gloo
serves any layout, card tensors included: ``_through_host`` copies each
one to the host and back, the only place where that happens.
"""

from __future__ import annotations

import os
import socket
import time
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from visfd_tpu_torch.cli.settings import InputError

_ENV = ("VISFD_COORDINATOR", "VISFD_NUM_PROCESSES", "VISFD_PROCESS_ID")

# the process group's backend and, under NCCL, the rank's card
_backend: Optional[str] = None
_card: Optional[torch.device] = None

# seconds, calls and bytes of ``exchange`` by kind ("halo", "gather"),
# since the last ``reset_traffic``
traffic: dict = {}


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    **kw,
) -> bool:
    """Join the multi-process cluster (idempotent).

    The arguments default to ``VISFD_COORDINATOR``,
    ``VISFD_NUM_PROCESSES`` and ``VISFD_PROCESS_ID``; with none of them
    set it stays one process and returns False.  ``torch.distributed``
    cannot detect a cluster's size and rank, so a coordinator without
    the other two (or the other way round) raises ``InputError`` naming
    what is missing.  ``backend`` defaults to "nccl" where a card is
    visible and "gloo" elsewhere; under NCCL ``device`` is this rank's
    card (default ``cuda:<process id modulo the visible cards>``),
    made current before the group starts and passed as its
    ``device_id``, so the group's NCCL communicator is set up as the
    ranks join (the point-to-point transfers of ``exchange`` still set
    up theirs at their first use).  ``kw`` goes to
    ``init_process_group`` (e.g. ``timeout=timedelta(seconds=60)``).
    Returns True once the rank belongs to a process group."""
    global _backend, _card
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(_ENV[0])
    if num_processes is None and _ENV[1] in os.environ:
        num_processes = int(os.environ[_ENV[1]])
    if process_id is None and _ENV[2] in os.environ:
        process_id = int(os.environ[_ENV[2]])
    values = (coordinator_address, num_processes, process_id)
    if all(v is None for v in values[:2]):
        return False
    missing = [n for n, v in zip(_ENV, values) if v is None]
    if missing:
        given = [n for n, v in zip(_ENV, values) if v is not None]
        raise InputError(
            f"Error: {' and '.join(given)} set without "
            f"{' and '.join(missing)}: a multi-process cluster needs all "
            f"three (torch.distributed cannot detect a cluster's size and "
            f"rank)")
    if not 0 <= process_id < num_processes:
        raise InputError(f"Error: {_ENV[2]}={process_id} is not below "
                         f"{_ENV[1]}={num_processes}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    card = None
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a visible card; "
                               "backend='gloo' runs on the host")
        card = torch.device(device if device is not None else
                            f"cuda:{process_id % torch.cuda.device_count()}")
        torch.cuda.set_device(card)
    kw.setdefault("timeout", timedelta(minutes=10))
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout=kw["timeout"])
    if card is not None:
        if num_processes > 1:
            _check_cards(store, card, process_id, num_processes)
        kw.setdefault("device_id", card)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, **kw)
    _backend, _card = backend, card
    return True


def _check_cards(store, card, rank: int, n: int) -> None:
    """Before NCCL starts: every rank's (host, card UUID), exchanged
    through the rendezvous store; two ranks on one card raise on every
    rank (NCCL itself would fail inside its set-up).  Rank 0 serves the
    store, so it returns only once every rank has read."""
    me = (f"{socket.gethostname()}\n"
          f"{torch.cuda.get_device_properties(card).uuid}")
    store.set(f"visfd_card_{rank}", me)
    seen = [tuple(store.get(f"visfd_card_{r}").decode().split("\n"))
            for r in range(n)]
    store.set(f"visfd_card_read_{rank}", "1")
    if rank == 0:
        store.wait([f"visfd_card_read_{r}" for r in range(n)])
    for r, key in enumerate(seen):
        first = seen.index(key)
        if first != r:
            raise RuntimeError(
                f"NCCL refuses two ranks on one card (Duplicate GPU "
                f"detected): ranks {first} and {r} share card {key[1]} on "
                f"{key[0]}; backend='gloo' serves that layout")


def shutdown_distributed() -> None:
    """Leave the cluster (a test or teardown helper)."""
    global _backend, _card
    if dist.is_initialized():
        dist.destroy_process_group()
    _backend, _card = None, None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> Optional[str]:
    """"nccl", "gloo", or None outside a cluster."""
    return _backend


def comm_device() -> torch.device:
    """Where the collectives' tensors live: the rank's card under NCCL,
    the host otherwise."""
    return _card if _backend == "nccl" else torch.device("cpu")


def barrier() -> None:
    """Wait until every rank has called it (nothing outside a cluster);
    under NCCL on the rank's card.  It records no traffic."""
    if not dist.is_initialized():
        return
    if _backend == "nccl":
        dist.barrier(device_ids=[_card.index])
    else:
        dist.barrier()


def allreduce_sum(values) -> np.ndarray:
    """The element-wise sum over the ranks of an int64 or float64 host
    array (the array itself outside a cluster).  Every rank calls it."""
    a = np.asarray(values)
    if a.dtype not in (np.int64, np.float64):
        raise TypeError(f"allreduce_sum takes int64 or float64, not "
                        f"{a.dtype}")
    if not dist.is_initialized():
        return a.copy()
    t = torch.as_tensor(np.ascontiguousarray(a)).to(comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def allgather_arrays(a) -> List[np.ndarray]:
    """Every rank's host array, in rank order; the arrays may differ in
    shape but not in dtype.  Every rank calls it."""
    a = np.ascontiguousarray(a)
    if not dist.is_initialized():
        return [a]
    if a.ndim > 7:
        raise ValueError("allgather_arrays takes at most 7 axes")
    head = np.zeros(8, np.int64)
    head[0] = a.ndim
    head[1:1 + a.ndim] = a.shape
    heads = _allgather_tensor(torch.as_tensor(head)).numpy()
    sizes = [int(np.prod(h[1:1 + h[0]])) * a.itemsize for h in heads]
    buf = torch.zeros(max(1, max(sizes)), dtype=torch.uint8)
    raw = torch.from_numpy(a.reshape(-1).view(np.uint8))
    buf[:raw.numel()] = raw
    rows = _allgather_tensor(buf).numpy()
    return [rows[r, :n].copy().view(a.dtype).reshape(tuple(h[1:1 + h[0]]))
            for r, (h, n) in enumerate(zip(heads, sizes))]


def allgather_concat(a) -> np.ndarray:
    """``allgather_arrays`` joined along the first axis."""
    return np.concatenate(allgather_arrays(a))


def _allgather_tensor(t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape) of the ranks' equal-shaped host tensors."""
    t = t.to(comm_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu()


def reset_traffic() -> None:
    traffic.clear()


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]],
             kind: str = "halo") -> None:
    """Send each ``(tensor, peer)`` of ``sends`` and fill each
    ``(buffer, peer)`` of ``recvs`` (contiguous, of the sender's shape
    and dtype) from its peer.  The caller builds both lists from one
    plan that every rank walks in the same order, so the k-th message a
    rank sends to a peer is the k-th that peer expects from it; all are
    posted at once (``batch_isend_irecv`` under NCCL, ``isend``/
    ``irecv`` under gloo) and waited for, so none can deadlock.  Adds
    the call's wall seconds and bytes to ``traffic[kind]``: under NCCL,
    whose ``wait()`` only orders the rank's stream after the transfer,
    the card is synchronised before the clock starts and after the
    waits, so the seconds are the transfer's and not the work queued
    before it; gloo's ``wait()`` returns when the transfer is done."""
    if not sends and not recvs:
        return
    if _backend == "nccl":
        torch.cuda.synchronize(_card)
    t0 = time.perf_counter()
    if not all(t.is_contiguous() for t, _ in recvs):
        raise ValueError("exchange receives into contiguous buffers only")
    sends = [(_wire(t), p) for t, p in sends]
    recvs = [(_wire(t), p) for t, p in recvs]
    if _backend == "nccl":
        ops = ([dist.P2POp(dist.isend, t, p) for t, p in sends]
               + [dist.P2POp(dist.irecv, t, p) for t, p in recvs])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        torch.cuda.synchronize(_card)
    else:
        _through_host(sends, recvs)
    rec = traffic.setdefault(kind, {"calls": 0, "seconds": 0.0,
                                    "bytes_sent": 0, "bytes_received": 0})
    rec["calls"] += 1
    rec["seconds"] += time.perf_counter() - t0
    rec["bytes_sent"] += sum(t.numel() * t.element_size() for t, _ in sends)
    rec["bytes_received"] += sum(t.numel() * t.element_size()
                                 for t, _ in recvs)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor the backends carry (bool travels as uint8,
    sharing the buffer)."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _through_host(sends, recvs) -> None:
    """The gloo transport: gloo moves host memory only, so a card tensor
    is sent from a host copy and received into one, then copied back to
    the card."""
    works, back, held = [], [], []
    for t, p in sends:
        held.append(t.cpu() if t.is_cuda else t)
        works.append(dist.isend(held[-1], p))
    for t, p in recvs:
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype)
            back.append((t, host))
            t = host
        works.append(dist.irecv(t, p))
    for w in works:
        w.wait()    # ``held`` keeps the sent host copies alive till here
    for t, host in back:
        t.copy_(host)
