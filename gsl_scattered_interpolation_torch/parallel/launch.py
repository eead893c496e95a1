"""Process groups and rank processes for the sharded paths.

JAX runs one controller over a mesh of devices; ``torch.distributed`` runs
one process per rank, each running the same program on its own block
(SPMD).  So the port needs what JAX does not: a way to join a process
group and to start the ranks.  Both go through a ``torch.distributed``
store, so no TCP port and no ``env://`` variables are involved.

* :func:`init_group` joins the default group of ``world_size`` ranks:
  NCCL for ``device="cuda"`` (one card per rank), gloo for
  ``device="cpu"``.  At world size 1 it needs no store from the caller.
* :func:`spawn` starts ``world_size`` ranks as fresh processes (the
  ``spawn`` start method: a forked child would inherit its parent's
  threads and imported modules), joins each to a group over a
  ``FileStore`` and returns what ``fn`` returned on each rank.

Every collective of the group times out after ``timeout`` seconds, and
:func:`spawn` kills its ranks when its own deadline passes, so a rank that
hangs fails its caller instead of holding it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..utils import errors

# Seconds a collective (and a whole spawned run) may take.
TIMEOUT_S = 300.0


def init_group(
    rank: int,
    world_size: int,
    store=None,
    timeout: float = TIMEOUT_S,
    device="cuda",
) -> None:
    """Join the default process group as ``rank`` of ``world_size``.

    NCCL on ``device="cuda"``, rank r driving card r, so the ranks may not
    outnumber the cards; gloo on the CPU.  A failed NCCL start raises.
    ``store`` is a ``torch.distributed`` store that every rank shares (a
    ``FileStore`` for ranks in several processes); at world size 1 a
    ``HashStore`` stands in when none is given.
    """
    device = torch.device(device)
    if store is None:
        if world_size != 1:
            raise errors.InvalidArgumentError(
                f"{world_size} ranks need a shared store"
            )
        store = dist.HashStore()
    kwargs = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is visible")
        if world_size > torch.cuda.device_count():
            raise errors.InvalidArgumentError(
                f"{world_size} NCCL ranks but {torch.cuda.device_count()} cards"
            )
        card = torch.device("cuda", rank)
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        store=store,
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout),
        **kwargs,
    )


def _rank_main(fn, rank, world_size, device, store_path, timeout, results, args):
    """One spawned rank: join the group, run ``fn(*args)``, report."""
    # The ranks share the machine's cores with each other and the parent.
    torch.set_num_threads(1)
    try:
        init_group(
            rank, world_size, store=dist.FileStore(store_path, world_size),
            timeout=timeout, device=device,
        )
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, device, *args, store_dir=None, timeout: float = TIMEOUT_S):
    """``[fn(*args) on rank 0, ..., on rank world_size - 1]``.

    Each rank is a fresh process that imports torch and ``fn``'s module,
    runs with one intra-op thread, and joins a group of ``world_size``
    ranks on ``device`` over a ``FileStore`` in ``store_dir`` (a temporary
    directory when None) before calling ``fn``.  ``fn`` and its arguments
    and results must pickle.  Raises if a rank raises or dies, and
    ``TimeoutError`` if the ranks have not all answered within
    ``timeout`` seconds; either way every rank still running is killed.
    """
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="gsi_group_", dir=store_dir) as tmp:
        store_path = os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(fn, rank, world_size, str(device), store_path, timeout,
                      results, args),
                daemon=True,
            )
            for rank in range(world_size)
        ]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size:
                try:
                    rank, ok, value = results.get(timeout=0.2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result"
                        ) from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world_size - len(out)} of {world_size} ranks "
                            f"gave no result within {timeout} s"
                        ) from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
        return [out[r] for r in range(world_size)]
