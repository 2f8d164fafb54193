"""Multi-process glue: process-group start-up, record gather, rank-0 guards
and the gradient all-reduce of data-parallel training.

Counterpart of ``evi_rag_tpu/parallel/multihost.py``, on
``torch.distributed``:

* ``initialize_distributed`` -- ``init_process_group`` from the same
  ``EVI_COORDINATOR_ADDRESS`` / ``EVI_NUM_PROCESSES`` / ``EVI_PROCESS_ID``
  variables, or with ``EVI_DISTRIBUTED=1`` from ``env://`` as ``torchrun``
  sets it; a no-op without them;
* ``gather_records`` -- every process contributes JSON-able records and
  every process receives the merge (``all_gather_object``), last wins;
* ``is_main_process`` / ``main_process_only`` -- the rank-0 write guard;
* ``owned_shards`` / ``all_reduce_mean`` -- which shards of a stacked batch
  a rank computes, and the mean of its results over the ranks.

On a single process everything reduces to the identity.
"""

from __future__ import annotations

import datetime
import functools
import logging
import os
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from evi_rag_tpu_torch.utils.logging import is_main_process, process_index

log = logging.getLogger(__name__)

__all__ = [
    "all_reduce_mean", "choose_backend", "gather_records", "initialize_distributed", "is_main_process",
    "main_process_only", "owned_shards", "process_index", "world_size",
]


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def choose_backend(local_processes: int) -> str:
    """``gloo`` on the CPU; on the card ``nccl`` when every local rank has a
    card of its own, else ``gloo`` (NCCL refuses two ranks on one device)."""
    if not torch.cuda.is_available():
        return "gloo"
    return "nccl" if local_processes <= torch.cuda.device_count() else "gloo"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout_s: float | None = None,
) -> str | None:
    """Start the default process group; returns its backend, or None on a
    single-process run (no coordinator and no ``EVI_DISTRIBUTED``).

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` come from the arguments or ``EVI_COORDINATOR_ADDRESS`` /
    ``EVI_NUM_PROCESSES`` / ``EVI_PROCESS_ID``.  Without a coordinator,
    ``EVI_DISTRIBUTED=1`` reads ``torchrun``'s ``env://`` variables (launch
    as ``EVI_DISTRIBUTED=1 torchrun --nproc-per-node N ...``).  The local rank is ``LOCAL_RANK`` (else the process id): on the card each
    process first makes card ``local rank % cards`` its current device.
    Idempotent.  Errors propagate: a misconfigured launch fails, it does not
    drop to one process.
    """
    if dist.is_initialized():
        return dist.get_backend()
    coordinator_address = coordinator_address or os.environ.get("EVI_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("EVI_NUM_PROCESSES"):
        num_processes = int(os.environ["EVI_NUM_PROCESSES"])
    if process_id is None and os.environ.get("EVI_PROCESS_ID"):
        process_id = int(os.environ["EVI_PROCESS_ID"])
    auto_detect = os.environ.get("EVI_DISTRIBUTED", "") not in ("", "0")
    if coordinator_address is None and not auto_detect:
        return None  # single-process run: nothing to coordinate
    if coordinator_address is None:
        init_method = "env://"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("EVI_COORDINATOR_ADDRESS needs EVI_NUM_PROCESSES and EVI_PROCESS_ID")
        init_method = f"tcp://{coordinator_address}"
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    local_processes = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    backend = backend or choose_backend(local_processes)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id,
                            **kwargs)
    log.info("process group: backend %s, rank %d of %d, local rank %d of %d", backend, process_id,
             num_processes, local_rank, local_processes)
    return backend


def main_process_only(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any):
        if is_main_process():
            return fn(*args, **kwargs)
        return None

    return wrapped


def gather_records(
    records: Sequence[dict[str, Any]],
    *,
    dedup_key: Callable[[dict], Any] | None = None,
) -> list[dict[str, Any]]:
    """All-processes record merge, the same on every process: the records
    of rank 0, then rank 1, ..., deduplicated by ``dedup_key`` (last wins)."""
    merged = list(records)
    if world_size() > 1:
        parts: list[Any] = [None] * world_size()
        dist.all_gather_object(parts, merged)
        merged = [r for part in parts for r in part]
    if dedup_key is not None:
        seen: dict[Any, dict] = {}
        for r in merged:
            seen[dedup_key(r)] = r
        merged = list(seen.values())
    return merged


def owned_shards(num_shards: int) -> range:
    """The shards of a stacked ``[num_shards, ...]`` batch this process
    computes: all of them in one process; under a group of n ranks, rank
    r's block ``[r S / n, (r + 1) S / n)``."""
    n = world_size()
    if n == 1:
        return range(num_shards)
    if num_shards % n:
        raise ValueError(f"{num_shards} shards do not divide over {n} ranks")
    per = num_shards // n
    r = dist.get_rank()
    return range(r * per, (r + 1) * per)


def all_reduce_mean(tensors: Sequence[torch.Tensor], count: int) -> None:
    """In place: each tensor becomes (its sum over the ranks) / ``count``.
    One all-reduce per dtype, over the tensors flattened together; with one
    process only the division."""
    if world_size() > 1:
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))
    for t in tensors:
        t.div_(count)
