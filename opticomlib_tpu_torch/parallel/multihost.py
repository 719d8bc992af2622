"""Bring-up of ``torch.distributed`` for runs over several ranks (port of
``opticomlib_tpu.parallel.multihost``).

The sharded runtime (:func:`~opticomlib_tpu_torch.parallel.fiber.
ssfm_sharded`) is written against a mesh of ranks
(:func:`~opticomlib_tpu_torch.parallel.fiber.make_link_mesh`), one process
a rank and one card a process.  This module wraps the standard bring-up so
a run is one call per process:

    # the same script on every rank, e.g. torchrun --nproc-per-node=4
    from opticomlib_tpu_torch.parallel import (initialize_multihost,
                                               make_link_mesh, ssfm_sharded)
    initialize_multihost()                  # rank and size from torchrun
    mesh = make_link_mesh(n_wdm=1)          # every rank on the 'time' axis
    out = ssfm_sharded(A, mesh, fs, length=50.0, ...)

Sizing guidance (BASELINE config 5, 16 ch x 2^26): channels over hosts
('wdm', no traffic between them but the step-size scalars) and the time
axis over the cards of one host ('time': the pencil transposes stay on
NVLink), i.e. ``make_link_mesh(n_wdm=n_hosts, n_time=cards_per_host)``.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None,
                         timeout_s: Optional[float] = None) -> int:
    """Initialise ``torch.distributed`` (idempotent) and return the world
    size.

    Under ``torchrun`` call it with no arguments: address, world size and
    rank come from the environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  Elsewhere pass the
    coordinator's ``host:port`` (or a full ``tcp://`` / ``file://`` URL),
    the number of processes and this process's index.

    ``device``: this rank's device, default ``gv``'s (the card; raises
    without one).  A card means the ``nccl`` backend on card ``LOCAL_RANK``
    (else ``process_id`` modulo the cards of the host), made the current
    CUDA device; ``"cpu"`` means ``gloo``.  There is no way from one to the
    other: a card whose NCCL does not come up raises.  ``timeout_s``: the
    collectives' time limit (a hung collective fails instead of waiting;
    default: the backend's).
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    from ..params import check_device, current_device

    dev = current_device() if device is None else check_device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            local = os.environ.get("LOCAL_RANK", process_id or 0)
            index = int(local) % torch.cuda.device_count()
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, **kw)
    return dist.get_world_size()
