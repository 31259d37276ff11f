"""Multi-process training: process group, metric sums, global batches.

The JAX package replaces the reference's Lightning DDP over NCCL
(train/train.py:316-321) with `jax.distributed` and a global mesh
(`vap_realtime_tpu/parallel/distributed.py`).  The port goes back to
`torch.distributed`: one process per card, NCCL between cards (gloo on
the CPU), `DistributedDataParallel` averaging the gradients of the
trainable leaves.  Nothing tells a process of a cluster: the caller
gives the address (`tcp://localhost:<port>`), the world size and the
rank.

- `init_distributed` -> `torch.distributed.init_process_group`;
- `all_host_metrics` -> one all-reduce (sum) of the scalar metrics;
- `global_batch` -> this rank's slice of a global batch;
- `wrap_model` -> the model inside `DistributedDataParallel` when the
  world has more than one process (`train/trainer.py` `fit` uses it).
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vap_realtime_tpu_torch.parallel.mesh import local_slice


def init_distributed(address: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device="cuda",
                     timeout_s: float = 300.0) -> None:
    """Join the process group (a no-op for one process): NCCL when
    `device` is a CUDA device, gloo on the CPU.  address:
    "tcp://host:port"."""
    if world_size is None or world_size <= 1:
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=address,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_host_metrics(local: Dict[str, float]) -> Dict[str, float]:
    """Sum scalar metrics over all processes (one all-reduce in float64;
    the identity for one process)."""
    keys = sorted(local)
    vals = [float(local[k]) for k in keys]
    if world()[1] > 1:
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.tensor(vals, dtype=torch.float64, device=dev)
        dist.all_reduce(t)
        vals = t.cpu().tolist()
    return dict(zip(keys, vals))


def global_batch(tree: Dict[str, Any], rank: Optional[int] = None,
                 world_size: Optional[int] = None) -> Dict[str, np.ndarray]:
    """This rank's slice of every leaf of a GLOBAL batch (each process
    loads the same global batch; the JAX package's counterpart assembles
    the global array from the local shards instead)."""
    r, n = world()
    r = r if rank is None else rank
    n = n if world_size is None else world_size
    return {k: local_slice(np.asarray(v), r, n) for k, v in tree.items()}


def wrap_model(model: torch.nn.Module, device) -> torch.nn.Module:
    """`model` inside `DistributedDataParallel` when the world has more
    than one process, else `model`.  Call it after the optimiser has
    switched on the trainable leaves' grad: DDP syncs only those."""
    if world()[1] <= 1:
        return model
    dev = torch.device(device)
    ids = [dev] if dev.type == "cuda" else None
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=ids, find_unused_parameters=True)
