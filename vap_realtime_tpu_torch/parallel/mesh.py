"""Device placement for training and evaluation.

The JAX package shards a batch's leading axis over a `dp` mesh of the
host's chips and replicates the params (`vap_realtime_tpu/parallel/
mesh.py`).  The port trains on one card per process: the params and each
batch move to the process's device, and across processes
(`parallel/distributed.py`) each rank takes its slice of the global
batch; `DistributedDataParallel` then averages the gradients.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from vap_realtime_tpu_torch.weights.convert import params_to_torch


def local_slice(x: np.ndarray, rank: int = 0, world_size: int = 1):
    """Rank `rank`'s contiguous share of x's leading axis, which must
    divide evenly (equal shares keep the averaged gradient that of the
    whole batch's mean loss)."""
    n = x.shape[0]
    if n % world_size:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{world_size} processes")
    k = n // world_size
    return x[rank * k:(rank + 1) * k]


def shard_batch(batch: Dict[str, Any], device, rank: int = 0,
                world_size: int = 1) -> Dict[str, torch.Tensor]:
    """A numpy batch -> this rank's slice of every entry as tensors on
    `device`."""
    return {k: torch.as_tensor(np.ascontiguousarray(
                local_slice(np.asarray(v), rank, world_size))).to(device)
            for k, v in batch.items()}


def replicate(tree: Any, device) -> Any:
    """A params tree (numpy or tensors) -> the same tree of tensors on
    `device` (tensor leaves are detached copies)."""
    if isinstance(tree, dict):
        return {k: replicate(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [replicate(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    return params_to_torch(tree, device)
