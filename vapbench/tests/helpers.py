"""Small-size settings shared by the benchmark's CPU tests."""

import copy
import time

from vapbench.common import load_config, load_workload


def small_workload(name, clips=4, seconds=8):
    wl = copy.deepcopy(load_workload(name))
    wl["audio"].update(clips=clips, seconds=seconds)
    return wl


def run_small(cell, seed, seconds, **kw):
    """`execute` on the CPU at a small size: the cell's own workload and
    configuration unless given, a small audio pool."""
    import torch

    from vapbench.run import execute

    torch.set_num_threads(2)
    kw.setdefault("workload", small_workload(cell))
    return execute(cell, seed, seconds, False, "cpu", t_proc=time.time(),
                   **kw)


def small_context(cfg_name, seconds_ctx):
    cfg = copy.deepcopy(load_config(cfg_name))
    cfg["model"]["context_len_sec"] = seconds_ctx
    return cfg
