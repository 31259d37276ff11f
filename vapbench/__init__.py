"""vapbench: the benchmark of `vap_realtime_tpu_torch` on one NVIDIA H100.

Driven by data.  `BENCHMARK.json` at the checkout's root lists the cells
and the metrics; each cell is `vapbench/workloads/<cell>.json`, which
names its configuration (`vapbench/configs/<name>.json`) and its driver
kind (`vapbench/drivers/<kind>.py`).  Each per-layer metric is read by
`vapbench/metrics/<metric>.py` (or the reader of the name before its
first dot), and each kernel's operations and bytes are counted by
`vapbench/counts/<kernel>.py`.  A later cell, configuration, metric or
count is a new file here and a new entry in `BENCHMARK.json`.

Run one cell (on the card; from the checkout's root):

    python3 -m vapbench.run --workload vap20-fast-open --seed 7 \
        --seconds 20 --trace 0

Nothing here imports JAX or the JAX package; `vapbench/reference/` is
plain PyTorch and imports nothing of the port either.
"""
