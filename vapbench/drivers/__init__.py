"""Traffic drivers, one module per kind (`drivers/<kind>.py`), each with
`run(ctx) -> result`; a workload file names its kind under "driver"."""
