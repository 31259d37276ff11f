"""Per-layer metric readers, one per metric (`metrics/<metric>.py`, or
`metrics/<name before the first dot>.py` for a family of cells), each
with `read(ctx, name) -> float | None`.  A reader that finds nothing to
read returns None and the harness leaves the metric out of the line."""
