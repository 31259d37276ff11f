"""Mean host milliseconds a tick spends inside `StreamArena.
step_device_batch` (the active mask, the pinned upload, the step's
dispatch), from the harness's host-clock spans around the call, over the
untraced ticks of the traced run.  Moves the serving cells' latency or
frame rate: the host's dispatch bounds a tick from below."""


def read(ctx, name):
    xs = ctx["host"].get("arena", [])
    return 1e3 * sum(xs) / len(xs) if xs else None
