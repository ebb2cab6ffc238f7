"""queue_p80_ms.serve: the 80th percentile of each finished request's wait
in the queue, admitted_s - arrival_s on the engine's clock, in ms."""
from cardbench.drivers.serve import percentile


def read(ctx):
    q = ctx["counts"].get("queue_s", [])
    return 1e3 * percentile(q, 80) if q else None
