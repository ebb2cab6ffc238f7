"""decode_step_ms.serve: the median duration of a decode step as the engine
stamps it for each token it produced (``token_latencies_s``), in ms."""
import statistics


def read(ctx):
    s = ctx["counts"].get("decode_step_s", [])
    return 1e3 * statistics.median(s) if s else None
