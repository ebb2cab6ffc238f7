"""prefill_stall_ms.serve: the ms a running lane waits in other requests'
prefill a decode step: the summed duration of the program's
``repro_torch.serve.prefill_chunk`` spans between the start of the first
and the end of the last whole ``repro_torch.serve.decode_step`` span of
the traced replay, over the number of those decode steps."""
from cardbench import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    steps = spans.whole(tr, "repro_torch.serve.decode_step")
    if not steps:
        return None
    lo, hi = steps[0][0], steps[-1][1]
    chunks = [e - s for s, e in spans.whole(
        tr, "repro_torch.serve.prefill_chunk") if lo <= s and e <= hi]
    return 1e-6 * sum(chunks) / len(steps)
