"""decode_busy_ms.serve: the card's busy ms inside each whole decode step
of the traced replay, the program's ``repro_torch.serve.decode_step``
span (one dispatch over every lane, ending in a sync, so the device work
inside it is the step's), averaged over those steps. Busy time is what
tracing does not inflate: ``decode_step_ms.serve`` less this is the
untraced host overhead of a decode step."""
from cardbench import spans


def read(ctx):
    return spans.mean_busy_ms(ctx["trace"], "repro_torch.serve.decode_step")
