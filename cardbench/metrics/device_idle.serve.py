"""device_idle.serve: the share of the traced decode steps' window in
which the card ran neither a kernel nor a copy, in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return tr.idle_percent()
