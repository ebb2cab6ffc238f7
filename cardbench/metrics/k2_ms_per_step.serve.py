"""k2_ms_per_step.serve: kernel K2's device ms over the decode steps of the
traced window."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device or not tr.counts.get("decode"):
        return None
    return 1e3 * tr.seconds_by_group()["paged"] / tr.counts["decode"]
