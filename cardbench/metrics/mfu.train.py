"""mfu.train: the model FLOPs of the window's training steps (counted from
shapes, cardbench/workcount.py) over the window's time and the peak of the
cell's input dtype, in %."""
from cardbench.peaks import peak_flops


def read(ctx):
    n = ctx["counts"]
    if not n.get("steps"):
        return None
    return 100.0 * n["steps"] * n["step_flops"] / n["window_s"] / \
        peak_flops(n["dtype"])
