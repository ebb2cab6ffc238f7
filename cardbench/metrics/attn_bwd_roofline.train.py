"""attn_bwd_roofline.train: kernels B3 (dq) and B4 (dk, dv) together, their
share of their roofline in the traced training steps, in %: for each, its
launches x the least time one launch could take (the larger of its
operations over the dtype's peak and its bytes over the HBM's), summed,
over their device time."""
from cardbench import peaks, workcount


def read(ctx):
    tr = ctx["trace"]
    n = tr.launches_by_group() if tr else {}
    if not n or not n["attn_dq"] or not n["attn_dkv"]:
        return None
    c = ctx["config"]
    shape = workcount.training_attention_shape(c, ctx["traffic"])
    bound = sum(n[grp] * peaks.bound_s(w.flops, w.bytes, c["dtype"])[0]
                for grp, w in (("attn_dq", workcount.flash_dq(**shape)),
                               ("attn_dkv", workcount.flash_dkv(**shape))))
    g = tr.seconds_by_group()
    return 100.0 * bound / (g["attn_dq"] + g["attn_dkv"])
