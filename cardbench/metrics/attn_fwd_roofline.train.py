"""attn_fwd_roofline.train: kernel B2's share of its roofline in the traced
training steps, in %: launches x the least time one launch could take
(the larger of its operations over the dtype's peak and its bytes over the
HBM's), over B2's device time. Every B2 launch of a step has the shape of
one microbatch's layer."""
from cardbench import peaks, workcount


def read(ctx):
    tr = ctx["trace"]
    launches = tr.launches_by_group()["attn_fwd"] if tr else 0
    if not launches:
        return None
    c = ctx["config"]
    w = workcount.flash_forward(
        **workcount.training_attention_shape(c, ctx["traffic"]), lse=True)
    bound, _ = peaks.bound_s(w.flops, w.bytes, c["dtype"])
    return 100.0 * launches * bound / tr.seconds_by_group()["attn_fwd"]
