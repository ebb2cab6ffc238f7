"""other_ms.train: device ms a traced training step in kernels that are
neither products (cuBLAS's names) nor the port's attention kernels:
elementwise work, norms, the optimizer."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    g = tr.seconds_by_group()
    other = sum(g.values()) - sum(g[k] for k in ("matmul", "attn_fwd",
                                                 "attn_dq", "attn_dkv"))
    return 1e3 * other / tr.counts["steps"]
