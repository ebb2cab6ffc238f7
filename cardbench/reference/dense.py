"""The plain reference of a dense decoder block (granite-3-8b as run):
pre-RMSNorm grouped-query attention with rotary embeddings, then a
pre-RMSNorm SwiGLU MLP, each added to the residual.

Departures from the published granite-3.0 description, as the
configuration file lists them: no embedding, attention, residual or
logit multipliers (the softmax scale is 1/sqrt(head_dim)).
"""
from cardbench.reference.common import mlp, rmsnorm, self_attention


def layer(p, x, positions, c, mm):
    eps = c["rms_norm_eps"]
    x = x + self_attention(p["attn"], rmsnorm(x, p["norm1"]["scale"], eps),
                           positions, c, mm)
    return x + mlp(p["mlp"], rmsnorm(x, p["norm2"]["scale"], eps), mm)
