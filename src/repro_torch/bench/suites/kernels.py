"""Kernel micro-benchmarks: each hand-written kernel against its plain
PyTorch version and, where one exists, the one PyTorch call that computes
the same function. The port of ``benchmarks/bench_kernels.py``: the
reference's ``dense_ref``/``jnp`` become ``plain``, ``chunked_jnp`` (for
wkv6) ``chunked``, ``pallas_interp`` ``kernel``, and ``library`` is new
(SDPA, ``F.rms_norm``; none for wkv6).

Each scenario runs at the reference's shape (``ref``) and, on the card,
at the first shape of the kernel's row in PERF.md's table (``path``, the
shape the serving path gives it). Every record carries the kernel's work
(``flops``, ``bytes``: :mod:`repro_torch.kernels.work`), its largest
error against ``plain`` on the same inputs (``max_abs_err``, and
``rel_err`` over the plain result's largest magnitude) and, for
``kernel``, the launches its timed calls made (the wrappers' counters).

A ``kernel`` workload runs only on the card: on ``--device cpu`` it is
not run (the wrapper would run the plain version), and its record says
so (``not_run``) and holds no time, so no plain time ever stands under a
kernel's name. The ``path`` shapes are the card's too.
"""
from __future__ import annotations

from repro_torch.bench import BenchRecord, Workload, scenario, timeit_us

_ATTN_IMPLS = ("plain", "kernel", "library")
_WKV_IMPLS = ("plain", "chunked", "kernel")
_NORM_IMPLS = ("plain", "kernel", "library")
SHAPES = ("ref", "path")

# (B, S, Hq, Hkv, D), causal: the reference's shape, granite's prefill
ATTN_SHAPES = {"ref": (1, 512, 4, 2, 64), "path": (1, 128, 32, 8, 128)}
# (B, T, H, K, V, with u): the reference's (SSD mode), rwkv6-3b's layer
WKV_SHAPES = {"ref": (1, 256, 2, 64, 64, False),
              "path": (1, 128, 40, 64, 64, True)}
# (rows, d): the reference's, granite's decode rows
NORM_SHAPES = {"ref": (4096, 512), "path": (128, 4096)}
KERNEL_OF = {"kernels/attention": "flash_attention",
             "kernels/wkv6": "wkv6", "kernels/rmsnorm": "rmsnorm"}


def _workloads(impls):
    return [Workload(label=f"{impl}_{shape}",
                     knobs={"impl": impl, "shape": shape})
            for shape in SHAPES for impl in impls]


def _skip_reason(wl: Workload, device) -> str:
    if device.type == "cuda":
        return ""
    if wl.knobs["impl"] == "kernel":
        return ("the kernel runs only on the card; on the CPU its wrapper "
                "would run the plain version")
    if wl.knobs["shape"] == "path":
        return "the path shapes run on the card"
    return ""


def _measure(name, wl, device, fn, plain_out, work, kernel: str = ""):
    """Time ``fn`` and hold its output to ``plain_out``; the record."""
    from repro_torch.kernels import ops

    reason = _skip_reason(wl, device)
    derived = {"flops": work.flops, "bytes": work.bytes,
               "device": device.type}
    if reason:
        return BenchRecord(name=name, derived={**derived, "not_run": reason})
    out = fn()
    out = out[0] if isinstance(out, tuple) else out
    err = float((out.float() - plain_out.float()).abs().max())
    scale = max(float(plain_out.float().abs().max()), 1e-30)
    before = ops.LAUNCHES[kernel] if kernel else 0
    us = timeit_us(fn)
    if kernel:
        derived["launches"] = ops.LAUNCHES[kernel] - before
    return BenchRecord(name=name, us_per_call=us, p50_us=us.p50_us,
                       p95_us=us.p95_us, samples_us=list(us.samples),
                       derived={**derived, "max_abs_err": err,
                                "rel_err": err / scale})


def _device(wl: Workload):
    from repro_torch.models.model import resolve_device
    return resolve_device(wl.knobs.get("device", "cuda"))


@scenario("kernels/attention", tags=("kernel", "micro", "measured"),
          paper_ref="kernel-level microbenchmarks",
          workloads=_workloads(_ATTN_IMPLS))
def kernels_attention(wl: Workload):
    """Causal attention forward: K1 vs its plain version vs SDPA."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref, work

    device = _device(wl)
    B, S, Hq, Hkv, D = ATTN_SHAPES[wl.knobs["shape"]]
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, D),
                                                    np.float32)).to(device)
               for h in (Hq, Hkv, Hkv))
    plain = ref.flash_attention_ref(q, k, v, causal=True)
    impl = wl.knobs["impl"]
    if impl == "plain":
        fn = lambda: ref.flash_attention_ref(q, k, v, causal=True)  # noqa
    elif impl == "kernel":
        fn = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa
    else:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    yield _measure(
        f"kernels/attn_{impl}_{wl.knobs['shape']}", wl, device, fn, plain,
        work.flash_forward(q, k, causal=True, window=0),
        "flash_attention" if impl == "kernel" else "")


@scenario("kernels/wkv6", tags=("kernel", "micro", "ssm", "measured"),
          paper_ref="kernel-level microbenchmarks",
          workloads=_workloads(_WKV_IMPLS))
def kernels_wkv6(wl: Workload):
    """Chunked WKV6: B6 vs its plain version vs the model's chunked
    form."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref, work
    from repro_torch.models.ssm import linear_attention

    device = _device(wl)
    B, T, H, K, V, with_u = WKV_SHAPES[wl.knobs["shape"]]
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    q, k = draw(B, T, H, K), draw(B, T, H, K)
    v = draw(B, T, H, V)
    ld = -torch.exp(draw(B, T, H, K))
    u = draw(H, K) * 0.1 if with_u else None
    q, k, v, ld = (t.to(device) for t in (q, k, v, ld))
    u = None if u is None else u.to(device)
    plain = ref.wkv6_chunked_ref(q, k, v, ld, u)[0]
    impl = wl.knobs["impl"]
    if impl == "plain":
        fn = lambda: ref.wkv6_chunked_ref(q, k, v, ld, u)  # noqa: E731
    elif impl == "chunked":
        fn = lambda: linear_attention(q, k, v, ld, u,  # noqa: E731
                                      backend="chunked")
    else:
        fn = lambda: ops.wkv6(q, k, v, ld, u)  # noqa: E731
    yield _measure(f"kernels/wkv6_{impl}_{wl.knobs['shape']}", wl, device,
                   fn, plain, work.wkv6(q, v, ld, u),
                   "wkv6" if impl == "kernel" else "")


@scenario("kernels/rmsnorm", tags=("kernel", "micro", "measured"),
          paper_ref="kernel-level microbenchmarks",
          workloads=_workloads(_NORM_IMPLS))
def kernels_rmsnorm(wl: Workload):
    """RMSNorm: K3 vs its plain version vs ``F.rms_norm``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref, work

    device = _device(wl)
    rows, d = NORM_SHAPES[wl.knobs["shape"]]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((rows, d), np.float32)).to(
        device)
    sc = torch.ones(d, dtype=torch.float32, device=device)
    plain = ref.rmsnorm_ref(x, sc)
    impl = wl.knobs["impl"]
    if impl == "plain":
        fn = lambda: ref.rmsnorm_ref(x, sc)  # noqa: E731
    elif impl == "kernel":
        fn = lambda: ops.rmsnorm(x, sc)  # noqa: E731
    else:
        fn = lambda: F.rms_norm(x, (d,), sc, eps=1e-5)  # noqa: E731
    yield _measure(f"kernels/rmsnorm_{impl}_{wl.knobs['shape']}", wl,
                   device, fn, plain, work.rmsnorm(rows, d, 4),
                   "rmsnorm" if impl == "kernel" else "")
