"""Where a serving run's or a training step's time goes on the card.

:func:`profile_device` runs a callable once under ``torch.profiler`` (CPU
and CUDA activity) and summarises it: kernel launches, the device's busy
share over the run (union of kernel and copy intervals over the run's
span), device time by kernel group (matrix products, the hand-written
kernels, everything else), the top kernels by device time, the copies by
direction (a pageable host-to-device copy blocks the host until the
device drains) and the host's synchronisation calls. :func:`profile_run`
adds an engine run's decode steps and launches per forward pass (decode
step or prefill chunk). Timings under the profiler are inflated by the
tracing itself. ``chip_smoke.py`` runs them on its serving workload and
on one training step; on CPU tensors the device figures are zero.
"""
from __future__ import annotations

from collections import Counter

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.serving.roles import sync

# kernel name fragment -> group (first match wins); "nvjet" names
# cuBLASLt's Hopper kernels, which run the bf16 products
GROUPS = (("attn_fwd_kernel", "K1/B2 flash forward"),
          ("attn_dq_kernel", "B3 flash dq"),
          ("attn_dkv_kernel", "B4 flash dkv"),
          ("paged_decode_kernel", "K2 paged_attention"),
          ("rmsnorm_kernel", "K3 rmsnorm"),
          ("wkv6_kernel", "B6 wkv6"),
          ("gemm", "matmul"), ("gemv", "matmul"), ("cutlass", "matmul"),
          ("xmma", "matmul"), ("nvjet", "matmul"))
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def _group(name: str) -> str:
    low = name.lower()
    for frag, group in GROUPS:
        if frag.lower() in low:
            return group
    return "other"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_device(fn) -> tuple:
    """Run ``fn()`` once under the profiler; returns (its result, the
    summary of the device's activity)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    copies = Counter(e.name for e in device if e.name.startswith("Memcpy"))
    by_group, by_name = Counter(), Counter()
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_group[_group(e.name)] += us
        by_name[e.name] += us
    syncs = Counter(e.name for e in events
                    if e.device_type == DeviceType.CPU and e.name in SYNC_CALLS)
    span_us = (max(s[1] for s in spans) - min(s[0] for s in spans)
               if spans else 0.0)
    return out, {
        "kernel_launches": len(kernels),
        "device_span_ms": span_us / 1e3,
        "device_busy_share": (_union_us(spans) / span_us) if span_us else 0.0,
        "device_ms_by_group": {k: v / 1e3 for k, v in by_group.most_common()},
        "top_kernels_ms": [[name[:80], us / 1e3]
                           for name, us in by_name.most_common(8)],
        "copies": dict(copies),
        "sync_calls": dict(syncs),
    }


def profile_run(engine, requests) -> dict:
    """Run ``requests`` once under the profiler and summarise it."""
    def run():
        report = engine.run(requests)
        sync(engine.device)
        return report

    report, dev = profile_device(run)
    s = report.summary()
    forwards = s["decode_steps"] + s["prefills"]
    return {
        "scheduler": report.scheduler,
        "decode_steps": s["decode_steps"], "prefills": s["prefills"],
        "makespan_s": s["makespan_s"], "tok_p50_s": s["tok_p50_s"],
        "ttft_p50_s": s["ttft_p50_s"],
        "launches_per_forward": dev["kernel_launches"] / max(forwards, 1),
        **dev,
    }
