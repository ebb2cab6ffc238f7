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

The summary reads kineto's raw events (name, device, start, duration)
and never ``prof.events()``: that builds a ``FunctionEvent`` tree over
every recorded event first, tens of microseconds an event on the host, so
a training step of some 10^5 launches (five events each) spent most of a
minute in it and a fraction of a second in the sums it feeds.
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
# what ``prof.events()`` leaves out: the profiler's own and memory records
_FILTERED = frozenset(("[memory]", "[OutOfMemory]",
                       "profiler::_record_function_enter",
                       "profiler::_record_function_enter_new",
                       "profiler::_record_function_exit",
                       "aten::is_leaf", "aten::output_nr", "aten::_version"))


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


def _raw_events(prof) -> list:
    """(name, on the device, start ns, duration ns) of each event kineto
    recorded, without the profiler's own bookkeeping ops."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        if name in _FILTERED:
            continue
        out.append((name, e.device_type() == DeviceType.CUDA, e.start_ns(),
                    e.duration_ns()))
    return out


def profile_device(fn) -> tuple:
    """Run ``fn()`` once under the profiler; returns (its result, the
    summary of the device's activity)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
    events = _raw_events(prof)
    device = [(n, s, s + d) for n, on_device, s, d in events if on_device]
    spans = [(s, e) for _, s, e in device]
    kernels = [(n, s, e) for n, s, e in device
               if not n.startswith(("Memcpy", "Memset"))]
    copies = Counter(n for n, _, _ in device if n.startswith("Memcpy"))
    by_group, by_name = Counter(), Counter()
    for n, s, e in kernels:
        us = (e - s) / 1e3
        by_group[_group(n)] += us
        by_name[n] += us
    syncs = Counter(n for n, on_device, _, _ in events
                    if not on_device and n in SYNC_CALLS)
    span_us = (max(s[1] for s in spans) - min(s[0] for s in spans)) / 1e3 \
        if spans else 0.0
    return out, {
        "kernel_launches": len(kernels),
        "device_span_ms": span_us / 1e3,
        "device_busy_share": (_union_us(spans) / 1e3 / span_us)
        if span_us else 0.0,
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
