"""The traced window: ``torch.profiler`` over a stretch of the run, kept in
memory and summed into what the per-layer readers need.

The arithmetic is a frozen copy of the port's ``core/profile.py``: kineto's
raw events (never ``prof.events()``, which builds a tree of every event
first and costs most of a minute on a training step), the device's busy
time as the union of its kernel and copy intervals, and kernels grouped
by name. No Chrome trace is written.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field

import torch

# kernel name fragment -> group, first match wins ("nvjet": cuBLASLt's
# Hopper kernels)
GROUPS = (("attn_fwd_kernel", "attn_fwd"),
          ("attn_dq_kernel", "attn_dq"),
          ("attn_dkv_kernel", "attn_dkv"),
          ("paged_decode_kernel", "paged"),
          ("rmsnorm_kernel", "rmsnorm"),
          ("wkv6_kernel", "wkv6"),
          ("gemm", "matmul"), ("gemv", "matmul"), ("cutlass", "matmul"),
          ("xmma", "matmul"), ("nvjet", "matmul"))
_FILTERED = frozenset(("[memory]", "[OutOfMemory]",
                       "profiler::_record_function_enter",
                       "profiler::_record_function_enter_new",
                       "profiler::_record_function_exit",
                       "aten::is_leaf", "aten::output_nr", "aten::_version"))
SPAN_PREFIX = "cardbench."


def group_of(name: str) -> str:
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    return "other"


def union_ns(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@dataclass
class Trace:
    """What the card did in the traced window. ``device``: (name, start
    ns, end ns) of every kernel and copy; ``host``: the same of every host
    event; ``window_s``: the window's length on the host's clock;
    ``counts``: what the driver counted inside it (steps, tokens)."""
    device: list
    host: list
    window_s: float
    counts: dict = field(default_factory=dict)

    def kernels(self):
        return [ev for ev in self.device
                if not ev[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        return union_ns((s, e) for _, s, e in self.device) / 1e9

    def idle_percent(self) -> float:
        """The share of the window with no kernel or copy running, in %."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def seconds_by_group(self) -> Counter:
        out = Counter()
        for n, s, e in self.kernels():
            out[group_of(n)] += (e - s) / 1e9
        return out

    def launches_by_group(self) -> Counter:
        return Counter(group_of(n) for n, _, _ in self.kernels())

    def device_ops(self, top: int = 10) -> list:
        by = Counter()
        for n, s, e in self.device:
            by[n[:120]] += (e - s) / 1e9
        return [[n, s] for n, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds between device operations, summed by what the host
        was doing at each gap's middle: the harness span around it and the
        innermost host event."""
        spans = sorted((s, e, n) for n, s, e in self.host
                       if n.startswith(SPAN_PREFIX))
        host = sorted((s, e, n) for n, s, e in self.host
                      if not n.startswith(SPAN_PREFIX))
        merged = []
        for s, e in sorted((s, e) for _, s, e in self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
        by, stack, i = Counter(), [], 0
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            while i < len(host) and host[i][0] <= mid:
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            inner = stack[-1][2] if stack else "no host event"
            outer = next((n for s, e, n in spans if s <= mid <= e), "")
            label = f"{outer[len(SPAN_PREFIX):]} > {inner}" if outer else inner
            by[label[:120]] += (g1 - g0) / 1e9
        return [[n, s] for n, s in by.most_common(top)]


def _raw_events(prof) -> tuple:
    device, host = [], []
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        if name in _FILTERED:
            continue
        s = e.start_ns()
        ev = (name, s, s + e.duration_ns())
        on_device = e.device_type() == DeviceType.CUDA
        # a host span shows on the device too, as an annotation over the
        # kernels it launched: it is no device operation
        (device if on_device and not name.startswith(SPAN_PREFIX)
         else host).append(ev)
    return device, host


class Tracer:
    """Starts and stops the profiler around a stretch of the run."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.t0 = 0.0
        self.trace = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop the profiler once on a trivial op, so that its
        first start (CUPTI's set-up) falls in the set-up and not in the
        traced window."""
        with self._profile():
            torch.ones(8, device=self.device).sum().item()

    def start(self) -> None:
        self._sync()
        self.prof = self._profile()
        self.prof.start()
        self.t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.trace is None

    def stop(self, **counts) -> Trace:
        self._sync()
        window = time.perf_counter() - self.t0
        self.prof.stop()
        device, host = _raw_events(self.prof)
        self.prof = None
        self.trace = Trace(device, host, window, dict(counts))
        return self.trace


def span(name: str):
    """A host span the trace's idle gaps are labelled by."""
    return torch.profiler.record_function(SPAN_PREFIX + name)
