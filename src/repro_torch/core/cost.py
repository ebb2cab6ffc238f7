"""Counted cost of one real call: FLOPs, matrix-product FLOPs and bytes per
aten operation, the port's stand-in for the JAX package's optimized-HLO
reader (``repro/core/hlo_analysis.py``).

:func:`count_cost` runs a callable once under a ``TorchDispatchMode`` and
counts every aten operation it issues, the autograd backward and
``torch.utils.checkpoint``'s recomputation included:

* matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
  PyTorch's own attention calls): the formulas of
  ``torch.utils.flop_counter``, 2 m n k for a product, as the HLO reader
  counts a dot; they also make up ``dot_flops``;
* elementwise operations: one operation per output element; reductions:
  one per input element, as the HLO reader counts ``reduce``;
* bytes: every input and output tensor of the operation, each once (eager
  PyTorch runs unfused, so that is its traffic); a broadcast view counts
  the storage it spans;
* copies and casts: their bytes, no operations;
* views, ``empty`` and metadata operations: nothing.

The port's hand-written kernels are ``ctypes`` launches that no dispatch
mode sees, and on the CPU their wrappers run plain versions. So each
wrapper reports its kernel's own work (:mod:`repro_torch.kernels.work`),
counted under ``kernels`` and in the totals, and the counter ignores the
aten operations issued inside it: the CPU and the card count the same.
One card moves no collective bytes, so ``collectives`` stays empty.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work



def _ops(*names):
    """The aten operations of these names that this torch version has."""
    return {getattr(torch.ops.aten, n) for n in names
            if hasattr(torch.ops.aten, n)}


# operations that move or compute nothing: allocation, aliasing, metadata
_FREE = _ops("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
             "_local_scalar_dense", "resize_", "set_")
# copies and casts: bytes, no operations (the HLO reader counts none for
# copy or convert)
_MOVES = _ops("clone", "copy_", "_to_copy", "copy")
_REDUCTION = getattr(torch.Tag, "reduction", None)


@dataclass
class CollectiveOp:
    opcode: str
    bytes: float                    # per-device operand bytes
    group_size: int
    count: float                    # executions

    @property
    def ici_bytes(self) -> float:
        """Per-device link traffic under a ring algorithm."""
        g = max(self.group_size, 1)
        if self.opcode == "all-reduce":
            return 2.0 * (g - 1) / g * self.bytes
        if self.opcode in ("all-gather", "reduce-scatter", "all-to-all"):
            return (g - 1) / g * self.bytes
        return self.bytes


@dataclass
class CostReport:
    flops: float = 0.0
    dot_flops: float = 0.0
    bytes: float = 0.0
    collectives: List[CollectiveOp] = field(default_factory=list)
    flops_by_op: Dict[str, float] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    # hand-written kernel -> {"calls", "flops", "bytes"}
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return sum(c.bytes * c.count for c in self.collectives)

    @property
    def collective_ici_bytes(self) -> float:
        return sum(c.ici_bytes * c.count for c in self.collectives)

    def collective_summary(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for c in self.collectives:
            out[c.opcode] += c.bytes * c.count
        return dict(out)

    def add_kernel(self, name: str, w: work.Work) -> None:
        entry = self.kernels.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        entry["calls"] += 1
        entry["flops"] += w.flops
        entry["bytes"] += w.bytes
        self._add(f"kernel:{name}", w.flops, w.bytes)

    def _add(self, key: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        if flops:
            self.flops_by_op[key] = self.flops_by_op.get(key, 0.0) + flops
        if nbytes:
            self.bytes_by_op[key] = self.bytes_by_op.get(key, 0.0) + nbytes

    def to_dict(self) -> dict:
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "bytes": self.bytes, "kernels": self.kernels,
                "collective_bytes": self.collective_bytes}


def _spanned_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor spans: a stride-0 (broadcast) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def op_cost(func, args, kwargs, out) -> Tuple[str, float, float, bool]:
    """(the operation's name, flops, bytes, is a product) of one aten
    operation."""
    packet = func.overloadpacket
    key = str(packet)
    if packet in _FREE or getattr(func, "is_view", False):
        return key, 0.0, 0.0, False
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    nbytes = float(sum(_spanned_bytes(t) for t in ins + outs))
    if packet in flop_registry:
        flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        return key, flops, nbytes, True
    if packet in _MOVES:
        return key, 0.0, nbytes, False
    tags = func.tags
    if _REDUCTION in tags:
        return key, float(sum(t.numel() for t in ins[:1])), nbytes, False
    if torch.Tag.pointwise in tags:
        return key, float(sum(t.numel() for t in outs)), nbytes, False
    return key, 0.0, nbytes, False


class _Counter(TorchDispatchMode):
    def __init__(self, report: CostReport):
        super().__init__()
        self.report = report

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not work.inside_kernel():
            key, flops, nbytes, dot = op_cost(func, args, kwargs, out)
            if dot:
                self.report.dot_flops += flops
            self.report._add(key, flops, nbytes)
        return out


def count_cost(fn, *args, **kwargs) -> Tuple[object, CostReport]:
    """Run ``fn(*args, **kwargs)`` once, counting its work; returns (its
    result, the :class:`CostReport`). On a CUDA device the count ends
    after the device has finished."""
    report = CostReport()
    work._COUNTERS.append(report)
    try:
        with _Counter(report):
            result = fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    finally:
        work._COUNTERS.remove(report)
    return result, report


def top_consumers(report: CostReport, n: int = 10,
                  by: str = "flops") -> List[Tuple[float, str]]:
    """The largest contributors by aten operation (and hand-written
    kernel, ``kernel:<name>``): [(value, key)], by ``flops`` or
    ``bytes``."""
    table = report.flops_by_op if by == "flops" else report.bytes_by_op
    return sorted(((v, k) for k, v in table.items()), reverse=True)[:n]
