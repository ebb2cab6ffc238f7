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

Collectives: the ``c10d`` operations of ``torch.distributed`` come
through the same mode (gloo, NCCL, and the dry run's ``fake`` group
alike). Each is one :class:`CollectiveOp` under the reference's opcode
(``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
``collective-permute`` for a ``send``, ``collective-broadcast``), with
its per-device operand bytes and the size of its process group; its
operand and result bytes count in ``bytes`` too, as the reference's HLO
reader counts them. A collective over a group of one rank counts
nothing: it moves no link bytes, and XLA's simplifier removes it before
the reference's reader sees it. A ``recv`` is the receiving half of a
``send`` and is not counted again. The aten operations a backend runs around a
collective (gloo's copies; NCCL and the ``fake`` group run none) are
not counted either: the port makes each call inside
:func:`repro_torch.kernels.work.collective`.

:func:`count_cost_and_peak` also follows the bytes the call allocates:
each new storage an operation creates joins a live sum when it appears
and leaves it when it dies (a weakref finalizer), and the largest sum,
on top of the arguments' bytes, is the call's peak. Inside a wrapper's
kernel region only what outlives the region counts: the plain version's
intermediates (flash attention's S x S scores) are memory the kernel
never allocates.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
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

# c10d operation -> (the reference's opcode, the argument holding the
# operand); a recv is the receiving half of a send, counted once there
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 1),
    "allgather_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
    "broadcast_": ("collective-broadcast", 0),
}


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

    def collective_ici_summary(self) -> Dict[str, float]:
        """Per-opcode ring link traffic (ici_bytes x count): the
        collective lane a trace decomposes."""
        out: Dict[str, float] = defaultdict(float)
        for c in self.collectives:
            out[c.opcode] += c.ici_bytes * c.count
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
                "collective_bytes": self.collective_bytes,
                "collective_breakdown": self.collective_summary()}


@dataclass
class MemoryReport:
    """Bytes of one call (:func:`count_cost_and_peak`): its arguments,
    its outputs (``alias``: those that are arguments' storages, updated
    in place), the most it held of what it allocated (``live_peak``),
    and the reference's keys derived from them."""
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    alias_bytes: float = 0.0
    live_peak_bytes: float = 0.0

    @property
    def temp_bytes(self) -> float:
        return max(0.0, self.live_peak_bytes
                   - (self.output_bytes - self.alias_bytes))

    @property
    def peak_bytes(self) -> float:
        return self.argument_bytes + self.live_peak_bytes

    def to_gb(self) -> dict:
        """The dry run record's ``memory``, in the reference's keys: peak =
        argument + temp + output - alias."""
        return {"argument_gb": self.argument_bytes / 1e9,
                "output_gb": self.output_bytes / 1e9,
                "temp_gb": self.temp_bytes / 1e9,
                "alias_gb": self.alias_bytes / 1e9,
                "peak_gb": self.peak_bytes / 1e9}


def _spanned_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor spans: a stride-0 (broadcast) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def _flat(tree, out: list) -> list:
    """The leaves of nested lists, tuples, dicts and dataclasses (an
    operation's arguments and results; a step's state, such as
    ``AdamWState``), faster than pytree's flatten."""
    if isinstance(tree, (list, tuple)):
        for x in tree:
            _flat(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _flat(x, out)
    elif is_dataclass(tree) and not isinstance(tree, type):
        for f in fields(tree):
            _flat(getattr(tree, f.name), out)
    else:
        out.append(tree)
    return out


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in _flat(tree, []) if isinstance(t, torch.Tensor)]


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


def _group_size(args) -> int:
    """The size of the process group among a c10d operation's
    arguments (1 if none is found)."""
    from torch._C._distributed_c10d import ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except RuntimeError:         # the reduce op, not the group
                continue
    return 1


def _one_rank(func, args) -> bool:
    """A ``c10d`` operation over a group of one rank."""
    return func.namespace == "c10d" and _group_size(args) == 1


def collective_op(func, args) -> Optional[CollectiveOp]:
    """The :class:`CollectiveOp` of one ``c10d`` operation, or None (not
    a collective the reference counts)."""
    name = func.overloadpacket.__name__
    if func.namespace != "c10d" or name not in _COLLECTIVES:
        return None
    opcode, arg = _COLLECTIVES[name]
    operand = _tensors(args[arg])
    return CollectiveOp(opcode=opcode,
                        bytes=float(sum(_spanned_bytes(t) for t in operand)),
                        group_size=_group_size(args), count=1.0)


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):   # a tensor with no storage
        return None


class _LiveBytes:
    """The bytes a call has allocated and still holds: a storage joins
    when an operation creates it and leaves when it dies. Storages born
    inside a kernel region wait in ``pending``; those that outlive it (the
    region's outputs) join at the next operation outside."""

    def __init__(self, arguments: List[torch.Tensor]):
        self.known = set()
        self.argument_bytes = 0
        for t in arguments:
            st = _storage(t)
            if st is not None and st._cdata not in self.known:
                self.known.add(st._cdata)
                self.argument_bytes += st.nbytes()
        self.tracked: Dict[int, int] = {}
        self.pending: Dict[int, int] = {}
        self.live = 0
        self.peak = 0

    def _drop(self, key: int) -> None:
        if key in self.pending:
            del self.pending[key]
        elif key in self.tracked:
            self.live -= self.tracked.pop(key)

    def flush(self) -> None:
        for key, n in self.pending.items():
            self.tracked[key] = n
            self.live += n
        self.pending.clear()
        self.peak = max(self.peak, self.live)

    def see(self, outs: List[torch.Tensor], inside: bool) -> None:
        if not inside:
            self.flush()
        for t in outs:
            st = _storage(t)
            if st is None:
                continue
            key = st._cdata
            if key in self.known or key in self.tracked or key in self.pending:
                continue
            n = st.nbytes()
            (self.pending if inside else self.tracked)[key] = n
            weakref.finalize(st, self._drop, key)
            if not inside:
                self.live += n
        self.peak = max(self.peak, self.live)


_FRESH: Dict[object, bool] = {}


def _fresh_outputs(func) -> bool:
    """True for an operation that mutates none of its arguments and
    returns new tensors only (no view, no in-place result)."""
    if func not in _FRESH:
        schema = func._schema
        _FRESH[func] = not (
            any(a.alias_info is not None for a in schema.arguments)
            or any(r.alias_info is not None for r in schema.returns))
    return _FRESH[func]


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return (x.device.type, tuple(x.shape), x.stride(),
                x.storage_offset(), x.dtype)
    try:
        hash(x)
        return (type(x), x)           # 1, 1.0 and True are equal keys
    except TypeError:
        return repr(x)


def _own_storage(t, taken: set) -> bool:
    """``t`` starts its own storage, spans all of it, and shares it with
    nothing in ``taken`` (whose ``_cdata`` it joins)."""
    st = _storage(t)
    if st is None or t.storage_offset() != 0 or st._cdata in taken:
        return False
    taken.add(st._cdata)
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return st.nbytes() == (span * t.element_size() if t.numel() else 0)


class _MetaMemo:
    """The outputs and cost of operations on ``meta`` tensors, by their
    arguments' metadata, for one count. PyTorch computes a ``meta``
    result's shape in Python, op by op, and a step repeats the same few
    hundred operations at the same shapes in every layer and microbatch:
    the memo halves a training cell's count. An entry is kept only where
    the first result is what :func:`torch.empty_strided` would make
    anew: fresh outputs (:func:`_fresh_outputs`), each on a storage of
    its own that it spans exactly and that is no argument's (an
    operation seen returning an argument's storage, as ``_unsafe_view``
    does, is never kept)."""

    def __init__(self):
        self.results: Dict[tuple, list] = {}
        self.aliasing = set()

    def run(self, func, args, kwargs):
        """(``func(*args, **kwargs)``, its entry or None); an entry's
        last slot holds the operation's cost once counted."""
        flat = _flat((args, kwargs), [])
        tensors = [x for x in flat if isinstance(x, torch.Tensor)]
        if (not tensors or func in self.aliasing
                or any(t.device.type != "meta" for t in tensors)
                or not _fresh_outputs(func)):
            return func(*args, **kwargs), None
        key = (func, len(args), tuple(kwargs), tuple(map(_leaf_key, flat)))
        hit = self.results.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            outs, spec = tree_flatten(out)
            held = {st._cdata for st in map(_storage, tensors)
                    if st is not None}
            taken = set(held)
            if all(isinstance(t, torch.Tensor) and _own_storage(t, taken)
                   for t in outs):
                hit = self.results[key] = [spec, [
                    (tuple(t.shape), t.stride(), t.dtype) for t in outs],
                    None]
            elif any(st is not None and st._cdata in held
                     for st in map(_storage, _tensors(outs))):
                self.aliasing.add(func)
            return out, hit
        spec, metas, _ = hit
        return tree_unflatten([torch.empty_strided(shape, stride, dtype=dt,
                                                   device="meta")
                               for shape, stride, dt in metas], spec), hit


class _Counter(TorchDispatchMode):
    def __init__(self, report: CostReport,
                 live: Optional[_LiveBytes] = None,
                 memo: Optional[_MetaMemo] = None):
        super().__init__()
        self.report = report
        self.live = live
        self.memo = memo

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if work.inside_collective() and func.namespace != "c10d":
            return func(*args, **kwargs)     # the backend's own copies
        if self.memo is None:
            out, memo = func(*args, **kwargs), None
        else:
            out, memo = self.memo.run(func, args, kwargs)
        inside = work.inside_kernel()
        if not inside and not _one_rank(func, args):
            if memo is not None and memo[2] is not None:
                key, flops, nbytes, dot = memo[2]
            else:
                key, flops, nbytes, dot = op_cost(func, args, kwargs, out)
                if memo is not None:
                    memo[2] = (key, flops, nbytes, dot)
            if dot:
                self.report.dot_flops += flops
            self.report._add(key, flops, nbytes)
            coll = collective_op(func, args)
            if coll is not None:
                self.report.collectives.append(coll)
        if self.live is not None:
            self.live.see(_tensors(out), inside)
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


def count_cost_and_peak(fn, *args, **kwargs
                        ) -> Tuple[object, CostReport, MemoryReport]:
    """:func:`count_cost` that also follows the bytes the call allocates
    (see the module's notes): returns (its result, the
    :class:`CostReport`, the :class:`MemoryReport`). The arguments are
    every tensor in ``args`` and ``kwargs``."""
    report = CostReport()
    arguments = _tensors((args, kwargs))
    live = _LiveBytes(arguments)
    memo = (_MetaMemo() if any(t.device.type == "meta" for t in arguments)
            else None)
    work._COUNTERS.append(report)
    try:
        with _Counter(report, live, memo):
            result = fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    finally:
        work._COUNTERS.remove(report)
    live.flush()
    mem = MemoryReport(argument_bytes=float(live.argument_bytes),
                       live_peak_bytes=float(live.peak))
    seen = set()
    for t in _tensors(result):
        st = _storage(t)
        if st is None or st._cdata in seen:
            continue
        seen.add(st._cdata)
        mem.output_bytes += st.nbytes()
        if st._cdata in live.known:
            mem.alias_bytes += st.nbytes()
    return result, report, mem


def top_consumers(report: CostReport, n: int = 10,
                  by: str = "flops") -> List[Tuple[float, str]]:
    """The largest contributors by aten operation (and hand-written
    kernel, ``kernel:<name>``): [(value, key)], by ``flops`` or
    ``bytes``."""
    table = report.flops_by_op if by == "flops" else report.bytes_by_op
    return sorted(((v, k) for k, v in table.items()), reverse=True)[:n]
