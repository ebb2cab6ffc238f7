"""Dispatch audit of the step functions: the port's counterpart of the
reference's jaxpr and HLO audit (``repro/analysis/graph_audit.py``).

The port runs eager, so there is no traced graph to walk and no graph
break to find: the audit runs each step once under a
``TorchDispatchMode`` (as :func:`repro_torch.core.cost.count_cost` does)
and reads every aten operation the step dispatches. Each step is called
once first, as the reference's jitted steps are compiled before they
run, so lazily made constants (the rotary frequencies) are in place. The
steps are the tiny reduced granite-3-8b's (2 layers, d_model 64):
``runtime/steps.py::build_train_step``'s train step,
``build_decode_step``'s decode step, and the paged engine's chunked
prefill (the model's ``prefill_chunk``) and its decode step
(``PagedEngine._pool_step``). Rules:

* **RG001** a host read inside a step: ``aten::_local_scalar_dense``, from
  ``.item()``, ``bool(t)`` or ``float(t)``. The train step makes one on
  purpose, its loss-spike guard (a step whose loss is not finite skips
  its update, which the reference's loop decides after its jitted step),
  declared in :data:`HOST_READS`; any more is a finding. A host read that
  does not pass through the dispatcher on the CPU (``.tolist()``,
  ``.cpu()`` of a CPU tensor) is caught on the card as RG005;
* **RG002** a float64 or complex128 value, in or out of any operation;
* **RG003** on identical runs of a warm paged engine, the kernel library
  is built or loaded anew, or a kernel's launch count (``ops.LAUNCHES``)
  or the engine's dispatched operations (views aside) grow by other than
  what the run before added (the counterpart of a jitted helper's compile cache
  growing);
* **RG004** a ``c10d`` operation in a one-device step
  (:func:`repro_torch.core.cost.collective_op` names those it counts);
* **RG005** a copy between the host and the device inside a step (an
  ``aten`` copy whose source and destination devices differ). On the CPU
  nothing is on a device, so this rule only fires on the card.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .findings import Finding

_BAD_DTYPES = (torch.float64, torch.complex128)
_HOST_READ = "aten._local_scalar_dense"
# a step's deliberate host reads: the train step's loss-spike guard
# (runtime/steps.py: "if not torch.isfinite(loss)")
HOST_READS = {"train_step": 1}
STEPS_PATH = "src/repro_torch/runtime/steps.py"
PAGED_PATH = "src/repro_torch/serving/paged.py"
TINY = dict(layers=2, d_model=64, vocab=128, d_ff=128)


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


class _Audit(TorchDispatchMode):
    """Counts a call's operations (views aside: PyTorch makes some, such as
    ``detach``, from caches whose state depends on the process's history)
    and notes what the rules read."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        self.host_reads = 0
        self.f64: Counter = Counter()
        self.collectives: Counter = Counter()
        self.transfers: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = f"{func.namespace}.{func.overloadpacket.__name__}"
        if not func.is_view:    # a view (detach, alias) only relabels data
            self.ops[name] += 1
        if name == _HOST_READ:
            self.host_reads += 1
        if func.namespace == "c10d":
            self.collectives[name] += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(t.dtype in _BAD_DTYPES for t in ins + outs):
            self.f64[name] += 1
        devices = {t.device.type for t in ins + outs} - {"meta"}
        if ("copy" in name or name == _HOST_READ) and len(devices) > 1:
            self.transfers[name] += 1
        return out


def audit_function(name: str, fn: Callable, *args, path: str = "<step>",
                   host_reads: Optional[int] = None, warm: bool = True,
                   **kwargs) -> List[Finding]:
    """Run ``fn(*args, **kwargs)`` (after one warm-up call, unless
    ``warm`` is false) under the audit; RG001, RG002, RG004 and RG005."""
    if warm:
        fn(*args, **kwargs)
    audit = _Audit()
    with audit:
        fn(*args, **kwargs)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return findings_of(name, audit, path, host_reads)


def findings_of(name: str, audit: _Audit, path: str,
                host_reads: Optional[int] = None) -> List[Finding]:
    allowed = HOST_READS.get(name, 0) if host_reads is None else host_reads
    out: List[Finding] = []
    if audit.host_reads > allowed:
        out.append(Finding(
            "RG001", path, 0,
            f"{name}: {audit.host_reads} host read(s) "
            f"(`_local_scalar_dense`: .item(), bool(t)) where {allowed} "
            "is declared; each blocks the host on the device"))
    for op, n in sorted(audit.f64.items()):
        out.append(Finding(
            "RG002", path, 0,
            f"{name}: float64/complex128 values through `{op}` ({n}x): "
            "double the bytes of every op they touch"))
    if audit.collectives:
        out.append(Finding(
            "RG004", path, 0,
            f"{name}: one-device step issues collectives "
            f"{dict(sorted(audit.collectives.items()))}"))
    for op, n in sorted(audit.transfers.items()):
        out.append(Finding(
            "RG005", path, 0,
            f"{name}: `{op}` copies between host and device inside the "
            f"step ({n}x)"))
    return out


# ------------------------------------------------------------ repo targets
def _device(device) -> torch.device:
    """``device`` (default: the card where there is one), with a card's
    index made explicit, as the models and their generators compare it."""
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _run_config(kind: str, vocab: int):
    from repro_torch.configs import (ARCHS, MeshConfig, RunConfig,
                                     ShapeConfig, reduced)
    cfg = reduced(ARCHS["granite-3-8b"], **{**TINY, "vocab": vocab})
    shape = (ShapeConfig("t", "train", 32, 2) if kind == "train"
             else ShapeConfig("serve", "decode", 32, 2))
    return RunConfig(model=cfg, shape=shape,
                     mesh=MeshConfig(shape=(1, 1), axes=("data", "model")),
                     param_dtype="float32", attention_backend="kernel",
                     learning_rate=1e-3, warmup_steps=2)


def audit_train_step(device=None) -> List[Finding]:
    """The tiny granite's train step (params, AdamW state, a batch)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.steps import build_train_step

    dev = _device(device)
    rcfg = _run_config("train", 256)
    step, model, opt = build_train_step(rcfg, total_steps=8, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    opt_state = opt.init(params)
    batch = SyntheticLM(rcfg.model, 2, 32, seed=0,
                        device=str(dev)).batch_at(0)
    return audit_function("train_step", step, params, opt_state, batch,
                          path=STEPS_PATH)


def audit_decode_step(device=None) -> List[Finding]:
    """The tiny granite's decode step over its monolithic cache."""
    from repro_torch.runtime.steps import build_decode_step

    dev = _device(device)
    decode, model = build_decode_step(_run_config("decode", 128), device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    caches = model.cache_init(2, 32)
    tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((2,), dtype=torch.int32, device=dev)
    return audit_function("decode_step", decode, params, caches, tok, pos,
                          path=STEPS_PATH)


def tiny_engine(device=None):
    """The tiny granite's paged engine on a Sim clock (8-token pages, a
    32-page pool): (engine, cfg)."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.request import SimClock

    return build_engine("granite-3-8b", batch=2, prompt_len=16,
                        max_new_tokens=8, scheduler="paged", reduce_kw=TINY,
                        clock=SimClock(), page_size=8, num_pages=32,
                        device=_device(device))


def tiny_requests(n: int = 3, prompt_len: int = 16, new_tokens: int = 6):
    import numpy as np

    from repro_torch.serving.request import Request

    rng = np.random.default_rng(0)
    return [Request(rid=i, arrival_s=0.0,
                    prompt=rng.integers(1, 100, size=prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=new_tokens) for i in range(n)]


def audit_paged_steps(device=None) -> List[Finding]:
    """The paged engine's chunked prefill (the model's ``prefill_chunk``)
    and its decode step (``PagedEngine._pool_step``), each on the
    device-resident inputs the engine passes them: a 16-token prompt on
    pages 1-2, then both lanes live at position 16."""
    from repro_torch.serving.roles import lane_state

    dev = _device(device)
    engine, _ = tiny_engine(dev)
    caches = engine.cache_init(engine.num_pages, engine.page_size)
    btab = torch.arange(1, 3, dtype=torch.int32, device=dev)[None]
    chunk = torch.arange(1, 17, dtype=torch.int32, device=dev)[None]

    def prefill():
        return engine._prefill_fn(engine.params, caches, chunk, btab, 0)

    findings = audit_function("prefill_chunk", prefill, path=PAGED_PATH)
    B = engine.slots
    state = lane_state(B, engine.cache_span, dev, engine.npag_max)
    state["active"].fill_(True)
    state["pos"].fill_(16)
    state["ncount"].fill_(1)
    state["budget"].fill_(6)
    state["btab"][:, :3] = torch.arange(
        1, 3 * B + 1, dtype=torch.int32, device=dev).reshape(B, 3)

    def pool_step():
        return engine._pool_step(engine.params, caches, state, None)

    findings += audit_function("pool_step", pool_step, path=PAGED_PATH)
    return findings


def audit_engine_steady_state(device=None,
                              path: str = PAGED_PATH) -> List[Finding]:
    """RG003: the same workload through one paged engine, once to warm it
    (the kernel library's build and load, the lazily made constants: what
    compiling is to the reference's jitted helpers), then twice more; the
    third run builds and loads no kernel library, and adds to each
    kernel's launches and to the engine's dispatched operations exactly
    what the second did."""
    from repro_torch.kernels import _build, ops

    engine, _ = tiny_engine(device)
    engine.run(tiny_requests())
    deltas = []
    for _ in range(2):
        builds = dict(_build.BUILDS)
        launches = dict(ops.LAUNCHES)
        audit = _Audit()
        with audit:
            engine.run(tiny_requests())
        deltas.append((
            {k: _build.BUILDS[k] - builds[k] for k in builds},
            {k: ops.LAUNCHES[k] - launches[k] for k in launches},
            audit.ops))
    (_, first_launch, first_ops), (second_build, second_launch,
                                   second_ops) = deltas
    findings: List[Finding] = []
    if any(second_build.values()):
        findings.append(Finding(
            "RG003", path, 0,
            f"PagedEngine.run: the kernel library was built or loaded on an "
            f"identical second run ({second_build})"))
    if second_launch != first_launch:
        grew = {k: (first_launch[k], second_launch[k]) for k in first_launch
                if first_launch[k] != second_launch[k]}
        findings.append(Finding(
            "RG003", path, 0,
            f"PagedEngine.run: kernel launches (first, second run) differ "
            f"on an identical second run: {grew}"))
    if second_ops != first_ops:
        diff = {op: (first_ops[op], second_ops[op])
                for op in sorted(set(first_ops) | set(second_ops))
                if first_ops[op] != second_ops[op]}
        findings.append(Finding(
            "RG003", path, 0,
            f"PagedEngine.run: {sum(first_ops.values())} dispatched "
            f"operations on one run, {sum(second_ops.values())} on an "
            f"identical next one; (one, next) by operation: {diff}"))
    return findings


def audit_all(include_steady_state: bool = True,
              device=None) -> List[Finding]:
    findings = (audit_train_step(device) + audit_decode_step(device)
                + audit_paged_steps(device))
    if include_steady_state:
        findings += audit_engine_steady_state(device)
    return findings
