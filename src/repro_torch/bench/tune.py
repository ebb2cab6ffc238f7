"""Launch-parameter tuner: sweep the port's open launch parameters,
persist the winners.

The port of ``repro/bench/tune.py``. For each (kernel, shape signature)
it

1. enumerates the candidates of the kernel's one open parameter (K2's
   split count, B6's V slice, K3's threads a row;
   :mod:`repro_torch.kernels.tuning`), the heuristic's pick first;
2. rejects those the launch-contract lint refuses at the shape
   (:func:`repro_torch.analysis.kernel_lint.check_config`: shared memory
   over the card's limit, a cluster over 8), counted as ``rejected_smem``;
3. times the survivors with the harness timer (``timeit_us``, which a
   test swaps for a fake: the timed closure carries its config in
   ``fn.keywords``);
4. keeps the fastest and persists it through
   :func:`repro_torch.kernels.tuning.save_entries` to
   ``results/tuned/cuda.json``.

The heuristic's pick is candidate 0 and ties resolve to the earliest
candidate, so a tuned value never regresses the default on the swept
shape. A default the shape rejects is skipped, not mislabeled: the result
reports a neutral speedup of 1.0 with ``default_timed=False``. Every
candidate is a legal launch, so none raises.

The attention tiles are compiled in (``csrc/flash_attention*.cu``), so
the reference's ``tune_flash_attention`` and ``tune_flash_attention_bwd``
have no counterpart. Run the sweeps through the harness: ``python -m
repro_torch.bench --tune`` (:mod:`repro_torch.bench.suites.tune`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.bench.runner import timeit_us
from repro_torch.kernels import tuning

PAGED_SPLITS = (1, 2, 4, 8)
WKV_V_SLICES = tuning.WKV_V_SLICES
NORM_THREADS = (32, 64, 128, 256, 512)

Candidates = Tuple[List[Dict[str, int]], int, Optional[Dict[str, int]]]


def _legal(kernel: str, dims: Dict[str, Any], cfg: Dict[str, int]) -> bool:
    from repro_torch.analysis import kernel_lint
    return not kernel_lint.check_config(kernel, dims, cfg, static_smem={})


def _candidates(kernel: str, dims: Dict[str, Any], values,
                default: int) -> Candidates:
    """(the legal candidates, the heuristic's pick first; how many the
    lint rejected; the default's config, or None where it is rejected)."""
    param = tuning.PARAMS[kernel]
    dflt = {param: default}
    out, rejected = [], 0
    for v in dict.fromkeys(values):
        cfg = {param: v}
        if not _legal(kernel, dims, cfg):
            rejected += 1
            continue
        if cfg != dflt:
            out.append(cfg)
    default_ok = default > 0 and _legal(kernel, dims, dflt)
    if default_ok:
        out.insert(0, dflt)
    return out, rejected, (dflt if default_ok else None)


def paged_candidates(B: int, Hq: int, Hkv: int, D: int, P: int, ps: int,
                     npag: int, dtype="float32") -> Candidates:
    """K2's split counts 1, 2, 4, 8, clamped to the table's pages."""
    dims = dict(B=B, Hq=Hq, Hkv=Hkv, D=D, P=P, ps=ps, npag=npag,
                dtype=tuning._dtype_name(dtype))
    return _candidates("paged_attention_fwd", dims,
                       [min(s, npag) for s in PAGED_SPLITS],
                       tuning.default_splits(B, Hq, Hkv, D, npag))


def wkv6_candidates(B: int, T: int, H: int, K: int, V: int,
                    dtype="float32", ld_dtype="float32") -> Candidates:
    """B6's V slices 16, 32, 64 whose layout fits a block's shared
    memory (the mirrored ``make_layout``)."""
    dims = dict(B=B, T=T, H=H, K=K, V=V, dtype=tuning._dtype_name(dtype),
                ld=tuning._dtype_name(ld_dtype))
    return _candidates("wkv6_fwd", dims, WKV_V_SLICES, tuning.default_v_slice(
        B, H, K, V, tuning.itemsize(dtype), tuning.itemsize(ld_dtype)))


def rmsnorm_candidates(rows: int, d: int, dtype="float32") -> Candidates:
    """K3's threads a row: whole warps from 32 to 512 (the kernel loops
    over whatever part of the row its registers do not hold, so each
    computes the whole row at any d)."""
    dims = dict(rows=rows, d=d, dtype=tuning._dtype_name(dtype))
    return _candidates("rmsnorm_fwd", dims, NORM_THREADS,
                       tuning.default_threads(d))


# ----------------------------------------------------------------- sweep
@dataclass
class TuneResult:
    """Winner of one (kernel, shape-signature) sweep."""

    kernel: str
    signature: str
    config: Dict[str, int]
    us: float                      # winner's measured time
    default_us: float              # default config's time
    # False when the default was rejected at the shape: default_us then
    # equals us (neutral speedup 1.0)
    default_timed: bool = True
    n_candidates: int = 0
    rejected_smem: int = 0
    timings: Dict[str, float] = field(default_factory=dict)

    @property
    def speedup(self) -> float:
        return self.default_us / self.us if self.us else 1.0

    def entry(self) -> Tuple[str, Dict[str, Any]]:
        return tuning.entry_key(self.kernel, self.signature), {
            "config": self.config, "us": float(self.us),
            "default_us": float(self.default_us)}


def _cfg_label(cfg: Dict[str, int]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(cfg.items()))


def _sweep(kernel: str, sig: str, candidates: Sequence[Dict[str, int]],
           rejected: int, default_cfg: Optional[Dict[str, int]],
           make_fn: Callable[..., Callable], args: tuple,
           timer: Callable, iters: int, warmup: int) -> TuneResult:
    """Time every candidate; earliest-fastest wins (default is first)."""
    if not candidates:
        raise ValueError(f"no valid launch candidates for {kernel} ({sig})")
    timings: Dict[str, float] = {}
    best_cfg: Optional[Dict[str, int]] = None
    best_us: Any = float("inf")
    for cfg in candidates:
        fn = make_fn(**cfg)
        # keep the timer's raw value: a TimingStats mean carries per-iter
        # percentiles that ride into the winner's BenchRecord
        us = timer(fn, *args, iters=iters, warmup=warmup)
        timings[_cfg_label(cfg)] = float(us)
        if us < best_us:
            best_cfg, best_us = cfg, us
    if default_cfg is not None:
        default_us, default_timed = timings[_cfg_label(default_cfg)], True
    else:
        # no usable default for this shape: report a neutral baseline
        default_us, default_timed = float(best_us), False
    return TuneResult(kernel=kernel, signature=sig, config=dict(best_cfg),
                      us=best_us, default_us=default_us,
                      default_timed=default_timed,
                      n_candidates=len(candidates), rejected_smem=rejected,
                      timings=timings)


def graph_timer(calls: int = 50) -> Callable:
    """A ``timeit_us`` timer for kernels of a few microseconds: on CUDA
    tensors it captures ``calls`` back-to-back calls in one CUDA graph and
    times its replay with ``timeit_us``, divided by ``calls``, so the
    host's cost per eager call (larger than such a kernel) stays out; on
    the CPU it is ``timeit_us`` itself."""
    def timer(fn, *args, iters: int = 5, warmup: int = 2):
        import torch

        from repro_torch.bench.runner import TimingStats
        if not any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            return timeit_us(fn, *args, iters=iters, warmup=warmup)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):        # warm-up off the capture
            for _ in range(max(warmup, 1)):
                fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn(*args)
        us = timeit_us(graph.replay, iters=iters, warmup=1)
        del graph
        return TimingStats([s / calls for s in us.samples])
    return timer


def tune_paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                         timer: Callable = timeit_us, iters: int = 2,
                         warmup: int = 1) -> TuneResult:
    """Sweep K2's split count."""
    from repro_torch.kernels import ops

    B, _, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    npag = block_tables.shape[1]
    sig = tuning.paged_attention_signature(q.shape, k_pages.shape, npag,
                                           q.dtype)
    cands, rej, dflt = paged_candidates(B, Hq, Hkv, D, P, ps, npag, q.dtype)

    def make_fn(splits: int):
        return functools.partial(ops.paged_attention, splits=splits)

    return _sweep("paged_attention_fwd", sig, cands, rej, dflt, make_fn,
                  (q, k_pages, v_pages, block_tables, lengths), timer,
                  iters, warmup)


def tune_wkv6(q, k, v, ld, u=None, *, timer: Callable = timeit_us,
              iters: int = 2, warmup: int = 1) -> TuneResult:
    """Sweep B6's V slice."""
    from repro_torch.kernels import ops

    B, T, H, K = q.shape
    V = v.shape[-1]
    sig = tuning.wkv6_signature(q.shape, V, q.dtype, use_u=u is not None,
                                ld_dtype=ld.dtype)
    cands, rej, dflt = wkv6_candidates(B, T, H, K, V, q.dtype, ld.dtype)

    def make_fn(v_slice: int):
        return functools.partial(ops.wkv6, v_slice=v_slice)

    return _sweep("wkv6_fwd", sig, cands, rej, dflt, make_fn,
                  (q, k, v, ld, u), timer, iters, warmup)


def tune_rmsnorm(x, scale, *, timer: Callable = timeit_us, iters: int = 3,
                 warmup: int = 1) -> TuneResult:
    """Sweep K3's threads a row."""
    from repro_torch.kernels import ops

    d = x.shape[-1]
    rows = x.numel() // max(d, 1)
    sig = tuning.rmsnorm_signature(rows, d, x.dtype)
    cands, rej, dflt = rmsnorm_candidates(rows, d, x.dtype)

    def make_fn(threads: int):
        return functools.partial(ops.rmsnorm, threads=threads)

    return _sweep("rmsnorm_fwd", sig, cands, rej, dflt, make_fn,
                  (x, scale), timer, iters, warmup)


def save(results: Sequence[TuneResult]):
    """Persist winners to the tuned cache; returns the path."""
    entries = dict(r.entry() for r in results)
    return tuning.save_entries(entries)
