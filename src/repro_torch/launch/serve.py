"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch <id> [...]`` — request-level
serving with a static, continuous-batching, paged or P/D-disaggregated
scheduler over a synthetic Poisson request stream, on the CUDA device.

    --scheduler paged --page-size 16 --prefill-chunk 64 --num-requests 8

prints per-request TTFT / per-token latency percentiles, goodput and slot
occupancy, plus page occupancy and fragmentation for the paged schedulers.

For the paged scheduler, ``--prefix-cache`` turns on the prefix-sharing
radix cache, and ``--num-sessions N --turns T`` swaps the Poisson request
stream for a multi-turn session-replay workload (each turn arrives with
its accumulated history). ``--scheduler disaggregated`` runs the paged
model path under separate prefill and decode worker pools over one shared
page pool (``--prefill-workers N --decode-workers M``); the report gains
per-role utilization, handoff latency percentiles and decode stalls.

SLO / robustness knobs: ``--deadline S`` gives every request a finish-by
budget (missed = outcome ``timed_out``); ``--priority-mix "0:3,5:1"``
assigns priorities by weight (higher preempts lower in the paged
engine); ``--fault-plan default|plan.json`` runs the paged or
disaggregated engine under a deterministic fault-injection schedule
(:mod:`repro_torch.serving.faults`).

The flags are those of ``repro.launch.serve``, plus ``--full`` (the
full-size architecture instead of the reduced one the reference launcher
always serves). Prefill attention runs through kernel K1, the ssm and
hybrid families' prefill linear attention through kernel B6, paged decode
attention (dense family only, as in the reference) through kernel K2 and
every RMSNorm through kernel K3.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import synth_requests, synth_sessions
from repro_torch.models import Runtime, build, resolve_device
from repro_torch.serving import make_engine, resolve_fault_plan


def apply_slo(requests, *, deadline_s: float = 0.0,
              priority_mix: str = "", seed: int = 0):
    """Decorate a workload with SLO fields: a uniform per-request
    deadline (0 = none) and priorities drawn from a weighted mix
    ``"prio:weight,prio:weight"`` (e.g. ``"0:3,5:1"`` = a quarter of
    requests at priority 5). Deterministic in ``seed``; returns the same
    Request objects, mutated in place."""
    if deadline_s > 0:
        for r in requests:
            r.deadline_s = deadline_s
    if priority_mix:
        pairs = [p.split(":") for p in priority_mix.split(",")]
        prios = np.array([int(p) for p, _ in pairs])
        w = np.array([float(x) for _, x in pairs])
        rng = np.random.default_rng(seed)
        draw = rng.choice(len(prios), size=len(requests), p=w / w.sum())
        for r, i in zip(requests, draw):
            r.priority = int(prios[i])
    return requests


def build_engine(arch: str, *, batch: int, prompt_len: int,
                 max_new_tokens: int, scheduler: str = "continuous",
                 use_reduced: bool = True, reduce_kw=None,
                 greedy: bool = True, eos_id=None, seed: int = 0,
                 clock=None, page_size: int = 16, num_pages=None,
                 prefill_chunk_tokens: int = 0,
                 prefix_cache: bool = False, fault_plan=None,
                 reject_invalid: bool = False,
                 prefill_workers: int = 1, decode_workers: int = 1,
                 params=None, device="cuda"):
    """Build a serving engine for ``arch`` (the launcher's plumbing,
    importable so benchmarks, tests and ``chip_smoke.py`` share it).
    Parameters are f32, as in the reference launcher. ``params`` is an
    existing parameter tree — numpy arrays (e.g. a JAX engine's, through
    :func:`repro_torch.bridge.params_from_jax`) or tensors, which are
    shared, not copied — instead of a fresh random init from ``seed``.
    For ``scheduler="paged"`` or ``"disaggregated"`` the engine is wired
    to the model's paged triple and ``page_size``/``num_pages``/
    ``prefill_chunk_tokens``/``prefix_cache``/``fault_plan`` apply (and
    the worker counts for the disaggregated one). Returns (engine,
    cfg)."""
    cfg = get_arch(arch)
    if use_reduced:
        cfg = reduced(cfg, **(reduce_kw or {}))
    device = resolve_device(device)
    span = prompt_len + max_new_tokens
    model = build(cfg, Runtime(attention_backend="kernel"),
                  param_dtype=torch.float32, device=device)
    if params is None:
        params = model.init_params(
            torch.Generator(device=device).manual_seed(seed))
    else:
        params = params_from_jax(params, device)
    common = dict(slots=batch, cache_span=span, eos_id=eos_id,
                  greedy=greedy, seed=seed, clock=clock,
                  reject_invalid=reject_invalid, device=device)
    if scheduler in ("paged", "disaggregated"):
        paged_kw = dict(page_size=page_size, num_pages=num_pages,
                        prefill_chunk_tokens=prefill_chunk_tokens,
                        prefix_cache=prefix_cache, fault_plan=fault_plan)
        if scheduler == "disaggregated":
            paged_kw.update(prefill_workers=prefill_workers,
                            decode_workers=decode_workers)
        engine = make_engine(
            scheduler, model.prefill_chunk, model.decode_step_paged, params,
            model.paged_cache_init, **paged_kw, **common)
    else:
        engine = make_engine(scheduler, model.prefill, model.decode_step,
                             params, model.cache_init, **common)
    return engine, cfg


def parse_args(argv=None):
    """The launcher's flags. Returns (args, the resolved fault plan);
    refuses a fault plan for the static and continuous schedulers, as the
    reference launcher does."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4,
                    help="KV slots (continuous/paged) / batch size (static)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--scheduler",
                    choices=("static", "continuous", "paged",
                             "disaggregated"),
                    default="continuous")
    ap.add_argument("--prefill-workers", type=int, default=1,
                    help="prefill worker pool size (disaggregated "
                         "scheduler)")
    ap.add_argument("--decode-workers", type=int, default=1,
                    help="decode worker pool size (disaggregated "
                         "scheduler); must divide --batch")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV tokens per page (paged scheduler)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="total KV pool pages incl. the null page "
                         "(0 = match the monolithic slots*span budget)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill tokens per chunk (0 = one shot)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="prefix-sharing radix cache (paged scheduler)")
    ap.add_argument("--num-sessions", type=int, default=0,
                    help="multi-turn session-replay workload: number of "
                         "chat sessions (0 = plain Poisson requests)")
    ap.add_argument("--turns", type=int, default=3,
                    help="turns per session (with --num-sessions); each "
                         "turn replays the accumulated history")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--offered-load", type=float, default=0.0,
                    help="Poisson arrival rate in req/s (0 = burst at t=0)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request finish-by budget in seconds from "
                         "arrival (0 = no deadline); missed deadlines "
                         "are reaped with outcome timed_out")
    ap.add_argument("--priority-mix", default="",
                    help="weighted priority classes as 'prio:weight,...' "
                         "e.g. '0:3,5:1'; higher priority preempts lower "
                         "under page pressure (paged scheduler)")
    ap.add_argument("--fault-plan", default="none",
                    help="'none', 'default' (the seeded standard chaos "
                         "mix), or a FaultPlan JSON path; paged/"
                         "disaggregated schedulers only")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="EOS token id for early termination (<0 disables)")
    ap.add_argument("--sample", action="store_true",
                    help="sample tokens instead of greedy argmax")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="serve the full-size architecture (default: the "
                         "reduced config the reference launcher serves)")
    args = ap.parse_args(argv)
    fault_plan = resolve_fault_plan(args.fault_plan, args.seed)
    if (fault_plan is not None
            and args.scheduler not in ("paged", "disaggregated")):
        ap.error("--fault-plan requires --scheduler paged or disaggregated")
    return args, fault_plan


def main(argv=None):
    args, fault_plan = parse_args(argv)
    # session replay grows each turn's prompt by its history; size the
    # span (and block tables) for the longest final-turn prompt
    session_prompt_len = 32 + args.turns * 16    # synth_sessions defaults
    prompt_len = (session_prompt_len if args.num_sessions
                  else args.prompt_len)
    engine, cfg = build_engine(
        args.arch, batch=args.batch, prompt_len=prompt_len,
        max_new_tokens=args.max_new_tokens, scheduler=args.scheduler,
        use_reduced=not args.full, greedy=not args.sample,
        eos_id=args.eos_id if args.eos_id >= 0 else None, seed=args.seed,
        page_size=args.page_size, num_pages=args.num_pages or None,
        prefill_chunk_tokens=args.prefill_chunk,
        prefix_cache=args.prefix_cache, fault_plan=fault_plan,
        prefill_workers=args.prefill_workers,
        decode_workers=args.decode_workers)
    if args.num_sessions:
        requests = synth_sessions(cfg, args.num_sessions, args.turns,
                                  max_new_tokens=args.max_new_tokens,
                                  rate_per_s=args.offered_load,
                                  seed=args.seed)
    else:
        requests = synth_requests(cfg, args.num_requests, args.prompt_len,
                                  max_new_tokens=args.max_new_tokens,
                                  rate_per_s=args.offered_load,
                                  seed=args.seed)
    apply_slo(requests, deadline_s=args.deadline,
              priority_mix=args.priority_mix, seed=args.seed)
    engine.warmup(prompt_len)
    report = engine.run(requests)
    s = report.summary()
    print(f"[{s['scheduler']}] {s['completed']}/{len(requests)} requests, "
          f"{s['total_new_tokens']} tokens in {s['makespan_s']:.3f}s  "
          f"goodput={s['goodput_rps']:.2f} req/s "
          f"({s['goodput_tps']:.1f} tok/s) on "
          f"{torch.cuda.get_device_name(engine.device)}")
    print(f"  ttft p50={s['ttft_p50_s'] * 1e3:.1f}ms "
          f"p95={s['ttft_p95_s'] * 1e3:.1f}ms  "
          f"tok p50={s['tok_p50_s'] * 1e3:.2f}ms "
          f"p95={s['tok_p95_s'] * 1e3:.2f}ms")
    print(f"  decode_steps={s['decode_steps']} prefills={s['prefills']} "
          f"occupancy={s['occupancy']:.2f} "
          f"slot_balance={s['slot_balance']:.2f}")
    if s.get("num_pages"):
        print(f"  pages={s['num_pages']}x{s['page_size']}tok "
              f"page_occ={s['page_occupancy_mean']:.2f} "
              f"(peak {s['page_occupancy_peak']:.2f}) "
              f"frag={s['fragmentation_mean']:.2f} "
              f"peak_concurrency={s['peak_concurrency']}")
    if (args.deadline > 0 or args.priority_mix
            or s.get("faults_injected")):
        print(f"  outcomes: timed_out={s['n_timed_out']} "
              f"preempted={s['n_preempted']} rejected={s['n_rejected']} "
              f"failed={s['n_failed']}  "
              f"preemptions={s['preemption_events']} "
              f"requeues={s['requeues']} retries={s['retries']}")
    if s.get("faults_injected"):
        print(f"  faults: injected={s['faults_injected']} "
              f"recovered={s['fault_recoveries']} "
              f"recovery_steps mean={s['recovery_steps_mean']:.1f} "
              f"max={s['recovery_steps_max']}  "
              f"pages_leaked={s['pages_leaked']}")
    if s.get("prefill_workers"):
        print(f"  roles: prefill_workers={s['prefill_workers']} "
              f"(util {s['prefill_util']:.2f}) "
              f"decode_workers={s['decode_workers']} "
              f"(util {s['decode_util']:.2f})  "
              f"handoffs={s['handoffs']} "
              f"handoff p50={s['handoff_p50_s'] * 1e3:.2f}ms "
              f"p95={s['handoff_p95_s'] * 1e3:.2f}ms  "
              f"queue_depth peak={s['queue_depth_peak']} "
              f"mean={s['queue_depth_mean']:.1f}")
    if s.get("prefix_lookups") is not None:
        print(f"  prefix hit_rate={s['prefix_hit_rate']:.2f} "
              f"({s['prefix_hits']}/{s['prefix_lookups']}) "
              f"saved={s['prefill_tokens_saved']}tok "
              f"shared_peak={s['pages_shared_peak']} "
              f"evictions={s['prefix_evictions']} "
              f"ttft warm_p50={s['ttft_warm_p50_s'] * 1e3:.1f}ms "
              f"cold_p50={s['ttft_cold_p50_s'] * 1e3:.1f}ms")
    return report


if __name__ == "__main__":
    main()
