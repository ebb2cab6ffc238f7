"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch <id> [...]`` — request-level
serving with a static, continuous-batching or paged scheduler over a
synthetic Poisson request stream, on the CUDA device.

    --scheduler paged --page-size 16 --prefill-chunk 64 --num-requests 8

prints per-request TTFT / per-token latency percentiles, goodput and slot
occupancy, plus page occupancy and fragmentation for the paged scheduler.
The flags are those of ``repro.launch.serve`` for what this slice of the
port supports, plus ``--full`` (full-size architecture instead of the
reduced one the reference launcher always serves). Prefill attention runs
through kernel K1, the ssm and hybrid families' prefill linear attention
through kernel B6, paged decode attention (dense family only, as in the
reference) through kernel K2 and every RMSNorm through kernel K3.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import synth_requests
from repro_torch.models import Runtime, build, resolve_device
from repro_torch.serving import make_engine


def build_engine(arch: str, *, batch: int, prompt_len: int,
                 max_new_tokens: int, scheduler: str = "continuous",
                 use_reduced: bool = True, reduce_kw=None,
                 greedy: bool = True, eos_id=None, seed: int = 0,
                 clock=None, page_size: int = 16, num_pages=None,
                 prefill_chunk_tokens: int = 0, params=None,
                 device="cuda"):
    """Build a serving engine for ``arch`` (the launcher's plumbing,
    importable so tests and ``chip_smoke.py`` share it). Parameters are
    f32, as in the reference launcher. ``params`` is an existing
    parameter tree — numpy arrays (e.g. a JAX engine's, through
    :func:`repro_torch.bridge.params_from_jax`) or tensors — instead of a
    fresh random init from ``seed``. Returns (engine, cfg)."""
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
                  greedy=greedy, seed=seed, clock=clock, device=device)
    if scheduler == "paged":
        engine = make_engine(
            scheduler, model.prefill_chunk, model.decode_step_paged, params,
            model.paged_cache_init, page_size=page_size,
            num_pages=num_pages, prefill_chunk_tokens=prefill_chunk_tokens,
            **common)
    else:
        engine = make_engine(scheduler, model.prefill, model.decode_step,
                             params, model.cache_init, **common)
    return engine, cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4,
                    help="KV slots (continuous/paged) / batch size (static)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--scheduler", choices=("static", "continuous", "paged"),
                    default="continuous")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV tokens per page (paged scheduler)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="total KV pool pages incl. the null page "
                         "(0 = match the monolithic slots*span budget)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill tokens per chunk (0 = one shot)")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--offered-load", type=float, default=0.0,
                    help="Poisson arrival rate in req/s (0 = burst at t=0)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="EOS token id for early termination (<0 disables)")
    ap.add_argument("--sample", action="store_true",
                    help="sample tokens instead of greedy argmax")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="serve the full-size architecture (default: the "
                         "reduced config the reference launcher serves)")
    args = ap.parse_args(argv)

    engine, cfg = build_engine(
        args.arch, batch=args.batch, prompt_len=args.prompt_len,
        max_new_tokens=args.max_new_tokens, scheduler=args.scheduler,
        use_reduced=not args.full, greedy=not args.sample,
        eos_id=args.eos_id if args.eos_id >= 0 else None, seed=args.seed,
        page_size=args.page_size, num_pages=args.num_pages or None,
        prefill_chunk_tokens=args.prefill_chunk)
    requests = synth_requests(cfg, args.num_requests, args.prompt_len,
                              max_new_tokens=args.max_new_tokens,
                              rate_per_s=args.offered_load, seed=args.seed)
    engine.warmup(args.prompt_len)
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
    return report


if __name__ == "__main__":
    main()
