"""The driver of a serving mix (``"kind": "serve"``): an open loop.

Set-up builds the program's engine over the benchmark's weights and warms
it on the mix's own shapes: every lane busy at once, the longest prompt
the mix sends and prompts of one partial prefill chunk. The window offers
the mix's requests at their due times over ``--seconds`` (the engine's own
clock starts with the run) and waits until every one has finished:
``ttft_p80_ms`` is the time to first token from when each request was
due, a request that failed counting as missing; ``tpot_p80_ms`` each
request's (last token - first token) / (tokens - 1), which holds the
stalls that prefill chunks put between decode steps. Through the window
:class:`Watch` keeps the program's own logits of a sample of requests
drawn from the seed before it opens. A traced run then profiles decode
steps of a replay of the window's first seconds (:func:`traced_replay`).
Last, with the engine's pools freed, the plain reference runs each sampled
request's prompt with its served tokens: the check reads how far the
program's logits lie from the reference's (``logit_err``) and how far
below the reference's best each served token's logit lies
(``logit_gap``).
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from cardbench import compare, program, weights
from cardbench import traffic as tr
from cardbench.harness import Outcome
from cardbench.reference import common
from cardbench.drivers.train import setup_note
from cardbench.trace import Tracer, span

KEY_TOKENS = 16


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def latencies(ms) -> dict:
    """The window's end-to-end readings from its requests' metrics, ms:
    every request's time to first token (a request that did not complete
    counts as missing, infinite) and every completed request's time per
    output token after the first."""
    ttft = [m.ttft_s if m.outcome == "completed" else math.inf for m in ms]
    tpot = [(m.finish_s - m.first_token_s) / (m.new_tokens - 1)
            for m in ms if m.outcome == "completed" and m.new_tokens > 1]
    return {"ttft_p80_ms": percentile(ttft, 80) * 1e3,
            "tpot_p80_ms": percentile(tpot, 80) * 1e3 if tpot
            else math.inf}


def warmup_arrivals(seed: int, t: dict, vocab: int) -> list:
    """One request a lane, all due at once: one prompt of the mix's
    longest, the others of its shortest (one partial prefill chunk); a
    few tokens each."""
    lanes = t["engine"]["slots"]
    g = tr.rng(seed, 4)
    lens = [t["prompt"]["max"]] + [t["prompt"]["min"]] * (lanes - 1)
    return [tr.Arrival(rid=i, prompt=tr.doc_tokens(g, vocab, n).astype(
        np.int32), max_new_tokens=3, arrival_s=0.0)
        for i, n in enumerate(lens)]


def plan(arrivals, seed: int, check: dict) -> list:
    """The requests whose logits the check compares, drawn before the
    window: the one of the most output tokens first, then others drawn
    from the seed, until ``min_tokens`` output tokens or ``max_requests``."""
    first = max(arrivals, key=lambda a: (a.max_new_tokens, -a.rid))
    rest = [arrivals[i] for i in tr.rng(seed, 5).permutation(len(arrivals))
            if arrivals[i].rid != first.rid]
    out, n = [], 0
    for a in [first] + rest:
        out.append(a.rid)
        n += a.max_new_tokens
        if n >= check["min_tokens"] or len(out) >= check["max_requests"]:
            break
    return out


class Watch:
    """The program's logits of the planned requests, read on the timed
    path through the engine's own calls: a request's prefill is known by
    its first tokens and its block table's first page, its last chunk's
    logits are those of its first token, and the decode steps' rows whose
    block table starts at that page are those of its later tokens. Only
    while a planned request is in a lane does a decode step read its
    block tables' first column and positions back to the host."""

    def __init__(self, arrivals, rids):
        self.want = {r: arrivals[r] for r in rids}
        self.by_key = {tuple(a.prompt[:KEY_TOKENS].tolist()): r
                       for r, a in self.want.items()}
        self.rows = {r: [] for r in rids}
        self.pos = {r: [] for r in rids}
        self.live = {}                  # rid -> its first page
        self.current = None             # (rid, first page) in prefill
        self.prefills = {r: 0 for r in rids}

    def on_prefill(self, fn, params, caches, tokens, btab, start):
        if int(start) == 0:
            head = torch.cat([tokens[0, :KEY_TOKENS].int(),
                              btab[0, :1].int()]).tolist()
            rid = self.by_key.get(tuple(head[:-1]))
            self.current = None if rid is None else (rid, head[-1])
            if rid is not None:
                self.prefills[rid] += 1
                self.rows[rid], self.pos[rid] = [], []
                self.live.pop(rid, None)
        out = fn(params, caches, tokens, btab, start)
        if self.current is not None:
            rid, page = self.current
            plen = len(self.want[rid].prompt)
            if int(start) + tokens.shape[1] == plen:
                self.rows[rid].append(out[0][0, -1].clone())
                self.pos[rid].append(plen - 1)
                self.current = None
                if self.want[rid].max_new_tokens > 1:
                    self.live[rid] = page
        return out

    def on_decode(self, fn, params, caches, tok, pos, btab):
        if not self.live:
            return fn(params, caches, tok, pos, btab)
        first, at = torch.stack([btab[:, 0].int(), pos.int()]).tolist()
        out = fn(params, caches, tok, pos, btab)
        for rid, page in list(self.live.items()):
            lanes = [i for i, f in enumerate(first) if f == page]
            if len(lanes) != 1:
                continue
            self.rows[rid].append(out[0][lanes[0], -1].clone())
            self.pos[rid].append(at[lanes[0]])
            if len(self.rows[rid]) >= self.want[rid].max_new_tokens:
                del self.live[rid]
        return out

    def served(self, report) -> list:
        """(prompt, served tokens, the program's logits (n, V), the rows
        of the reference's logits they stand beside) of each planned
        request that completed, prefilled once."""
        done = {m.rid: m for m in report.metrics
                if m.outcome == "completed"}
        out = []
        for rid, a in self.want.items():
            if rid not in done or self.prefills[rid] != 1:
                continue
            rows = torch.stack(self.rows[rid]).cpu()
            at = np.asarray(self.pos[rid]) - (len(a.prompt) - 1)
            out.append((a.prompt, np.asarray(done[rid].tokens), rows, at))
        return out


def setup(cell, seed: int, device):
    """The engine over the seed's weights, warmed on the mix's shapes.
    Returns it, the mix and when it was built."""
    c, t = cell.config, cell.traffic
    params = weights.make(c, seed, device)
    srv = program.Server(c, t, params, device, seed,
                         t["prompt"]["max"] + t["output"]["max"])
    built = time.perf_counter()
    srv.run(srv.requests(warmup_arrivals(seed, t, c["vocab_size"])))
    return srv, t, built


def window(srv, arrivals, seed: int, t: dict):
    """The timed window: every arrival offered at its due time, the
    planned requests' logits kept. Returns the report and the watch."""
    watch = Watch(arrivals, plan(arrivals, seed, t["check"]))
    srv.on_prefill, srv.on_decode = watch.on_prefill, watch.on_decode
    report = srv.run(srv.requests(arrivals))
    srv.on_prefill = srv.on_decode = None
    return report, watch


@torch.no_grad()
def reference_logits(params, c, prompt, tokens, device, mm):
    """The reference's logits at the positions that produced ``tokens``
    after ``prompt``: its forward over the prompt and the served tokens."""
    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int64)
    x = torch.from_numpy(seq).to(device)[None]
    h = common.hidden(params, x, c, mm, remat=False)[0, len(prompt) - 1:]
    return common.logits(params, h, c, mm)


def _worst(acc: dict, got: dict) -> dict:
    return {k: got[k] if math.isnan(v) else max(v, got[k])
            for k, v in acc.items()}


def check_numbers(c, served, seed: int, device, *, control=False) -> dict:
    """The compared numbers over the served requests, from the seed's
    weights made again: the reference reads nothing the program held. A
    request of which the watch kept fewer rows than it served tokens reads
    an infinite ``logit_err``. With ``control``, also the control's: the
    reference in TF32 in the program's place (its logits, and the tokens
    it puts first)."""
    params = weights.make(c, seed, device)
    common.fp32_only()
    f32, low = common.matmul_of("float32"), common.matmul_of("tf32")
    nums = {"logit_err": math.nan, "logit_gap": math.nan}
    ctl = dict(nums)
    for prompt, tok, rows, at in served:
        ref = reference_logits(params, c, prompt, tok, device, f32)
        got = {"logit_gap": compare.logit_gap(ref, tok),
               "logit_err": compare.logit_err(
                   rows.to(device), ref[torch.as_tensor(at, device=device)])
               if len(rows) == len(tok) else math.inf}
        nums = _worst(nums, got)
        if control:
            lo = reference_logits(params, c, prompt, tok, device, low)
            got = {"logit_gap": compare.logit_gap(ref, lo.argmax(-1)),
                   "logit_err": compare.logit_err(lo, ref)}
            ctl = _worst(ctl, got)
    del params
    return {"sound": nums, "control": ctl} if control else nums


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def traced_replay(srv, arrivals, t: dict, tracer):
    """The device's side of the window, traced after it so that the
    profiler slows no request it measures: the window's requests due in
    its first ``traced_replay_s`` seconds offered again, and the
    ``traced_decode_steps`` decode steps from ``traced_from_s`` on
    profiled, with the prefill chunks between them."""
    counted = {"decode": 0, "prefill": 0}
    t0 = [0.0]

    def on_decode(fn, *a):
        if tracer.trace is not None:
            return fn(*a)
        if not tracer.running and \
                time.perf_counter() - t0[0] >= t["traced_from_s"]:
            tracer.start()
        if not tracer.running:
            return fn(*a)
        with span("serve.decode_step"):
            out = fn(*a)
        counted["decode"] += 1
        if counted["decode"] >= t["traced_decode_steps"]:
            tracer.stop(**counted)
        return out

    def on_prefill(fn, *a):
        if not tracer.running:
            return fn(*a)
        with span("serve.prefill_chunk"):
            out = fn(*a)
        counted["prefill"] += 1
        return out

    srv.on_decode, srv.on_prefill = on_decode, on_prefill
    t0[0] = time.perf_counter()
    srv.run(srv.requests([a for a in arrivals
                          if a.arrival_s < t["traced_replay_s"]]))
    if tracer.running:
        tracer.stop(**counted)
    return tracer.trace


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> Outcome:
    c = cell.config
    marks = {"imports": time.perf_counter()}
    srv, t, marks["weights and engine built"] = setup(cell, seed, device)
    marks["warm-up run"] = time.perf_counter()
    tracer = Tracer(device) if trace else None
    if tracer:
        tracer.warm()
    arrivals = tr.open_loop(seed, seconds, t, c["vocab_size"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    report, watch = window(srv, arrivals, seed, t)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    traced = traced_replay(srv, arrivals, t, tracer) if tracer else None
    ms = report.metrics
    ok = [m for m in ms if m.outcome == "completed"]
    counts = {"queue_s": [m.admitted_s - m.arrival_s for m in ok],
              "decode_step_s": [s for m in ok for s in m.token_latencies_s]}
    served = watch.served(report)
    e2e = {**latencies(ms), "setup_s": setup_s}
    del srv, report, watch
    free(device)
    nums = check_numbers(c, served, seed, device)
    rows = sum(len(r) for _, _, r, _ in served)
    return Outcome(
        end_to_end=e2e,
        counts=counts, trace=traced,
        checks=[(k, nums[k], lim) for k, lim in cell.limits.items()],
        attempted=len(ms), failed=len(ms) - len(ok),
        memory_peak_bytes=peak,
        notes=[setup_note(t_process, marks),
               f"compared {rows} rows of the program's logits and "
               f"{sum(len(x) for _, x, _, _ in served)} served tokens of "
               f"{len(served)} requests"])
