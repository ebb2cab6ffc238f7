"""The system under test: the only module of the benchmark that imports
the program, ``repro_torch``. It builds the program's training step and
serving engine for a configuration file and hands them the weights and
inputs the benchmark made; it checks that the program runs what the file
states."""
from __future__ import annotations

import dataclasses

import torch

# configuration file key -> the program's ModelConfig field
FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "num_layers",
          "num_attention_heads": "num_heads",
          "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "rope_theta": "rope_theta", "tie_word_embeddings": "tie_embeddings",
          "attention_bias": "qkv_bias", "family": "family"}


def model_config(c: dict):
    """The program's ModelConfig for configuration file ``c``: its
    architecture (``program_arch``, cut by the program's own ``reduced``
    where the file gives ``program_reduced``, as the CPU tests' toy cells
    do) at the file's depth; raises where the program would run anything
    else than the file states."""
    from repro_torch.configs import get_arch, reduced
    cfg = get_arch(c["program_arch"])
    if "program_reduced" in c:
        cfg = reduced(cfg, **c["program_reduced"])
    cfg = dataclasses.replace(cfg, num_layers=c["num_hidden_layers"])
    wrong = {k: (c[k], getattr(cfg, f)) for k, f in FIELDS.items()
             if k in c and c[k] != getattr(cfg, f)}
    if cfg.norm != "rmsnorm" or cfg.activation != "swiglu" or \
            cfg.rope != "rope":
        wrong["block"] = (c["reference"], (cfg.norm, cfg.activation,
                                           cfg.rope))
    window = cfg.window if cfg.attention_kind == "sliding" else 0
    if window != c.get("sliding_window", 0):
        wrong["sliding_window"] = (c.get("sliding_window", 0), window)
    if wrong:
        raise ValueError(f"the program's {c['program_arch']} is not the "
                         f"configuration {c['name']}: {wrong} (file, program)")
    return cfg


def check_eps(c: dict) -> None:
    """The program's RMSNorm epsilon is fixed at 1e-5."""
    if c["rms_norm_eps"] != 1e-5:
        raise ValueError(f"{c['name']}: the program's RMSNorm takes eps "
                         f"1e-5, the file states {c['rms_norm_eps']}")


class Trainer:
    """The program's training step (``runtime.steps.build_train_step``)
    over the benchmark's weights, with its AdamW state."""

    def __init__(self, c: dict, t: dict, params: dict, device):
        from repro_torch.configs import RunConfig, ShapeConfig
        from repro_torch.runtime.steps import build_train_step
        check_eps(c)
        o = t["optimizer"]
        rcfg = RunConfig(
            model=model_config(c),
            shape=ShapeConfig("cardbench", "train", t["seq"], t["rows"]),
            microbatches=t["microbatches"], remat=t["remat"],
            attention_backend="kernel", learning_rate=o["lr"],
            warmup_steps=o["warmup_steps"], weight_decay=o["weight_decay"],
            grad_clip=o["grad_clip"], param_dtype=c["dtype"],
            opt_state_dtype="float32", opt_master=True)
        self.step_fn, self.model, opt = build_train_step(
            rcfg, total_steps=o["total_steps"], device=device)
        got = {"b1": opt.b1, "b2": opt.b2, "eps": opt.eps}
        if any(o[k] != v for k, v in got.items()):
            raise ValueError(f"the program's AdamW {got} is not the mix's "
                             f"{ {k: o[k] for k in got} }")
        self.b1 = opt.b1
        self.params = params
        self.opt_state = opt.init(params)

    def step(self, tokens: torch.Tensor, labels: torch.Tensor) -> float:
        """One step on (rows, seq) tokens and labels; returns its loss.
        The step returns once the card has finished it."""
        self.params, self.opt_state, m = self.step_fn(
            self.params, self.opt_state, {"tokens": tokens, "labels": labels})
        return float(m["loss"])

    def first_moments(self) -> dict:
        """AdamW's first moments, a tree like the weights."""
        return self.opt_state.m


class Server:
    """The program's paged engine (``serving.make_engine("paged")``) over
    the model's paged triple and the benchmark's weights; a mix's
    ``pool_tokens`` sizes its page pool (else the engine's own default,
    every lane at ``cache_span``)."""

    def __init__(self, c: dict, t: dict, params: dict, device, seed: int,
                 cache_span: int):
        from repro_torch.models import Runtime, build
        from repro_torch.serving import make_engine
        check_eps(c)
        e = t["engine"]
        pool = {"num_pages": e["pool_tokens"] // e["page_size"] + 1} \
            if "pool_tokens" in e else {}
        self.model = build(model_config(c), Runtime(attention_backend="kernel"),
                           param_dtype=getattr(torch, c["dtype"]),
                           device=device)
        self.prefill_fn = self.model.prefill_chunk
        self.decode_fn = self.model.decode_step_paged
        self.engine = make_engine(
            e["scheduler"], self._prefill, self._decode, params,
            self.model.paged_cache_init, slots=e["slots"],
            cache_span=cache_span, page_size=e["page_size"],
            prefill_chunk_tokens=e["prefill_chunk_tokens"], greedy=True,
            eos_id=None, seed=seed % 2 ** 63, reject_invalid=True,
            device=device, **pool)
        self.on_decode = self.on_prefill = None

    def _prefill(self, *a):
        if self.on_prefill is not None:
            return self.on_prefill(self.prefill_fn, *a)
        return self.prefill_fn(*a)

    def _decode(self, *a):
        if self.on_decode is not None:
            return self.on_decode(self.decode_fn, *a)
        return self.decode_fn(*a)

    @staticmethod
    def requests(arrivals) -> list:
        from repro_torch.serving.request import Request
        return [Request(rid=a.rid, prompt=a.prompt,
                        max_new_tokens=a.max_new_tokens,
                        arrival_s=a.arrival_s) for a in arrivals]

    def run(self, requests):
        return self.engine.run(requests)
