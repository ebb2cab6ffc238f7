"""The port's spans: named host ranges at its layer boundaries, recorded by
any ``torch.profiler`` session that runs over the port.

``with span(name):`` brackets one piece of work. While a profiler records,
the span is ``torch._C._profiler._RecordFunctionFast``: a plain ``cpu_op``
range among the trace's host events, on kineto's clock, which kineto
aligns with the device's kernels. It is never a ``record_function`` or
user annotation: kineto mirrors those onto the device as a
``gpu_user_annotation``, which a reader of device events would count as
device work. With no profiler recording, ``span`` returns one shared null
context, so a span costs a lookup and a call.

There is no exporter, file, option or environment variable: an operator
gets the spans from any profiler session over the port,
:func:`repro_torch.core.profile.profile_device` included. Kineto keeps a
range's arguments only when the session records shapes, so a span carries
no request id; :class:`repro_torch.serving.request.RequestMetrics` stays
the record of each request.

Where a span starts and ends with the device drained, the device time
inside it belongs to it: the paged engine synchronises after each prefill
chunk and each decode step, and the training step reads its loss, which
waits for the gradients, before its update and synchronises after it.
"""
from __future__ import annotations

import contextlib

import torch

# every span of the port -> what it brackets
NAMES = {
    "repro_torch.serve.decode_step":
        "one decode dispatch over every lane (DecodeWorker.step): the pool "
        "step's launches, sampling, the lanes' advance, the sync, the flags' "
        "read",
    "repro_torch.serve.prefill_chunk":
        "one chunk of a chunked prefill (PagedEngine._chunked_prefill): its "
        "launches and its sync",
    "repro_torch.serve.admit":
        "one admission attempt of the paged engine's loop, from the page "
        "reservation (a refused one ends it) through the table's copy, the "
        "prefill chunks, first-token sampling and the lane's admit",
    "repro_torch.serve.retire":
        "the paged engine's lane loop after a decode step: token accounting, "
        "retirements, page release, pool statistics",
    "repro_torch.model.attention":
        "a layer's attention sub-block, its norm through its residual add "
        "(training forward, paged decode, chunked prefill)",
    "repro_torch.model.mlp":
        "a layer's MLP or MoE sub-block, its norm through its residual add",
    "repro_torch.model.head":
        "the output head: the final norm and the logits (and the loss's "
        "log-softmax)",
    "repro_torch.kernels.flash_attention":
        "the flash-attention wrapper: checks, then K1, or B2 under autograd",
    "repro_torch.kernels.paged_attention":
        "the paged-attention wrapper: checks, the launch parameter, K2",
    "repro_torch.kernels.rmsnorm":
        "the RMSNorm wrapper: checks, then K3",
    "repro_torch.train.forward":
        "one microbatch's forward to its loss (accumulate_grads)",
    "repro_torch.train.backward":
        "one microbatch's backward and the gradients' accumulation",
    "repro_torch.train.loss_read":
        "the training step's read of whether its loss is finite: the wait "
        "for the device to finish the gradients",
    "repro_torch.train.optimizer":
        "the training step's update, after the loss read: AdamW's norm, clip "
        "and update, and the sync after it",
}
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a host range while a
    profiler records, and does nothing otherwise. ``name`` has to be in
    :data:`NAMES`."""
    if name not in NAMES:
        raise KeyError(f"{name!r} is not a span of the port (NAMES)")
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL
