"""AdamW with f32 master weights, global-norm clipping and a warmup-cosine
schedule: the PyTorch counterpart of ``repro/optim/adamw.py``.

Memory policy knobs, as in the reference:

* ``state_dtype`` -- 'float32' | 'bfloat16' | 'int8': m/v storage. int8 is
  blockwise-quantized (16-element blocks along the last dim with f32
  scales, ~1.25 B/element); leaves that do not split into such blocks
  stay f32.
* ``use_master`` -- keep an f32 master copy (True) or update the params
  directly with f32 math (False).

Unlike the reference, which returns new arrays, :meth:`AdamW.update`
updates the params, the master copy and the moments IN PLACE and returns
the same objects: at full width every extra copy of the state costs as
much device memory as the params. The gradients are only read.

Weight decay applies where the master leaf has ``ndim >= 2``. With the
stacked (L, d) layout of the layers' norm scales this decays them (and not
``final_norm``), exactly as the reference does: the rule goes with the
layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch._tree import tree_leaves, tree_map

_QBLOCK = 16  # along the last dim


class Q8(NamedTuple):
    """Blockwise-int8 tensor: q keeps the source shape; scale has shape
    shape[:-1] + (last / _QBLOCK,)."""
    q: torch.Tensor
    scale: torch.Tensor


def quantizable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] % _QBLOCK == 0


def _q8_encode(x: torch.Tensor):
    if not quantizable(x.shape):
        return x.float()
    blocks = x.float().reshape(*x.shape[:-1], -1, _QBLOCK)
    scale = blocks.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return Q8(q=q.to(torch.int8).reshape(x.shape), scale=scale)


def _q8_decode(enc) -> torch.Tensor:
    if not isinstance(enc, Q8):
        return enc.float()
    blocks = enc.q.float().reshape(*enc.q.shape[:-1], -1, _QBLOCK)
    return (blocks * enc.scale[..., None]).reshape(enc.q.shape)


def _store(dst, src) -> None:
    """Write an encoded moment into its state buffers in place."""
    if isinstance(dst, Q8):
        dst.q.copy_(src.q)
        dst.scale.copy_(src.scale)
    else:
        dst.copy_(src)


@dataclass
class AdamWState:
    step: int
    master: dict          # f32 master copy of params ({} if use_master=False)
    m: dict
    v: dict


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Callable[[int], float]:
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (final_frac + (1 - final_frac) * 0.5
                          * (1 + math.cos(math.pi * prog)))
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, on the leaves'
    device (no host synchronisation)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


@dataclass(frozen=True)
class AdamW:
    lr_fn: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # float32 | bfloat16 | int8
    use_master: bool = True

    def __post_init__(self):
        if self.state_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"state_dtype {self.state_dtype!r}: expected "
                             "'float32', 'bfloat16' or 'int8'")

    def _enc(self, x32: torch.Tensor):
        if self.state_dtype == "int8":
            return _q8_encode(x32)
        return x32.to(getattr(torch, self.state_dtype))

    def _dec(self, enc) -> torch.Tensor:
        if self.state_dtype == "int8":
            return _q8_decode(enc)
        return enc.float()

    def init(self, params) -> AdamWState:
        def zeros():   # fresh buffers each call: m/v/master must not alias
            return tree_map(lambda x: self._enc(torch.zeros(
                x.shape, dtype=torch.float32, device=x.device)), params)
        # clone: an f32 param must not alias its master
        master = tree_map(lambda x: x.detach().float().clone(), params) \
            if self.use_master else {}
        return AdamWState(step=0, master=master, m=zeros(), v=zeros())

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, gnorm=None):
        """One step. Updates ``params`` and ``state`` IN PLACE and returns
        (params, state, {"grad_norm", "lr"}); grad_norm is a device scalar,
        measured before clipping: :func:`global_norm` of ``grads``, or
        ``gnorm`` where the caller gives it (the norm over every rank's
        shards of a sharded step)."""
        state.step += 1
        step = state.step
        lr = float(self.lr_fn(step))
        if gnorm is None:
            gnorm = global_norm(grads)
        clip = (torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-8),
                            max=1.0) if self.grad_clip else 1.0)
        bc1 = 1 - self.b1 ** step
        bc2 = 1 - self.b2 ** step
        flat_p = tree_leaves(params)
        flat_ma = tree_leaves(state.master) if self.use_master else flat_p
        for p, g, m_enc, v_enc, master in zip(
                flat_p, tree_leaves(grads), tree_leaves(state.m),
                tree_leaves(state.v), flat_ma):
            g = g.float() * clip
            # float32 moments decode to the state tensors themselves, so
            # these update them in place; other types decode to copies
            m = self._dec(m_enc).mul_(self.b1).add_(g, alpha=1 - self.b1)
            v = self._dec(v_enc).mul_(self.b2).addcmul_(g, g,
                                                        value=1 - self.b2)
            del g
            _store(m_enc, self._enc(m))
            _store(v_enc, self._enc(v))
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            del m, v
            # without a master copy an f32 param is its own master; any
            # other dtype gets an f32 copy that is written back below
            ma = master.float()
            if ma.ndim >= 2 and self.weight_decay:
                upd.add_(ma, alpha=self.weight_decay)
            ma.add_(upd, alpha=-lr)
            if p is not ma:
                p.copy_(ma)
        return params, state, {"grad_norm": gnorm, "lr": lr}
