"""Launch parameters of the port's kernels: the tuned cache, the
heuristics' Python mirrors, the card's limits, and the resolvers.

The port of ``repro/kernels/tuning.py``. Its attention tiles are template
constants of the CUDA code (``csrc/flash_attention*.cu``), so three launch
parameters are open, one per kernel that has one:

* K2 (``paged_attention_fwd``): ``splits``, the blocks that share a row's
  live pages, which is also its thread-block cluster size (1 to 8);
* B6 (``wkv6_fwd``): ``v_slice``, the V columns a block computes (16, 32
  or 64, whose shared-memory layout fits a block);
* K3 (``rmsnorm_fwd``): ``threads``, a row's block (whole warps, 32 to
  512: the kernel loops over whatever part of the row its registers do
  not hold, so every such count computes the whole row).

Each ``resolve_*`` applies the reference's order:

1. an explicit value passed by the caller always wins (an illegal one
   raises :class:`ValueError` naming the limit; nothing falls back);
2. otherwise the tuned cache, ``results/tuned/cuda.json`` (``REPRO_TUNED_DIR``
   moves it), written by :mod:`repro_torch.bench.tune` (``python -m
   repro_torch.bench --tune``), under the kernel's shape signature;
3. otherwise :data:`DEFAULTS`, the Python mirrors of the heuristics the C
   launchers apply (``default_splits``, ``default_v_slice``,
   ``default_threads``), so a checkout without a cache launches as the C
   code alone would (``chip_smoke.py`` phase 14a holds each mirror to the
   C code's plan query).

A cache file is trusted only where its fingerprint matches this process:
the backend ``cuda``, the torch version, the device's name and the digest
of the CUDA sources (``kernels/_build.py::_digest``), so a changed kernel
ignores its old winners. The reference only reads ``<jax backend>.json``,
so the two packages never read each other's file.

The resolvers sit on the decode path, which is host-bound: each keeps a
memo keyed on its shape tuple, so a warm call is one dict lookup and never
builds a signature string. :func:`clear_cache` clears the memo and the
parsed cache (the tuner's ``save`` calls it).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, Optional

REPO = Path(__file__).resolve().parents[3]
DEFAULT_CACHE_DIR = REPO / "results" / "tuned"
ENV_VAR = "REPRO_TUNED_DIR"
CACHE_VERSION = 1
BACKEND = "cuda"

# env-fingerprint keys that must match for a cache file to be trusted
_ENV_MATCH_KEYS = ("backend", "torch", "device", "sources")

# mirrors of the C constants the heuristics and layouts read
PAGED_MAX_SPLIT = 8          # csrc/paged_attention.cu: MAX_SPLIT
PAGED_VEC = 4                # VEC: elements a lane column
PAGED_THREADS = 256
PAGED_NSTAGE = 3
PAGED_WARPS = PAGED_THREADS // 32
WKV_CHUNK = 64               # csrc/wkv6.cu: CHUNK
WKV_KMAX = 64
WKV_THREADS = 256
WKV_V_SLICES = (16, 32, 64)  # the instances: NV = 2, 4, 8
WKV_LA = WKV_CHUNK + 4
WKV_FSTR = WKV_KMAX + 4
WKV_NF = 23
NORM_ELEMS = 16              # csrc/rmsnorm.cu: ELEMS
NORM_MAX_THREADS = 512       # MAX_THREADS, the kernel's launch bound

_CACHE: Dict[str, Any] = {}     # the parsed cache file, once loaded
_MEMO: Dict[tuple, int] = {}    # shape tuple -> resolved launch value


# ----------------------------------------------------------- capabilities
def capabilities():
    """The card's launch limits (:class:`repro_torch.core.roofline.
    LaunchLimits` of the H100), which the lint and the resolvers read."""
    from repro_torch.core.roofline import H100
    return H100.limits


def _dtype_name(dtype: Any) -> str:
    """'float32' / 'bfloat16' from a torch dtype or a name."""
    return str(dtype).rsplit(".", 1)[-1]


def itemsize(dtype: Any) -> int:
    return 2 if _dtype_name(dtype) == "bfloat16" else 4


# ------------------------------------------------ mirrors of the C launchers
def paged_column_bucket(D: int) -> int:
    """K2's instance: 4-element columns a lane (``column_bucket``)."""
    nc = (D // PAGED_VEC + 31) // 32
    return 1 if nc <= 1 else 2 if nc <= 2 else 4 if nc <= 4 else 8


def paged_group_heads(D: int) -> int:
    """Query heads a K2 block (``Shape<NC>::GH``)."""
    nc = paged_column_bucket(D)
    return 4 if nc <= 2 else 8 // nc


def paged_smem(D: int, es: int) -> int:
    """K2's dynamic shared bytes: the ring (or the warps' partials that
    reuse it), the block's (m, l, acc) and the stages' mbarriers
    (``ring_bytes``, ``partial_bytes``, ``bar_offset``)."""
    nc, gh = paged_column_bucket(D), paged_group_heads(D)
    ring = max(PAGED_NSTAGE * 2 * (32 // nc) * D * es,
               4 * PAGED_WARPS * gh * (D + 2))
    bars = (ring + 4 * gh * (D + 2) + 15) // 16 * 16
    return bars + 8 * PAGED_NSTAGE


def default_splits(B: int, Hq: int, Hkv: int, D: int, npag: int,
                   sms: Optional[int] = None) -> int:
    """K2's heuristic: the grid fills the SMs, at most MAX_SPLIT and the
    table's pages (``default_splits`` of ``csrc/paged_attention.cu``)."""
    sms = capabilities().sms if sms is None else sms
    gh = paged_group_heads(D)
    pairs = B * Hkv * (-(-(Hq // Hkv) // gh))
    return max(1, min(PAGED_MAX_SPLIT, npag, sms // pairs))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def wkv6_layout_bytes(K: int, vs: int, es: int, esl: int) -> int:
    """B6's dynamic shared bytes at V slice ``vs`` (``make_layout``)."""
    rk = _round_up(K, 16 // es) + 16 // es
    rl = _round_up(K, 16 // esl) + 16 // esl
    rv = vs + 8
    ld = _round_up(K, 16) + 4
    ls = vs + 8
    stage = WKV_CHUNK * (2 * rk * es + rl * esl + rv * es)
    off = 2 * stage
    for nbytes in (4 * WKV_CHUNK * ld, 4 * WKV_CHUNK * ld,
                   4 * WKV_CHUNK * ld, 4 * WKV_CHUNK * WKV_LA,
                   4 * WKV_KMAX * ls, 4 * WKV_NF * WKV_FSTR,
                   4 * (WKV_KMAX // 4) * WKV_CHUNK, 4 * WKV_KMAX, 16, 16):
        off += _round_up(nbytes, 16)
    return off


def default_v_slice(B: int, H: int, K: int, V: int, es: int = 4,
                    esl: int = 4, sms: Optional[int] = None) -> int:
    """B6's heuristic (``choose_vs``): the narrowest slice whose blocks
    are all resident at once, else the widest that fits; 0 if none fits."""
    lim = capabilities()
    sms = lim.sms if sms is None else sms
    widest = 0
    for vs in WKV_V_SLICES:
        nbytes = wkv6_layout_bytes(K, vs, es, esl)
        if nbytes > lim.smem_per_block:
            break
        widest = vs
        per_sm = lim.smem_per_block // (nbytes + 1024)
        if B * H * -(-V // vs) <= sms * per_sm or vs >= V:
            return vs
    return widest


def default_threads(d: int) -> int:
    """K3's heuristic (``make_plan``): enough threads for 16 elements
    each, in whole warps, 32 to 512. (The vector width cancels out: a
    thread holds 16 elements whether it loads 16 bytes or one element.)"""
    per_thread = -(-d // NORM_ELEMS)
    return min(NORM_MAX_THREADS, max(32, _round_up(per_thread, 32)))


# ------------------------------------------------------------ legality
def check_splits(splits: int) -> int:
    lim = capabilities()
    if not 1 <= int(splits) <= min(lim.cluster, PAGED_MAX_SPLIT):
        raise ValueError(
            f"paged_attention: splits={splits}; the split count is K2's "
            f"thread-block cluster size, 1 to {lim.cluster} (the portable "
            f"cluster limit)")
    return int(splits)


def check_v_slice(v_slice: int, K: int, es: int = 4, esl: int = 4) -> int:
    if int(v_slice) not in WKV_V_SLICES:
        raise ValueError(
            f"wkv6: v_slice={v_slice}; B6 is built for V slices of "
            f"{WKV_V_SLICES} columns")
    nbytes = wkv6_layout_bytes(K, int(v_slice), es, esl)
    limit = capabilities().smem_per_block
    if nbytes > limit:
        raise ValueError(
            f"wkv6: v_slice={v_slice} at K={K} needs {nbytes} B of shared "
            f"memory a block, above the opt-in limit of {limit} B")
    return int(v_slice)


def check_threads(threads: int) -> int:
    lim = capabilities()
    t = int(threads)
    if t % lim.warp or not lim.warp <= t <= min(NORM_MAX_THREADS,
                                                 lim.threads_per_block):
        raise ValueError(
            f"rmsnorm: threads={threads}; K3 takes whole warps of "
            f"{lim.warp}, from {lim.warp} to its launch bound of "
            f"{NORM_MAX_THREADS} (the card's limit is "
            f"{lim.threads_per_block} a block)")
    return t


# ------------------------------------------------------------ environment
def _env_fingerprint() -> Dict[str, Any]:
    import torch

    from repro_torch.kernels import _build
    device = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
              else "")
    return {"backend": BACKEND, "torch": torch.__version__,
            "device": device, "sources": _build._digest(_build.sources())}


def cache_dir() -> Path:
    return Path(os.environ.get(ENV_VAR, str(DEFAULT_CACHE_DIR)))


def cache_path() -> Path:
    return cache_dir() / f"{BACKEND}.json"


# ------------------------------------------------------------- signatures
def signature(**dims: Any) -> str:
    """Canonical shape-signature string: sorted ``k=v`` pairs."""
    return ",".join(f"{k}={v}" for k, v in sorted(dims.items()))


def attention_signature(q_shape, k_shape, dtype, *, causal: bool,
                        window: int) -> str:
    B, Sq, Hq, D = q_shape
    _, Sk, Hkv, _ = k_shape
    return signature(B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, D=D,
                     dtype=_dtype_name(dtype), causal=int(bool(causal)),
                     window=int(window))


def wkv6_signature(q_shape, v_head: int, dtype, *, use_u: bool,
                   ld_dtype="float32") -> str:
    """The reference's keys, plus ``ld``: the decay's type sets B6's
    layout, so it is part of the shape the winner was timed at."""
    B, T, H, K = q_shape
    return signature(B=B, T=T, H=H, K=K, V=int(v_head),
                     dtype=_dtype_name(dtype), u=int(bool(use_u)),
                     ld=_dtype_name(ld_dtype))


def rmsnorm_signature(rows: int, d: int, dtype) -> str:
    return signature(rows=int(rows), d=int(d), dtype=_dtype_name(dtype))


def paged_attention_signature(q_shape, pages_shape, n_pages: int,
                              dtype) -> str:
    B, _, Hq, D = q_shape
    P, ps, Hkv, _ = pages_shape
    return signature(B=B, Hq=Hq, Hkv=Hkv, D=D, P=P, ps=ps,
                     npag=int(n_pages), dtype=_dtype_name(dtype))


# ------------------------------------------------------------------ cache
def clear_cache() -> None:
    """Forget the parsed cache file and every resolver's memo."""
    _CACHE.clear()
    _MEMO.clear()


def _load(path: Path) -> Dict[str, Any]:
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return {}
    if data.get("version") != CACHE_VERSION:
        return {}
    stored = data.get("env", {})
    try:
        current = _env_fingerprint()
    except Exception:
        current = {}
    for key in _ENV_MATCH_KEYS:
        if key in stored or key in current:
            if stored.get(key) != current.get(key):
                return {}   # fingerprint mismatch: tuned elsewhere, ignore
    return dict(data.get("entries", {}))


def _entries() -> Dict[str, Any]:
    if "entries" not in _CACHE:
        _CACHE["entries"] = _load(cache_path())
    return _CACHE["entries"]


def entry_key(kernel: str, sig: str) -> str:
    return f"{kernel}|{sig}"


def lookup(kernel: str, sig: str) -> Optional[Dict[str, int]]:
    """Tuned config for (kernel, signature), or None on a cache miss."""
    entry = _entries().get(entry_key(kernel, sig))
    if not entry:
        return None
    return dict(entry.get("config", {})) or None


def save_entries(entries: Dict[str, Dict[str, Any]]) -> Path:
    """Merge winners into the cache file (atomic replace)."""
    path = cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    merged = _load(path)     # keep prior entries only if env still matches
    merged.update(entries)
    try:
        env = _env_fingerprint()
    except Exception:
        env = {}
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(
        {"version": CACHE_VERSION, "env": env, "entries": merged},
        indent=1, sort_keys=True))
    os.replace(tmp, path)
    clear_cache()
    return path


# -------------------------------------------------- per-kernel resolvers
# kernel -> its launch parameter, and the heuristic as a function of the
# signature's dims
PARAMS = {"paged_attention_fwd": "splits", "wkv6_fwd": "v_slice",
          "rmsnorm_fwd": "threads"}
DEFAULTS: Dict[str, Callable[[Dict[str, Any]], int]] = {
    "paged_attention_fwd": lambda d: default_splits(
        d["B"], d["Hq"], d["Hkv"], d["D"], d["npag"]),
    "wkv6_fwd": lambda d: default_v_slice(
        d["B"], d["H"], d["K"], d["V"], itemsize(d.get("dtype", "float32")),
        itemsize(d.get("ld", "float32"))),
    "rmsnorm_fwd": lambda d: default_threads(d["d"]),
}


def _tuned(kernel: str, sig: str) -> Optional[int]:
    cfg = lookup(kernel, sig)
    return None if not cfg or PARAMS[kernel] not in cfg \
        else int(cfg[PARAMS[kernel]])


def resolve_paged_splits(splits: Optional[int], *, q_shape, pages_shape,
                         n_pages: int, dtype) -> int:
    """K2's split count: explicit > tuned > default, clamped to the
    table's pages as the reference clamps its pages_per_block (an empty
    split, past a row's live pages, combines as m = -inf)."""
    npag = int(n_pages)
    if splits is not None:
        return min(check_splits(splits), npag)
    key = ("paged", q_shape, pages_shape, npag, dtype)
    hit = _MEMO.get(key)
    if hit is None:
        B, _, Hq, D = q_shape
        _, _, Hkv, _ = pages_shape
        tuned = _tuned("paged_attention_fwd", paged_attention_signature(
            q_shape, pages_shape, npag, dtype))
        hit = (min(check_splits(tuned), npag) if tuned is not None
               else default_splits(B, Hq, Hkv, D, npag))
        _MEMO[key] = hit
    return hit


def resolve_wkv_v_slice(v_slice: Optional[int], *, q_shape, v_head: int,
                        dtype, use_u: bool, ld_dtype="float32") -> int:
    """B6's V slice: explicit > tuned > default."""
    K = int(q_shape[-1])
    es, esl = itemsize(dtype), itemsize(ld_dtype)
    if v_slice is not None:
        return check_v_slice(v_slice, K, es, esl)
    key = ("wkv6", q_shape, v_head, dtype, use_u, ld_dtype)
    hit = _MEMO.get(key)
    if hit is None:
        B, _, H, _ = q_shape
        tuned = _tuned("wkv6_fwd", wkv6_signature(
            q_shape, v_head, dtype, use_u=use_u, ld_dtype=ld_dtype))
        hit = (check_v_slice(tuned, K, es, esl) if tuned is not None
               else default_v_slice(B, H, K, int(v_head), es, esl))
        _MEMO[key] = hit
    return hit


def resolve_rmsnorm_threads(threads: Optional[int], *, rows: int, d: int,
                            dtype) -> int:
    """K3's threads a row: explicit > tuned > default."""
    if threads is not None:
        return check_threads(threads)
    key = ("rmsnorm", rows, d, dtype)
    hit = _MEMO.get(key)
    if hit is None:
        tuned = _tuned("rmsnorm_fwd", rmsnorm_signature(rows, d, dtype))
        hit = (check_threads(tuned) if tuned is not None
               else default_threads(int(d)))
        _MEMO[key] = hit
    return hit
