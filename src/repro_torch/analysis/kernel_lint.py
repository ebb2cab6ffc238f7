"""Launch-contract lint of the port's CUDA kernels on Hopper.

The port of ``repro/analysis/kernel_lint.py``. The reference re-derives
each Pallas kernel's tiling plan and holds it to the TPU's VMEM and tile
rules; here a :class:`Plan` re-derives each CUDA launch from a (dims,
config) pair without touching the card: grid, threads, dynamic shared
bytes, the cluster, what the grid must cover and the operands each block
reads. The arithmetic mirrors the C launchers (``csrc/*.cu``:
``flash_attention.cu``'s ``Layout<T, D>`` and ``WgLayout<D, NC>``, the
backward kernels' ``Layout``, ``DqLayout`` and ``DkvLayout``, K2's
``make_plan``, B6's ``make_layout``, K3's ``make_plan``; the mirrors of
K2, B6 and K3 live in :mod:`repro_torch.kernels.tuning`), and
``chip_smoke.py`` phase 14a holds every plan to the C code's own plan
query, field by field. The rules, against
:func:`repro_torch.kernels.tuning.capabilities`:

* **RK001** the grid covers every row, key tile, page and V column (the
  kernels take ragged edges, so coverage, not exact division);
* **RK002** dynamic plus static shared memory fits the opt-in limit of a
  block, and a block (with the runtime's reserve) fits an SM, which a
  cluster needs of each of its blocks; static bytes come from the build's
  ``-Xptxas -v`` report where one exists, else 0;
* **RK003** the dims are ones the kernel is built for: head dim in
  ``HEAD_DIMS`` (K1-B4), D a multiple of ``VEC`` (K2), K and V at most 64
  and a V slice the kernel is instantiated for (B6);
* **RK004** threads in whole warps, at most the card's 1,024 and the
  kernel's own launch bound; grid y and z at most 65,535; a cluster at
  most the portable 8 and dividing grid x;
* **RK005** the dtype is float32 or bfloat16.

Checked configs: every default (the heuristics' mirrors) at the shapes
of ``PERF.md``'s kernel table (:data:`CANONICAL_DIMS`), and every entry
of the tuned cache, its signature parsed back into dims.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.kernels import tuning

from .findings import Finding

Dims = Dict[str, Any]
CSRC = "src/repro_torch/csrc"
HEAD_DIMS = (16, 32, 64, 128, 160)   # kernels/flash_attention.py: HEAD_DIMS
DTYPES = ("float32", "bfloat16")

# flash attention's compiled tiles (csrc/flash_attention*.cu)
FWD_BQ, FWD_THREADS = 64, 128
FWD_TILE = {"float32": (4, 32), "bfloat16": (8, 64)}    # (PAD, BK)
# bf16 at these head dims runs the wgmma kernel (``WgLayout<D, NC>``): NC
# consumer warpgroups of 64 q rows and a producer (a warpgroup with two
# consumer warpgroups, a warp with one); per head dim, (key rows a tile,
# stages)
FWD_WG_TILE = {64: (128, 2), 128: (64, 3)}
FWD_WG_DIMS = tuple(FWD_WG_TILE)
# the mma.sync forward's ring stages; f32 at FWD_PRE_DIMS keeps the q
# tile's TF32 lo beside it (``Layout<T, D>::PRE``)
FWD_STAGES, FWD_PRE_DIMS = 2, (64,)
# f32 K1/B2 at these head dims split the key range over a cluster of at
# most FWD_MAX_CLUSTER blocks, each rank FWD_RANK_TILES key tiles or more
# (``fwd_cluster``)
FWD_SPLIT_DIMS, FWD_MAX_CLUSTER, FWD_RANK_TILES = (64, 128), 8, 4
# elsewhere, over two warp groups of one block (``fwd_halves``) unless the
# grid fills four waves of the SMs with ranges of fewer key tiles than this
FWD_HALVES_TILES = 8
BWD_ROWS, BWD_THREADS = 64, 256
BWD_PAD = {"float32": 4, "bfloat16": 8}
# bf16 at the same head dims runs B3's and B4's wgmma kernels
# (``DqLayout<D, NC>``, ``DkvLayout<D, NC>``): NC consumer warpgroups of 64
# resident rows (B4 at D128: one) and a producer; streamed tiles of 64 rows
# (B3: keys, B4: queries) in two stages
BWD_WG_TILE, BWD_WG_STAGES = 64, 2
# f32 B4 splits its GQA group over a cluster of at most this many blocks,
# and only while the split grid stays within this many waves of the SMs
# (``dkv_cluster``)
BWD_MAX_CLUSTER, BWD_SPLIT_WAVES = 8, 4


@dataclass
class Plan:
    """One launch as the C launcher makes it: what the lint checks and
    what phase 14a compares with the C plan query."""

    kernel: str                    # "K1/B2", "B3", "B4", "K2", "K3", "B6"
    path: str                      # its source, for findings
    dtype: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int                      # dynamic shared bytes
    cluster: int = 1
    static_smem: int = 0
    max_threads: int = 1024        # the kernel's own launch bound
    # (what, extent, per block, blocks along it): the grid must cover it
    covers: List[Tuple[str, int, int, int]] = field(default_factory=list)
    reads: Tuple[str, ...] = ()    # the operands each block reads
    bad_dims: List[str] = field(default_factory=list)   # RK003 messages
    # the C plan query that reports this launch, and its arguments
    query: str = ""
    query_args: Tuple[int, ...] = ()

    def launch(self) -> Dict[str, int]:
        """The fields the C plan query writes (``_build.PLAN_FIELDS``)."""
        gx, gy, gz = self.grid
        return {"grid_x": gx, "grid_y": gy, "grid_z": gz,
                "threads": self.threads, "smem": self.smem,
                "cluster": self.cluster}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _dt(dims: Dims) -> str:
    return str(dims.get("dtype", "float32"))


def _code(dtype: str) -> int:
    return 1 if dtype == "bfloat16" else 0


def _static(kernel: str, dtype: str, static_smem: Optional[Dict]) -> int:
    return int((static_smem or {}).get((kernel, dtype), 0))


# ------------------------------------------------------------ plan builders
def fwd_wgmma(D: int, dtype: str) -> bool:
    """Whether K1/B2 runs the wgmma kernel: the (dtype, D) rule of
    ``flash_attention.cu``."""
    return dtype == "bfloat16" and D in FWD_WG_DIMS


def fwd_groups(B: int, Sq: int, Hq: int, sms: Optional[int] = None) -> int:
    """The wgmma kernel's consumer warpgroups (``fwd_groups``): 2 when the
    grid of 128-row tiles fills the SMs, else 1."""
    sms = tuning.capabilities().sms if sms is None else sms
    return 2 if B * Hq * _cdiv(Sq, 128) >= sms else 1


def ring_ctl_bytes(stages: int) -> int:
    """The ring's control after the mma.sync kernels' tiles
    (``attn::ring_ctl_bytes``): 1 + STAGES mbarriers, then the release
    counts, in whole 8-byte words."""
    return 8 * (1 + stages) + 8 * ((stages + 1) // 2)


def fwd_launch(B: int, Sq: int, Sk: int, Hq: int, D: int, dtype: str):
    """K1/B2's (q rows a block, threads, dynamic shared bytes, key rows a
    tile): the wgmma kernel's ``WgLayout<D, NC>`` (the q tile, the stages'
    K and V, 1024 bytes of alignment and the 1 + 3 STAGES mbarriers) or
    the mma.sync kernel's ``Layout<T, D, HALVES>`` (up to 128 bytes that
    align the tensor copies' destinations, the q tile, in f32 at
    FWD_PRE_DIMS its TF32 lo, FWD_STAGES stages of (k, v) tiles for each
    warp group, rows padded, then each group's ring control; two groups of
    128 threads where ``fwd_halves``)."""
    if fwd_wgmma(D, dtype):
        nc = fwd_groups(B, Sq, Hq)
        bq, (bk, stages) = 64 * nc, FWD_WG_TILE[D]
        smem = 1024 + (bq + stages * 2 * bk) * D * 2 + 8 * (1 + 3 * stages)
        return bq, 384 if nc == 2 else 160, smem, bk
    pad, bk = FWD_TILE.get(dtype, FWD_TILE["float32"])
    ld = D + pad
    groups = 2 if fwd_halves(B, Sq, Sk, Hq, D, dtype) else 1
    q = (2 if dtype == "float32" and D in FWD_PRE_DIMS else 1) * FWD_BQ * ld
    tiles = (q + groups * FWD_STAGES * 2 * bk * ld) * tuning.itemsize(dtype)
    return (FWD_BQ, groups * FWD_THREADS,
            128 + tiles + groups * ring_ctl_bytes(FWD_STAGES), bk)


def fwd_cluster(B: int, Sq: int, Sk: int, Hq: int, D: int, dtype: str,
                sms: Optional[int] = None) -> int:
    """f32 K1/B2's cluster (``fwd_cluster``): at FWD_SPLIT_DIMS, where the
    grid of (q tile, q head, row) blocks underfills the SMs, the largest c
    at most FWD_MAX_CLUSTER that leaves each rank FWD_RANK_TILES or more
    of the 32-key tiles of Sk; 1 (no split) otherwise, and always in
    bf16."""
    sms = tuning.capabilities().sms if sms is None else sms
    blocks = B * Hq * _cdiv(Sq, FWD_BQ)
    key_tiles = _cdiv(Sk, FWD_TILE["float32"][1])
    if dtype != "float32" or D not in FWD_SPLIT_DIMS or blocks >= sms:
        return 1
    return max(1, min(FWD_MAX_CLUSTER, key_tiles // FWD_RANK_TILES))


def fwd_halves(B: int, Sq: int, Sk: int, Hq: int, D: int, dtype: str,
               sms: Optional[int] = None) -> bool:
    """Whether f32 K1/B2 splits each q tile's key range over two warp
    groups of one block instead (``fwd_halves``): at FWD_SPLIT_DIMS, where
    ``fwd_cluster`` does not split, Sk has two key tiles or more, and the
    grid fills fewer than four waves of the SMs or Sk spans
    FWD_HALVES_TILES key tiles or more."""
    sms = tuning.capabilities().sms if sms is None else sms
    blocks = B * Hq * _cdiv(Sq, FWD_BQ)
    key_tiles = _cdiv(Sk, FWD_TILE["float32"][1])
    return (dtype == "float32" and D in FWD_SPLIT_DIMS and key_tiles >= 2
            and (blocks < 4 * sms or key_tiles >= FWD_HALVES_TILES)
            and fwd_cluster(B, Sq, Sk, Hq, D, dtype, sms) == 1)


def bwd_smem(D: int, dtype: str, dkv: bool) -> int:
    """B3 (``dq_bytes``) or B4 (``dkv_bytes``) of the mma.sync backward's
    ``Layout<T, D, NS>``: up to 128 bytes that align the base for the
    tensor copies, the tiles (rows of D + PAD; B4 in f32 at D128 also the
    lo halves of its resident k and v), then 32 bytes of the ring's
    mbarriers and release counts."""
    if dtype == "bfloat16":
        ns = 64
    else:
        ns = 32 if dkv or D > 128 else 64
    ld = D + BWD_PAD.get(dtype, 4)
    resident, stage, pds = BWD_ROWS * ld, 2 * ns * ld, BWD_ROWS * (ns + 8)
    es = tuning.itemsize(dtype)
    if dkv:
        lo = 2 * resident if dtype == "float32" and D == 128 else 0
        tiles = (2 * resident + 2 * stage + 2 * pds + lo) * es
    else:
        tiles = (2 * resident + 2 * stage + pds) * es
    return 128 + tiles + ring_ctl_bytes(2)


def bwd_cluster(B: int, Sk: int, Hkv: int, group: int, dtype: str,
                sms: Optional[int] = None) -> int:
    """f32 B4's cluster (``dkv_cluster``): where its (key tile, kv head,
    row) grid underfills the SMs, the largest divisor of the GQA group at
    most BWD_MAX_CLUSTER whose split grid stays within BWD_SPLIT_WAVES
    waves of them; 1 (no split) otherwise, and always in bf16."""
    sms = tuning.capabilities().sms if sms is None else sms
    blocks = B * Hkv * _cdiv(Sk, BWD_ROWS)
    if dtype != "float32" or blocks >= sms:
        return 1
    for c in range(min(group, BWD_MAX_CLUSTER), 1, -1):
        if group % c == 0 and blocks * c <= BWD_SPLIT_WAVES * sms:
            return c
    return 1


def bwd_launch(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
               dtype: str, dkv: bool):
    """B3's (dkv false) or B4's (resident rows a block, threads, dynamic
    shared bytes): the wgmma kernels' layouts (1024 bytes of alignment,
    the resident pair of tiles, two stages of the streamed pair, B4's lse
    and delta rows, 1 + 3 STAGES mbarriers; consumer warpgroups by
    ``fwd_groups``'s rule over B3's q rows or B4's key rows of each head,
    and one for B4 at D128, ``dkv_groups``) or the mma.sync kernels' (64
    rows, 256 threads, ``bwd_smem``), by the forward's (dtype, D) rule."""
    if not fwd_wgmma(D, dtype):
        return BWD_ROWS, BWD_THREADS, bwd_smem(D, dtype, dkv)
    if dkv:
        nc = 1 if D == 128 else fwd_groups(B, Sk, Hkv)
    else:
        nc = fwd_groups(B, Sq, Hq)
    rows, tile, stages = 64 * nc, BWD_WG_TILE, BWD_WG_STAGES
    smem = 1024 + 2 * rows * D * 2 + stages * 2 * tile * D * 2 \
        + 8 * (1 + 3 * stages)
    if dkv:
        smem += stages * 2 * tile * 4
    return rows, 384 if nc == 2 else 160, smem


def plan_flash_attention(dims: Dims, config: Dict[str, int],
                         static_smem=None) -> List[Plan]:
    """K1/B2, B3 and B4 at one shape (their tiles are compiled in: no
    config)."""
    B, Sq, Sk = int(dims["B"]), int(dims["Sq"]), int(dims["Sk"])
    Hq, Hkv, D = int(dims["Hq"]), int(dims["Hkv"]), int(dims["D"])
    dt = _dt(dims)
    bad = [] if D in HEAD_DIMS else [
        f"head dim {D} not in HEAD_DIMS {HEAD_DIMS}"]
    if Hkv <= 0 or Hq % Hkv:
        bad.append(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    args = (B, Sq, Sk, Hq, Hkv, D, _code(dt))
    fwd_bq, fwd_threads, fwd_bytes, fwd_bk = fwd_launch(B, Sq, Sk, Hq, D, dt)
    keys = fwd_cluster(B, Sq, Sk, Hq, D, dt)
    key_tiles = _cdiv(Sk, fwd_bk)
    # ranks a q tile's key range is split over: a cluster's blocks, or the
    # two warp groups of one block
    ranks = 2 if fwd_halves(B, Sq, Sk, Hq, D, dt) else keys
    fwd = Plan(
        kernel="K1/B2", path=f"{CSRC}/flash_attention.cu", dtype=dt,
        grid=(keys * _cdiv(Sq, fwd_bq), Hq, B), threads=fwd_threads,
        smem=fwd_bytes, cluster=keys, max_threads=fwd_threads,
        static_smem=_static("K1/B2", dt, static_smem),
        covers=[("q rows", Sq, fwd_bq, _cdiv(Sq, fwd_bq)),
                ("q heads", Hq, 1, Hq), ("batch rows", B, 1, B),
                ("key tiles", Sk, fwd_bk, key_tiles),
                ("key tiles of a q tile", key_tiles,
                 _cdiv(key_tiles, ranks), ranks)],
        reads=("q tile", "k, v of its kv head", "lse out (B2)"),
        bad_dims=list(bad), query="flash_attention_fwd", query_args=args)
    dq_rows, dq_threads, dq_bytes = bwd_launch(B, Sq, Sk, Hq, Hkv, D, dt,
                                               dkv=False)
    dq = Plan(
        kernel="B3", path=f"{CSRC}/flash_attention_bwd.cu", dtype=dt,
        grid=(_cdiv(Sq, dq_rows), Hq, B), threads=dq_threads,
        smem=dq_bytes, max_threads=dq_threads,
        static_smem=_static("B3", dt, static_smem),
        covers=[("q rows", Sq, dq_rows, _cdiv(Sq, dq_rows)),
                ("q heads", Hq, 1, Hq), ("batch rows", B, 1, B)],
        reads=("q, dO tiles", "k, v of its kv head", "lse, delta rows"),
        bad_dims=list(bad), query="flash_attention_dq", query_args=args)
    kv_rows, kv_threads, kv_bytes = bwd_launch(B, Sq, Sk, Hq, Hkv, D, dt,
                                               dkv=True)
    group = Hq // Hkv if Hkv > 0 and Hq % Hkv == 0 else 1
    split = bwd_cluster(B, Sk, Hkv, group, dt)
    dkv = Plan(
        kernel="B4", path=f"{CSRC}/flash_attention_bwd.cu", dtype=dt,
        grid=(split * _cdiv(Sk, kv_rows), Hkv, B), threads=kv_threads,
        smem=kv_bytes, cluster=split, max_threads=kv_threads,
        static_smem=_static("B4", dt, static_smem),
        covers=[("key rows", Sk, kv_rows, _cdiv(Sk, kv_rows)),
                ("q heads of a group", group, group // split, split),
                ("kv heads", Hkv, 1, Hkv), ("batch rows", B, 1, B)],
        reads=("k, v tiles", "q, dO of its group's heads",
               "lse, delta rows"),
        bad_dims=list(bad), query="flash_attention_dkv", query_args=args)
    return [fwd, dq, dkv]


def plan_paged_attention(dims: Dims, config: Dict[str, int],
                         static_smem=None) -> List[Plan]:
    """K2 at an explicit split count (``config["splits"]``, clamped to
    the table's pages as the launcher clamps it)."""
    B, Hq, Hkv = int(dims["B"]), int(dims["Hq"]), int(dims["Hkv"])
    D, P, ps = int(dims["D"]), int(dims["P"]), int(dims["ps"])
    npag, dt = int(dims["npag"]), _dt(dims)
    bad = []
    if D % tuning.PAGED_VEC or D // tuning.PAGED_VEC > 32 * 8:
        bad.append(f"head dim {D} must be a multiple of VEC="
                   f"{tuning.PAGED_VEC}, at most {32 * 8 * tuning.PAGED_VEC}")
    if Hkv <= 0 or Hq % Hkv:
        bad.append(f"Hq={Hq} not a multiple of Hkv={Hkv}")
        Hkv = max(Hkv, 1)
    splits = int(config["splits"])
    # the launcher clamps a legal count to the table; an illegal one it
    # refuses, so the plan keeps it for RK004 to name
    legal = 1 <= splits <= tuning.PAGED_MAX_SPLIT
    nsplit = min(splits, npag) if legal else splits
    gh = tuning.paged_group_heads(D)
    ngroups = _cdiv(Hq // Hkv, gh)
    per = _cdiv(npag, max(nsplit, 1))
    return [Plan(
        kernel="K2", path=f"{CSRC}/paged_attention.cu", dtype=dt,
        grid=(nsplit, Hkv * ngroups, B), threads=tuning.PAGED_THREADS,
        smem=tuning.paged_smem(D, tuning.itemsize(dt)), cluster=nsplit,
        static_smem=_static("K2", dt, static_smem),
        covers=[("table pages", npag, per, nsplit),
                ("q heads of a kv head", Hq // Hkv, gh, ngroups),
                ("batch rows", B, 1, B)],
        reads=("its row's q heads of one group", "its share of the row's "
               "live pages of one kv head", "the row's block table"),
        bad_dims=bad, query="paged_attention",
        query_args=(B, P, ps, Hq, Hkv, D, npag, _code(dt), splits))]


def plan_wkv6(dims: Dims, config: Dict[str, int],
              static_smem=None) -> List[Plan]:
    """B6 at an explicit V slice (``config["v_slice"]``)."""
    B, T, H = int(dims["B"]), int(dims["T"]), int(dims["H"])
    K, V, dt = int(dims["K"]), int(dims["V"]), _dt(dims)
    ld = str(dims.get("ld", "float32"))
    vs = int(config["v_slice"])
    bad = []
    if not (0 < K <= tuning.WKV_KMAX and 0 < V <= tuning.WKV_KMAX):
        bad.append(f"K={K}, V={V}: B6 takes 1..{tuning.WKV_KMAX}")
    if vs not in tuning.WKV_V_SLICES:
        bad.append(f"V slice {vs} not one of {tuning.WKV_V_SLICES}")
    return [Plan(
        kernel="B6", path=f"{CSRC}/wkv6.cu", dtype=dt,
        grid=(_cdiv(V, max(vs, 1)), H, B), threads=tuning.WKV_THREADS,
        smem=tuning.wkv6_layout_bytes(K, vs, tuning.itemsize(dt),
                                      tuning.itemsize(ld)),
        static_smem=_static("B6", dt, static_smem),
        covers=[("V columns", V, vs, _cdiv(V, max(vs, 1))),
                ("heads", H, 1, H), ("batch rows", B, 1, B),
                ("chunks", T, tuning.WKV_CHUNK, _cdiv(T, tuning.WKV_CHUNK))],
        reads=("q, k, ld of its head", "its V slice of v", "u (rwkv6)"),
        bad_dims=bad, query="wkv6",
        query_args=(B, T, H, K, V, _code(dt), _code(ld), vs))]


def plan_rmsnorm(dims: Dims, config: Dict[str, int],
                 static_smem=None) -> List[Plan]:
    """K3 at an explicit thread count (``config["threads"]``); rows on
    16-byte boundaries (``dims["aligned"]``, default 1)."""
    rows, d, dt = int(dims["rows"]), int(dims["d"]), _dt(dims)
    threads = int(config["threads"])
    return [Plan(
        kernel="K3", path=f"{CSRC}/rmsnorm.cu", dtype=dt,
        grid=(rows, 1, 1), threads=threads, smem=0,
        static_smem=_static("K3", dt, static_smem),
        max_threads=tuning.NORM_MAX_THREADS,
        covers=[("rows", rows, 1, rows)],
        reads=("its row of x", "scale"), query="rmsnorm",
        query_args=(rows, d, _code(dt), int(dims.get("aligned", 1)),
                    threads))]


PLANNERS: Dict[str, Callable[..., List[Plan]]] = {
    "flash_attention": plan_flash_attention,
    "paged_attention_fwd": plan_paged_attention,
    "wkv6_fwd": plan_wkv6,
    "rmsnorm_fwd": plan_rmsnorm,
}


def default_config(kernel: str, dims: Dims) -> Dict[str, int]:
    """The launch parameter the heuristic picks at ``dims`` (none for
    attention, whose tiles are compiled in)."""
    if kernel not in tuning.DEFAULTS:
        return {}
    return {tuning.PARAMS[kernel]: tuning.DEFAULTS[kernel](dims)}


def _attn(B, S, Hq, Hkv, D, Sk=None, **kw) -> Dims:
    return dict(B=B, Sq=S, Sk=S if Sk is None else Sk, Hq=Hq, Hkv=Hkv, D=D,
                **kw)


# the shapes of PERF.md's kernel table, in both dtypes: K1 at granite's
# prefill, B2-B4 at its training sequence, whisper's non-causal S1500 and
# cross attention, and phase 11b's B1 S128 microbatch (qwen2.5's 40:8,
# where f32 B4 splits its group over a cluster); K2 at the paged engine's
# decode table; K3 at 128 rows of granite's width; B6 at rwkv6-3b's and
# hymba-1.5b's layers
CANONICAL_DIMS: Dict[str, List[Dims]] = {
    "flash_attention": [
        _attn(B, S, Hq, Hkv, D, Sk, dtype=dt) for dt in DTYPES
        for B, S, Hq, Hkv, D, Sk in (
            (1, 128, 32, 8, 128, None), (1, 4096, 32, 8, 128, None),
            (1, 1500, 20, 20, 64, None), (4, 4, 20, 20, 64, 1500),
            (1, 128, 40, 8, 128, None))],
    "paged_attention_fwd": [
        dict(B=B, Hq=Hq, Hkv=8, D=128, P=B * npag + 1, ps=16, npag=npag,
             dtype=dt) for dt in DTYPES
        for B, Hq, npag in ((4, 32, 10), (1, 32, 256), (4, 64, 10))],
    "wkv6_fwd": [
        dict(B=1, T=128, H=H, K=K, V=64, dtype=dt, u=u, ld="float32")
        for dt in DTYPES for H, K, u in ((40, 64, 1), (25, 16, 0))],
    "rmsnorm_fwd": [dict(rows=rows, d=d, dtype=dt) for dt in DTYPES
                    for rows, d in ((128, 4096), (4, 1600), (4096, 4096))],
}


# --------------------------------------------------------------- the checks
def _ctx(plan: Plan, sig: str) -> str:
    return f"[{plan.kernel} {plan.dtype} {sig}]" if sig else \
        f"[{plan.kernel} {plan.dtype}]"


def check_plan(plan: Plan, caps=None, sig: str = "") -> List[Finding]:
    """The five rules over one launch plan."""
    caps = caps or tuning.capabilities()
    ctx = _ctx(plan, sig)
    out: List[Finding] = []

    def add(rule: str, msg: str) -> None:
        out.append(Finding(rule, plan.path, 0, f"{ctx} {msg}"))

    if plan.dtype not in DTYPES:
        add("RK005", f"dtype {plan.dtype} is not one of {DTYPES}")
    for what, extent, per, blocks in plan.covers:
        if blocks < 1 or per < 1 or blocks * per < extent:
            add("RK001", f"{blocks} block(s) of {per} do not cover the "
                f"{extent} {what}")
    total = plan.smem + plan.static_smem
    if total > caps.smem_per_block:
        add("RK002", f"{plan.smem} B dynamic + {plan.static_smem} B static "
            f"shared memory exceed the opt-in limit of "
            f"{caps.smem_per_block} B a block")
    elif total + caps.smem_reserved > caps.smem_per_sm:
        add("RK002", f"a block's {total} B of shared memory and the "
            f"runtime's {caps.smem_reserved} B exceed an SM's "
            f"{caps.smem_per_sm} B" + (
                f": no SM group holds a cluster of {plan.cluster}"
                if plan.cluster > 1 else ""))
    for msg in plan.bad_dims:
        add("RK003", msg)
    limit = min(caps.threads_per_block, plan.max_threads)
    if plan.threads % caps.warp or not caps.warp <= plan.threads <= limit:
        add("RK004", f"{plan.threads} threads: whole warps of {caps.warp} "
            f"up to {limit} (the card's {caps.threads_per_block}, the "
            f"kernel's launch bound {plan.max_threads})")
    gx, gy, gz = plan.grid
    if not 1 <= gx <= caps.grid_x:
        add("RK004", f"grid x {gx} outside 1..{caps.grid_x}")
    for axis, n in (("y", gy), ("z", gz)):
        if not 1 <= n <= caps.grid_yz:
            add("RK004", f"grid {axis} {n} outside 1..{caps.grid_yz}")
    if plan.cluster < 1 or plan.cluster > caps.cluster:
        add("RK004", f"cluster of {plan.cluster} outside 1..{caps.cluster} "
            f"(the portable cluster size)")
    elif gx % plan.cluster:
        add("RK004", f"cluster of {plan.cluster} does not divide grid x "
            f"{gx}")
    return out


def plans(kernel: str, dims: Dims, config: Dict[str, int],
          static_smem=None) -> List[Plan]:
    planner = PLANNERS.get(kernel)
    if planner is None:
        raise KeyError(f"unknown kernel {kernel!r}; the lint knows "
                       f"{sorted(PLANNERS)}")
    return planner(dims, config, static_smem)


def check_config(kernel: str, dims: Dims, config: Dict[str, int],
                 sig: str = "", static_smem=None) -> List[Finding]:
    """Check one (kernel, dims, launch config) against the card."""
    if kernel not in PLANNERS:
        return [Finding("RK001", CSRC, 0, f"unknown kernel '{kernel}'")]
    findings: List[Finding] = []
    for plan in plans(kernel, dims, config, static_smem):
        findings.extend(check_plan(plan, sig=sig or tuning.signature(
            **{k: v for k, v in dims.items()})))
    return findings


# the kernel names of the build's -Xptxas -v report (mangled)
_INSTANCE = (
    (re.compile(r"attn_fwd_kernelI(f|13__nv_bfloat16)"), "K1/B2"),
    # bf16 only: the type is not a template argument
    (re.compile(r"attn_fwd_kernel_wgmma()I"), "K1/B2"),
    (re.compile(r"attn_dq_kernelI(f|13__nv_bfloat16)"), "B3"),
    (re.compile(r"attn_dq_kernel_wgmma()I"), "B3"),
    (re.compile(r"attn_dkv_kernelI(f|13__nv_bfloat16)"), "B4"),
    (re.compile(r"attn_dkv_kernel_wgmma()I"), "B4"),
    (re.compile(r"paged_decode_kernelI(f|13__nv_bfloat16)"), "K2"),
    (re.compile(r"rmsnorm_kernelI(f|13__nv_bfloat16)"), "K3"),
    (re.compile(r"wkv6_kernelI(f|13__nv_bfloat16)"), "B6"),
)


def static_smem_from_log(log: Path) -> Dict[Tuple[str, str], int]:
    """The largest static shared memory (``smem`` bytes of ptxas's
    ``Used ... registers, ... bytes smem`` line) of any instance of each
    (kernel, dtype), from the build's report; {} where there is none."""
    try:
        text = Path(log).read_text()
    except OSError:
        return {}
    out: Dict[Tuple[str, str], int] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([^' ]+)", line)
        if m:
            name = None
            for pattern, kernel in _INSTANCE:
                hit = pattern.search(m.group(1))
                if hit:
                    dt = "float32" if hit.group(1) == "f" else "bfloat16"
                    name = (kernel, dt)
            continue
        m = re.search(r"(\d+) bytes smem", line)
        if name and m:
            out[name] = max(out.get(name, 0), int(m.group(1)))
    return out


def _build_static() -> Dict[Tuple[str, str], int]:
    """Static shared bytes from the current sources' build, if built."""
    from repro_torch.kernels import _build
    try:
        digest = _build._digest(_build.sources())
    except OSError:
        return {}
    return static_smem_from_log(
        _build.BUILD_ROOT / f"kernels-{digest}" / "build.log")


def check_defaults(static_smem=None) -> List[Finding]:
    """Every heuristic's pick must be legal at the canonical shapes."""
    static = _build_static() if static_smem is None else static_smem
    findings: List[Finding] = []
    for kernel, shapes in CANONICAL_DIMS.items():
        for dims in shapes:
            findings.extend(check_config(
                kernel, dims, default_config(kernel, dims),
                static_smem=static))
    return findings


_NEEDED = {"wkv6_fwd": {"B", "T", "H", "K", "V"},
           "rmsnorm_fwd": {"rows", "d"},
           "paged_attention_fwd": {"B", "Hq", "Hkv", "D", "P", "ps", "npag"}}


def sig_dims(kernel: str, sig: str) -> Optional[Dims]:
    """Parse a tuned-cache signature string back into planner dims."""
    dims: Dims = {}
    try:
        for part in sig.split(","):
            key, val = part.split("=", 1)
            dims[key] = val if key in ("dtype", "ld") else int(val)
    except ValueError:
        return None
    return dims if _NEEDED.get(kernel, {None}) <= set(dims) else None


def check_tuned_cache(static_smem=None) -> List[Finding]:
    """Every tuned-cache entry must be legal for its own signature."""
    path = tuning.cache_path()
    display = f"results/tuned/{path.name}"
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return []    # no cache: nothing to check
    static = _build_static() if static_smem is None else static_smem
    findings: List[Finding] = []
    for key, entry in (data.get("entries") or {}).items():
        kernel, _, sig = key.partition("|")
        dims = sig_dims(kernel, sig)
        param = tuning.PARAMS.get(kernel)
        config = dict((entry or {}).get("config") or {})
        if dims is None or param is None or param not in config:
            findings.append(Finding(
                "RK001", display, 0, f"unparseable tuned-cache entry '{key}'"))
            continue
        config = {param: int(config[param])}
        for f in check_config(kernel, dims, config, sig=sig,
                              static_smem=static):
            findings.append(Finding(f.rule, display, 0, f.message))
    return findings


def check_all(static_smem=None) -> List[Finding]:
    return check_defaults(static_smem) + check_tuned_cache(static_smem)


def all_plans(shapes: Dict[str, Sequence[Dims]] = None) -> List[Plan]:
    """Every default plan at ``shapes`` (default :data:`CANONICAL_DIMS`),
    for comparison with the C plan queries."""
    out: List[Plan] = []
    for kernel, dims_list in (shapes or CANONICAL_DIMS).items():
        for dims in dims_list:
            out.extend(plans(kernel, dims, default_config(kernel, dims)))
    return out
