"""The one generator of every traffic mix: the same seed gives the same
work, every seed the same sizes and gaps in another order."""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from cardbench import traffic

REPO = Path(__file__).resolve().parents[1]
MIX = json.loads((REPO / "cardbench/traffic/chat-open-loop.json")
                 .read_text())
SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 40 + 3, -5]


def _key(reqs):
    return [(r.rid, r.prompt.tobytes(), r.max_new_tokens, r.arrival_s)
            for r in reqs]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_same_seed_gives_the_same_requests(seed):
    a = traffic.open_loop(seed, 40.0, MIX, 49155)
    b = traffic.open_loop(seed, 40.0, MIX, 49155)
    assert _key(a) == _key(b)


def test_every_seed_offers_the_same_schedule_with_its_own_tokens():
    runs = [traffic.open_loop(s, 40.0, MIX, 49155) for s in SEEDS]
    n = round(MIX["rate_per_s"] * 40.0)
    for reqs in runs:
        assert len(reqs) == n
        assert reqs[0].arrival_s == 0.0
        assert all(0 <= r.arrival_s < 40.0 for r in reqs)
        assert [r.arrival_s for r in reqs] == sorted(r.arrival_s
                                                     for r in reqs)
    schedules = {tuple((len(r.prompt), r.max_new_tokens, r.arrival_s)
                       for r in reqs) for reqs in runs}
    assert len(schedules) == 1
    # the gaps between arrivals: n - 1 of the n quantile gaps
    quantiles = Counter(np.round(traffic.exponential_gaps(n, 40.0), 9))
    seen = Counter(np.round(np.diff([r.arrival_s for r in runs[0]]), 9))
    assert sum(seen.values()) == n - 1 and not seen - quantiles
    tokens = {b"".join(r.prompt.tobytes() for r in reqs) for reqs in runs}
    assert len(tokens) == len(SEEDS)


def test_the_mix_fixes_the_order():
    other = {**MIX, "schedule_seed": MIX["schedule_seed"] + 1}
    a = traffic.open_loop(5, 40.0, MIX, 49155)
    b = traffic.open_loop(5, 40.0, other, 49155)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt)
                                                     for r in b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


def test_sizes_stay_within_the_mixs_clip_and_median():
    reqs = traffic.open_loop(3, 40.0, MIX, 49155)
    p = [len(r.prompt) for r in reqs]
    o = [r.max_new_tokens for r in reqs]
    assert MIX["prompt"]["min"] <= min(p) and max(p) <= MIX["prompt"]["max"]
    assert MIX["output"]["min"] <= min(o) and max(o) <= MIX["output"]["max"]
    assert abs(np.median(p) - MIX["prompt"]["median"]) < 40
    assert all(1 <= t <= 49155 - 2 for r in reqs for t in r.prompt)


def test_training_rows_are_fixed_by_seed_and_all_differ():
    a = traffic.packed_rows(2 ** 33, 0, 2, 256, 49155, 512, 1.3)
    assert np.array_equal(a, traffic.packed_rows(2 ** 33, 0, 2, 256, 49155,
                                                 512, 1.3))
    b = traffic.packed_rows(2 ** 33, 1, 2, 256, 49155, 512, 1.3)
    assert a.shape == (2, 257) and a.dtype == np.int32
    rows = [tuple(r) for r in np.concatenate([a, b])]
    assert len(set(rows)) == 4
    assert (a == 0).any() and a.min() >= 0 and a.max() <= 49153
