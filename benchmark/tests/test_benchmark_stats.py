"""The statistics and the trace reduction on hand-made samples."""
import statistics

import numpy as np
import pytest

from benchmark import generator, stats, tracing


def host_activity(t, annotations) -> str:
    """The plain lookup: the innermost (shortest) span holding time t."""
    best = None
    for name, s, e in annotations:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "between calls"


def test_rate_and_percentile():
    assert stats.rate(10e9, 4.0) == 2.5e9
    with pytest.raises(ValueError):
        stats.rate(1, 0)
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_is_quartiles_over_median():
    xs = [10.0, 10.2, 9.9, 10.1, 10.0, 9.8]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)
    assert stats.spread([5.0] * 6) == 0


def test_union_and_gaps():
    m = tracing.union([(5, 7), (0, 2), (1, 3), (7, 8), (10, 11)])
    assert m == [(0, 3), (5, 8), (10, 11)]
    assert tracing.gaps(m, 0, 12) == [(3, 5), (8, 10), (11, 12)]
    assert tracing.clip([(0, 5), (6, 9)], 2, 7) == [(2, 5), (6, 7)]


def test_reduce_timeline():
    device = [("walk_kernel(int)", 10, 20), ("match_walk_kernel(int)", 15, 25),
              ("Memcpy HtoD", 40, 50)]
    notes = [(tracing.STRETCH, 0, 100), ("decode", 0, 100),
             ("decode.plan", 26, 39), ("decode.native", 55, 95)]
    got = tracing.reduce_timeline(device, notes, 0, 100)
    assert got["busy_s"] == pytest.approx(25e-9)
    assert got["window_s"] == pytest.approx(100e-9)
    assert got["kernel_ns"]["walk_kernel(int)"] == 10
    idle = dict(got["breakdown"]["idle_gaps"])
    # gaps 0-10, 25-40, 50-100, each split where a host span starts or
    # ends: decode 0-10, 25-26, 39-40, 50-55, 95-100; plan 26-39; native
    assert idle == pytest.approx({"decode": 22e-9, "decode.plan": 13e-9,
                                  "decode.native": 40e-9})
    ops = got["breakdown"]["device_ops"]
    assert [o[0] for o in ops][0] in ("walk_kernel(int)",
                                      "match_walk_kernel(int)")
    tr = tracing.Trace("c", kernel_ns=got["kernel_ns"])
    assert tr.kernel_seconds(r"(?<![A-Za-z0-9_])walk_kernel\b") == 10e-9
    assert tr.kernel_seconds(r"match_walk_kernel") == 10e-9


def test_reservoir_keeps_k_of_n_uniformly():
    rng = np.random.default_rng(0)
    kept_first = 0
    for _ in range(2000):
        slots = [generator.sample_keep(n, rng, 2) for n in range(1, 11)]
        assert slots[:2] == [0, 1]
        kept = {0: 1, 1: 2}
        for n, s in enumerate(slots[2:], start=3):
            if s is not None:
                kept[s] = n
        kept_first += 1 in kept.values()
    assert 300 < kept_first < 500        # 2 of 10: each kept with p 0.2


def test_host_activity_names_the_innermost_span():
    notes = [("decode", 0, 100), ("decode.finish", 50, 90),
             ("decode.native", 60, 80)]
    assert host_activity(70, notes) == "decode.native"
    assert host_activity(55, notes) == "decode.finish"
    assert host_activity(120, notes) == "between calls"


def test_innermost_segments_match_the_plain_lookup():
    rng = np.random.default_rng(4)
    notes = []
    for k in range(40):                 # nested calls, as a host thread makes
        s = int(rng.integers(0, 10_000))
        n = int(rng.integers(1, 3000))
        notes.append((f"s{k}", s, s + n))
    edges, names = tracing.innermost_segments(notes)
    for a, b, name in zip(edges, edges[1:], names):
        assert name == host_activity((a + b) / 2, notes)


@pytest.mark.parametrize("rule", [{"per_pass": 1}, {"per_pass": 2},
                                  {"per_pass": 1, "per_payload": 1},
                                  {"sample": 5, "per_pass": 1}])
def test_sampler_judges_every_pass(rule):
    from benchmark import harness
    n, calls = 12, 12 * 7 + 5
    s = harness.Sampler(rule, 2**32 + 1, n)
    order = generator.call_order(n, 9)
    for c in range(calls):
        s.offer(order[c % n], ("answer of call", c))
    kept = [a[1] for _, a in s.answers()]
    assert kept == sorted(set(kept))            # each call once, in order
    per_pass = {}
    for c in kept:
        per_pass[c // n] = per_pass.get(c // n, 0) + 1
    full = range(calls // n)                    # the last pass is cut short
    assert all(per_pass.get(p, 0) >= rule["per_pass"] for p in full)
    if "per_payload" in rule:
        assert {order[c % n] for c in kept} == set(range(n))
    for i, (_, c) in s.answers():
        assert order[c % n] == i


def test_merge_wraps_each_function_once():
    keep = object()
    a = (("m", "f", "x"), ("m", "g", "y"))
    b = (("m", "f", "x", keep),)
    got = tracing.merge(a, b, b)
    assert got == (("m", "f", "x", [keep]), ("m", "g", "y", []))
    with pytest.raises(ValueError):
        tracing.merge(a, (("m", "f", "z"),))


def test_host_spans_time_and_keep():
    import types
    import sys
    mod = types.ModuleType("_span_probe")

    class K:
        stats = 7

        def f(self, x):
            return x + 1
    mod.K = K
    sys.modules[mod.__name__] = mod
    try:
        tr = tracing.Trace("c")
        spans = tracing.merge((("_span_probe", "K.f", "probe",
                                lambda a, r: (a[0].stats, r)),))
        with tracing.host_spans(tr, spans):
            assert K().f(1) == 2 and K().f(4) == 5
        assert tr.span_calls == {"probe": 2} and tr.spans["probe"] >= 0
        assert tr.kept == {"probe": [(7, 2), (7, 5)]}
        assert K.__dict__["f"].__name__ == "f"      # restored
    finally:
        del sys.modules[mod.__name__]
