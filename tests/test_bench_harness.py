"""The bench driver's failure tolerance: a failing device metric must never
cost the run its JSON record."""

import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def test_parent_drops_deterministically_failing_metrics(monkeypatch):
    """A metric that fails twice with the identical error is deterministic
    (e.g. a missing native shim), not a transient worker death: the parent
    must stop retrying it and come home with whatever it has."""
    import bench

    bench.WORKDIR.mkdir(parents=True, exist_ok=True)
    monkeypatch.setattr(bench, "DEVICE_METRICS", ("no_such_metric",))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    res = bench.run_device_metrics(1, 90.0, env)
    assert "no_such_metric" not in res
    assert res.get("errors", {}).get("no_such_metric")


def test_worker_records_each_metric_incrementally(tmp_path, monkeypatch):
    """A crash mid-run loses only the in-flight metric: completed ones are
    already on disk as JSON lines."""
    import bench

    calls = []

    def fake_metric(paths):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device backend error (Internal)")
        return 0.001

    monkeypatch.setitem(bench._METRIC_FNS, "m_ok", fake_metric)
    monkeypatch.setitem(bench._METRIC_FNS, "m_crash", fake_metric)
    out = tmp_path / "dev.jsonl"
    bench.worker_main(["m_ok", "m_crash"], out)
    lines = out.read_text().splitlines()
    import json

    recs = [json.loads(l) for l in lines]
    ok = [r for r in recs if r.get("metric") == "m_ok"]
    crash = [r for r in recs if r.get("metric") == "m_crash"]
    assert ok and ok[0]["dt"] == 0.001
    assert crash and "error" in crash[0]


def test_lognormal_lengths_deterministic_and_realistic():
    import bench

    a = bench.lognormal_lengths(16)
    b = bench.lognormal_lengths(16)
    np.testing.assert_array_equal(a, b)      # seeded: probe == bench shapes
    assert a.min() >= 1_500 and a.max() <= 60_000
    assert 5_000 < np.median(a) < 20_000     # ~10 kb median
    assert a.max() > 30_000                  # a real long tail
