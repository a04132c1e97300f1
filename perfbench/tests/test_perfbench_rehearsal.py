"""Each cell's traffic drives a small copy of its configuration on the CPU:
the result line has the contract's keys, and the reference agrees."""

import json

import pytest

from perfbench import harness
from perfbench.tests.small import CELLS, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run(name):
    r = run(name)
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    rate_name = "round_updates_per_s" if name.endswith(".sync") else "updates_per_s"
    assert set(line["metrics"]) == {rate_name, "setup_s"}
    rate = line["metrics"][rate_name]
    assert rate["value"] > 0 and rate["unit"] == "updates/s"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for value, limit in line["checks"].values():
        assert value <= limit
    if not name.endswith(".sync"):  # the timed chunk is tied to the checked slot
        assert line["checks"]["chunk_mismatch"] == [0, 0]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run(name):
    r = run(name, traced=True)
    assert r["correct"] is True, r["checks"]
    cell = harness.load_cell(name)
    assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    # The CPU has no device trace: only the counted and phase metrics read.
    assert ("mfu.round" if name.endswith(".sync") else "mfu.update") in r["metrics"]
    if name != "rgg500k_p100.sync":
        assert {"phase_us.wake_sample", "phase_us.update"} <= set(r["metrics"])
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
