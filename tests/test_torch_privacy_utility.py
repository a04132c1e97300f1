"""The Fig. 2/3/4 runner (``repro_torch.bench.privacy_utility``) against
``benchmarks/bench_privacy_utility.py``, loaded from its file, at tiny
sizes on the CPU.

Deterministic fields — the local models' accuracies, the non-private CD
accuracy, the Fig. 3 local split, Fig. 4's clean accuracy, and the
objectives of the constant init and the warm start (numpy-seeded
perturbation and propagation) — agree with the reference: accuracies to
1e-3 (a test point in a thousand; equal in practice), objectives to 1e-5
relative (float32 sums in another order). The private runs draw their
noise from the port's own generator (``src/repro_torch/DEVIATIONS.md``,
"Random streams differ"), and Fig. 4's perturbed-data models are trained
on noise far larger than the signal, where float32 order can move a test
point: those fields are held by range only.
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest

from repro_torch.bench import privacy_utility as bench

ROOT = Path(__file__).resolve().parents[1]
ACC_TOL = 1e-3
TOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    path = ROOT / "benchmarks" / "bench_privacy_utility.py"
    spec = importlib.util.spec_from_file_location("bench_privacy_utility", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_unit(x):
    return math.isfinite(x) and 0.0 <= x <= 1.0


def test_fig2a_b_matches_reference(reference):
    kw = dict(n=12, p=6, T=60, record_every=20, verbose=False)
    a = reference.fig2a_b(**kw)
    b = bench.fig2a_b(device="cpu", **kw)
    for key in ("const_init_obj", "warm_start_obj"):
        assert abs(b[key] - a[key]) <= TOL * abs(a[key]), key
    for key in ("const_objective", "warm_objective"):
        assert len(b[key]) == len(a[key]) == 4 and all(map(math.isfinite, b[key]))
    assert b["const_objective"][0] == pytest.approx(b["const_init_obj"], rel=TOL)
    assert _in_unit(b["acc_const"]) and _in_unit(b["acc_warm"])


@pytest.mark.parametrize("T_per_agent", [None, 2])
def test_fig2c_fig3_matches_reference(reference, T_per_agent):
    """``T_per_agent=None`` tunes each budget's ticks on the validation
    problem over ``tick_grid``, as the paper's protocol does."""
    kw = dict(n=12, dims=(4, 6), eps_list=(0.5, 1.0), T_per_agent=T_per_agent,
              tick_grid=(1, 3), verbose=False)
    rows_a, f3_a = reference.fig2c_fig3(**kw)
    rows_b, f3_b = bench.fig2c_fig3(device="cpu", **kw)
    assert [r["p"] for r in rows_b] == [r["p"] for r in rows_a] == [4, 6]
    for a, b in zip(rows_a, rows_b):
        assert set(b) == set(a)
        for key in ("acc_local", "acc_nonprivate"):
            assert abs(b[key] - a[key]) <= ACC_TOL, key
        for eps in (0.5, 1.0):
            assert _in_unit(b[f"acc_eps_{eps}"])
            assert b[f"ticks_eps_{eps}"] in ((1, 3) if T_per_agent is None else (2,))
    for key in ("acc_local_small_m", "acc_local_large_m"):
        assert abs(f3_b[key] - f3_a[key]) <= ACC_TOL, key
    assert _in_unit(f3_b["acc_priv_small_m"]) and _in_unit(f3_b["acc_priv_large_m"])


def test_fig4_local_dp_matches_reference(reference):
    kw = dict(n=12, p=6, eps_list=(1.0, 5.0), verbose=False)
    a = reference.fig4_local_dp(**kw)
    b = bench.fig4_local_dp(device="cpu", **kw)
    assert abs(b["acc_local_clean"] - a["acc_local_clean"]) <= ACC_TOL
    assert [r["eps"] for r in b["rows"]] == [1.0, 5.0]
    assert all(_in_unit(r["acc_local_dp"]) for r in b["rows"])


def test_run_writes_the_reference_row_format(tmp_path, monkeypatch):
    """``run`` (and the CLI) merge a ``fig2_privacy_utility`` row carrying
    the reference's derived string into the summary, keeping other rows."""
    monkeypatch.setattr(bench, "FAST_FIG2AB", dict(n=10, p=5, T=40))
    monkeypatch.setattr(bench, "FAST_FIG2C", dict(n=10, dims=(4, 5), T_per_agent=1))
    monkeypatch.setattr(bench, "FAST_FIG4", dict(n=10, p=5))
    out = tmp_path / "summary.json"
    out.write_text(json.dumps({"other": {"kept": 1}}))
    bench.main(["--device", "cpu", "--fast", "--out", str(out)])
    summary = json.loads(out.read_text())
    assert summary["other"] == {"kept": 1}
    row = summary["fig2_privacy_utility"]
    last = row["fig2c"][-1]
    assert last["p"] == 5 and row["device"] == "cpu"
    assert row["derived"] == (f"acc_local={last['acc_local']:.3f},"
                              f"acc_nonpriv={last['acc_nonprivate']:.3f}")
    assert set(row) >= {"fig2ab", "fig2c", "fig3", "fig4", "elapsed_s"}
