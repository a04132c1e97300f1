"""The ablations runner (``repro_torch.bench.ablations``) against
``benchmarks/bench_ablations.py``, loaded from its file, at tiny sizes on
the CPU.

The personalization ablation is non-private (numpy wake sequence, local
models trained in float32 on both sides) and agrees with the reference's
accuracies to 1e-3 (a test point in a thousand; equal in practice). The
noise-allocation and mechanism ablations run private CD, whose noise
comes from the port's own generator (``src/repro_torch/DEVIATIONS.md``,
"Random streams differ"): they are held by range, and their verdict
field by type.
"""

import importlib.util
import json
import math
from pathlib import Path

import pytest

from repro_torch.bench import ablations as bench

ROOT = Path(__file__).resolve().parents[1]
ACC_TOL = 1e-3


@pytest.fixture(scope="module")
def reference():
    path = ROOT / "benchmarks" / "bench_ablations.py"
    spec = importlib.util.spec_from_file_location("bench_ablations", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_unit(x):
    return math.isfinite(x) and 0.0 <= x <= 1.0


@pytest.mark.parametrize("n,p", [(12, 6), (16, 10)])
def test_personalized_vs_global_matches_reference(reference, n, p):
    a = reference.personalized_vs_global(n=n, p=p, verbose=False)
    b = bench.personalized_vs_global(n=n, p=p, verbose=False, device="cpu")
    assert set(b) == set(a)
    for key in a:
        assert abs(b[key] - a[key]) <= ACC_TOL, key


@pytest.mark.parametrize("name,keys", [("prop2_vs_uniform", ("uniform", "prop2")),
                                       ("gaussian_vs_laplace", ("laplace", "gaussian"))])
def test_private_ablations_by_range(reference, name, keys):
    kw = dict(n=10, p=5, T_per_agent=2, seeds=2, verbose=False)
    a = getattr(reference, name)(**kw)
    b = getattr(bench, name)(device="cpu", **kw)
    assert set(b) == set(a)
    assert all(_in_unit(b[k]) for k in keys)
    if "prop2_better" in b:
        assert b["prop2_better"] == (b["prop2"] >= b["uniform"])


def test_run_writes_the_reference_row_format(tmp_path, monkeypatch):
    """``run`` (and the CLI) merge an ``ablations`` row carrying the
    reference's derived string into the summary, keeping other rows."""
    monkeypatch.setattr(bench, "FAST", dict(n=10, p=5, seeds=1))
    monkeypatch.setattr(bench, "FAST_PERSONALIZATION", dict(n=10, p=5))
    out = tmp_path / "summary.json"
    out.write_text(json.dumps({"other": {"kept": 1}}))
    bench.main(["--device", "cpu", "--fast", "--out", str(out)])
    summary = json.loads(out.read_text())
    assert summary["other"] == {"kept": 1}
    row = summary["ablations"]
    pers = row["personalization"]
    assert row["derived"] == (f"personalized={pers['acc_personalized']:.3f},"
                              f"global={pers['acc_global']:.3f}")
    assert set(row) >= {"noise_allocation", "mechanism", "personalization", "elapsed_s"}
    assert row["device"] == "cpu"
