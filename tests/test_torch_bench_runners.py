"""The engine bench runners of ``repro_torch.bench`` against the reference's
``benchmarks/*.py`` (loaded from their files) on the CPU, at tiny sizes.

Held: the shared problem builder's arrays equal to the reference's (and
the checkpoint and serving benches build through it); ``parity_check``
within 1e-5, as both packages hold it; ``exchange_stats`` rows equal
(names, values exactly, notes but for the timing); the useful-flop count
of both engines within 1e-12 relative; every runner's row names equal to
the reference's (the kernel bench's CPU rows are the plain versions, the
reference's ``_ref`` rows); the applied wakes of an engine run inside five
standard deviations of the binomial count both packages expect (their
random streams differ); and ``bench.run --list`` / an unknown ``--only``
as ``tests/test_obs.py`` holds the reference's.
"""

import importlib
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.bench import (async_engine, checkpoint, kernels, obs, serving, sharded_engine,
                               sparse_scale)
from repro_torch.bench import run as bench_run
from repro_torch.sim import clocks

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(n=600, slots=2, slot_wakes=32.0)


@pytest.fixture(scope="module")
def ref():
    """The reference bench modules, importable as ``benchmarks.*``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))
        mods = {name: importlib.import_module(f"benchmarks.{name}") for name in (
            "bench_sparse_scale", "bench_async_engine", "bench_sharded_engine", "bench_obs",
            "bench_kernels")}
        yield mods
    for name in list(sys.modules):
        if name == "benchmarks" or name.startswith("benchmarks."):
            del sys.modules[name]


def _names(rows):
    return [r[0] for r in rows]


def test_make_problem_arrays_equal_the_reference(ref):
    g, obj = sparse_scale._make_problem(3000, 8, 4, np.random.default_rng(5))
    rg, robj = ref["bench_sparse_scale"]._make_problem(3000, 8, 4, np.random.default_rng(5))
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(g, name), getattr(rg, name))
    for name in ("X", "y", "mask"):
        np.testing.assert_array_equal(getattr(obj.data, name), getattr(robj.data, name))
    for name in ("idx", "w"):
        np.testing.assert_array_equal(getattr(obj.mix, name), np.asarray(getattr(robj.mix, name)))
    assert obj.mu == robj.mu == 0.5 and obj.mix.kind == "sparse"
    # The checkpoint and serving benches build through the same function
    # (the reference's own inline copies draw the same arrays in the same order).
    assert serving._make_problem is checkpoint._make_problem is sparse_scale._make_problem
    assert not hasattr(checkpoint, "_problem")


def test_parity_check_within_its_tolerance(ref):
    err = sparse_scale.parity_check(device="cpu")
    want = ref["bench_sparse_scale"].parity_check()
    assert 0.0 <= err <= 1e-5 and 0.0 <= want <= 1e-5


def test_exchange_stats_rows_equal_the_reference(ref):
    g, _ = sparse_scale._make_problem(5000, 8, 4, np.random.default_rng(0))
    rg, _ = ref["bench_sparse_scale"]._make_problem(5000, 8, 4, np.random.default_rng(0))
    rows, parts = sharded_engine.exchange_stats(g, 4, 8)
    want, rparts = ref["bench_sharded_engine"].exchange_stats(rg, 4, 8)
    assert _names(rows) == _names(want) and set(parts) == set(rparts) == {None, "rcm"}
    untimed = re.compile(r" partition_build=[0-9.]+s")
    for (name, v, note), (_, rv, rnote) in zip(rows, want):
        assert v == rv, name
        assert untimed.sub("", note) == untimed.sub("", rnote), name


def test_model_flops_equal_the_reference_on_both_engines(ref):
    import repro.sim as jsim
    from repro.roofline.supertick import model_flops_per_supertick as ref_flops
    from repro_torch.obs.roofline import model_flops_per_supertick
    from repro_torch.sim import AsyncEngine, CDUpdate, ShardedAsyncEngine

    _, obj = sparse_scale._make_problem(800, 8, 4, np.random.default_rng(1))
    _, robj = ref["bench_sparse_scale"]._make_problem(800, 8, 4, np.random.default_rng(1))
    pairs = [
        (AsyncEngine(CDUpdate(obj), slot_wakes=64.0, device="cpu"),
         jsim.AsyncEngine(jsim.CDUpdate(robj), slot_wakes=64.0)),
        (ShardedAsyncEngine(CDUpdate(obj), num_shards=4, slot_wakes=64.0, device="cpu"),
         jsim.ShardedAsyncEngine(jsim.CDUpdate(robj), num_shards=1, slot_wakes=64.0)),
    ]
    for port, reference in pairs:
        got, want = model_flops_per_supertick(port), ref_flops(reference)
        assert got == pytest.approx(want, rel=1e-12) and got > 0


def test_runner_rows_are_the_references(ref, tmp_path):
    cases = [
        (sparse_scale.run(n=600, ticks=20, device="cpu", verbose=False),
         ref["bench_sparse_scale"].run(n=600, ticks=20, verbose=False)),
        (async_engine.run(metrics=True, device="cpu", verbose=False, **TINY),
         ref["bench_async_engine"].run(metrics=True, verbose=False, **TINY)),
        (sharded_engine.run(shards=4, metrics=True, device="cpu", verbose=False, **TINY),
         ref["bench_sharded_engine"].run(shards=1, metrics=True, verbose=False, **TINY)),
        (obs.run(shards=4, device="cpu", verbose=False, trace_out=str(tmp_path / "t.json"),
                 report_out=str(tmp_path / "r.jsonl"), **TINY),
         ref["bench_obs"].run(shards=1, verbose=False, trace_out=str(tmp_path / "rt.json"),
                              report_out=str(tmp_path / "rr.jsonl"), **TINY)),
    ]
    for got, want in cases:
        assert _names(got) == _names(want)
        assert all(np.isfinite(v) for _, v, _ in got)
    # The kernel bench's CPU rows: the plain versions under the reference's
    # oracle names; its kernel rows exist only on the card.
    got = _names(kernels.run(device="cpu", verbose=False))
    want = _names(ref["bench_kernels"].run(verbose=False))
    assert got == [w for w in want if "_ref_" in w] and len(got) == 4
    # The obs bench wrote the port's own artifact names, both valid.
    from repro_torch.obs import RunReport, validate_trace

    assert validate_trace(str(tmp_path / "t.json")) > 0
    assert RunReport.from_jsonl(str(tmp_path / "r.jsonl")).phase_rows


def test_applied_wakes_inside_the_binomial_range(ref):
    """Without churn a slot's wake count is a sum of independent Bernoulli
    draws: both packages' applied totals over 2 x 4 slots lie within five
    standard deviations of the expected count (capacity drops counted)."""
    n, slots, wakes = 3000, 4, 300.0
    rates = clocks.normalize_rates(None, n)
    probs = clocks.wake_probs(rates, clocks.slot_duration(rates, wakes))
    mean = 2 * slots * probs.sum()
    sd = math.sqrt(2 * slots * (probs * (1 - probs)).sum())
    for rows in (async_engine.run(n=n, slots=slots, slot_wakes=wakes, churn=False, device="cpu",
                                  verbose=False),
                 ref["bench_async_engine"].run(n=n, slots=slots, slot_wakes=wakes, churn=False,
                                               verbose=False)):
        note = dict((k, v) for k, _, v in rows)["async_equiv_ticks_per_s"]
        applied, dropped = map(int, re.match(r"(\d+) wakes applied, (\d+) dropped", note).groups())
        assert abs(applied + dropped - mean) <= 5 * sd, (applied, dropped, mean, sd)


def test_bench_run_list_and_unknown_only(capsys):
    assert bench_run.main(["--list"]) == 0
    names = capsys.readouterr().out.split()
    assert names == ["fig1", "fig2", "table1", "ablations", "kernels", "sparse_scale",
                     "async_engine", "sharded_engine", "obs", "dynamic_topology", "checkpoint",
                     "serving", "roofline"]
    assert bench_run.main(["--only", "definitely_not_a_bench"]) != 0
    err = capsys.readouterr().err
    assert "definitely_not_a_bench" in err
    for name in names:
        assert name in err  # the error lists every valid name


def test_bench_run_merges_the_references_row_form(tmp_path, capsys):
    import json

    out = tmp_path / "summary.json"
    assert bench_run.main(["--only", "kernels", "--device", "cpu", "--out", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert summary["kernels"]["derived"] == "4 kernels timed"
    assert set(summary) == {"kernels", "dp_clip_noise_ref_256x4096", "graph_mix_ref_64x8192",
                            "ssm_chunk_ref_8x128", "fused_row_update_ref_256x128"}
    assert all(set(v) == {"us_per_call", "derived"} for v in summary.values())
