"""The port's examples (``repro_torch.examples``) at their smoke sizes on the CPU.

Where the reference example is deterministic on the same numpy seeds, the
port's example is held against the reference's calls rebuilt from
``repro.core`` and ``benchmarks/``: ``quickstart``'s local and non-private
CD accuracies agree to 1e-6 (the float32 port against the float64
reference moves no test prediction across zero), ``sparse_p2p_scale``'s
three mean distances to the targets to 1e-5 relative (float32 sums in
another order over 5,000 agents), and ``p2p_linear_classification``'s
Fig. 1 and the deterministic Fig. 2c fields within the Fig. 1 and Fig. 2
runners' own tolerances (accuracies 1e-3, objectives 1e-5 relative). The
private runs and the engines draw from the port's own generator, so
those parts are checked for finiteness, range and their budgets. The
other examples run end to end at their ``--smoke`` size (or their
default where the reference has none) and their results are
checked for what the reference example asserts or prints: the sharded
example's forced-wake parity within 1e-6 and its crash-and-resume pair in
subprocesses, the serving example's bit-exact final rows (asserted
inside it) and a version lag at the requests' start within
``snapshot_every``. The MovieLens
example is the Table 1 runner, already held against the reference in
``tests/test_torch_movielens.py``; here its flags are checked to reach
the runner. ``decentralized_lm`` trains through the launcher (held
against the reference in ``tests/test_torch_train.py``) and reports its
losses.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro_torch.examples import (async_p2p_simulation, decentralized_lm,
                                  movielens_recommendation, p2p_linear_classification,
                                  quickstart, serve_batched, sharded_async_simulation,
                                  sparse_p2p_scale)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CPU = ["--device", "cpu"]
ACC_TOL = 1e-3
TOL = 1e-5


def _reference_bench(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_the_reference_where_deterministic():
    from repro.core import make_objective, run_scan, train_local_models
    from repro.core.objective import LOGISTIC
    from repro.data.synthetic import eval_accuracy, linear_classification_problem

    got = quickstart.main(CPU)
    prob = linear_classification_problem(n=10, p=20, m_low=15, m_high=80, seed=0)
    theta_loc = train_local_models(prob.train, LOGISTIC,
                                   1.0 / np.maximum(prob.train.num_examples, 1.0))
    obj = make_objective(prob.graph, prob.train, "logistic", mu=0.3, clip=1.0)
    res = run_scan(obj, theta_loc, T=600, rng=np.random.default_rng(1))
    assert abs(got["acc_local"] - eval_accuracy(theta_loc, prob.test).mean()) <= 1e-6
    assert abs(got["acc_cd"] - eval_accuracy(res.Theta, prob.test).mean()) <= 1e-6
    np.testing.assert_allclose(got["objective"], [res.objective[0], res.objective[-1]],
                               rtol=1e-4)
    assert 0.0 <= got["acc_private"] <= 1.0 and np.isfinite(got["acc_private"])
    assert 0.0 < got["eps_spent_max"] <= 1.0 + 1e-9


def test_p2p_linear_classification_runs_fig1_and_fig2():
    got = p2p_linear_classification.main(CPU)
    fig1 = _reference_bench("bench_cd_vs_admm").run(n=30, p=20, T_cd=800, T_admm=80,
                                                     verbose=False)
    for key in ("acc_local", "acc_cd", "acc_admm"):
        assert abs(got["fig1"][key] - fig1[key]) <= ACC_TOL, key
    for key in ("obj_init", "obj_cd_final", "obj_admm_final", "obj_cd_at_admm_budget"):
        assert abs(got["fig1"][key] - fig1[key]) <= TOL * abs(fig1[key]), key
    assert got["fig1"]["messages_admm"] == fig1["messages_admm"]
    assert got["fig1"]["cd_beats_admm_per_message"] == fig1["cd_beats_admm_per_message"]
    fig2c, _ = _reference_bench("bench_privacy_utility").fig2c_fig3(
        verbose=False, n=30, dims=(10, 20), T_per_agent=5)
    assert [r["p"] for r in got["fig2"]["fig2c"]] == [r["p"] for r in fig2c]
    for a, b in zip(got["fig2"]["fig2c"], fig2c):
        for key in ("acc_local", "acc_nonprivate"):
            assert abs(a[key] - b[key]) <= ACC_TOL, (a["p"], key)
        for key in (k for k in b if k.startswith("acc_eps_")):
            assert 0.0 <= a[key] <= 1.0 and a["ticks" + key[3:]] == b["ticks" + key[3:]]


def test_sparse_p2p_scale_goes_sparse_and_closes_on_the_targets():
    """The reference example's computation, rebuilt from ``repro.core`` on
    the same ``default_rng(0)``: the geometric graph, the targets,
    ``run_scan`` on the numpy stream and 20 ``synchronous_round`` calls."""
    import jax.numpy as jnp
    from repro.core import make_objective, random_geometric_graph, run_scan, synchronous_round
    from repro.core.objective import AgentData

    got = sparse_p2p_scale.main(CPU)
    n, p, m = 5_000, 16, 8
    rng = np.random.default_rng(0)
    graph = random_geometric_graph(n, rng, avg_degree=12.0)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    data = AgentData(X=X, y=np.einsum("nmp,np->nm", X, targets), mask=np.ones((n, m)))
    obj = make_objective(graph, data, "quadratic", mu=0.5)
    res = run_scan(obj, np.zeros((n, p)), T=2_000, rng=rng, record_every=500,
                   record_objective=False)
    Theta = jnp.asarray(res.Theta)
    for _ in range(20):
        Theta = synchronous_round(obj, Theta)
    want = [float(np.linalg.norm(np.asarray(Th) - targets, axis=1).mean())
            for Th in (np.zeros((n, p)), res.Theta, Theta)]
    assert got["mix"] == obj.mix.kind == "sparse"
    np.testing.assert_allclose(got["mean_err"], want, rtol=TOL, atol=0)
    e0, e1, e2 = got["mean_err"]
    assert e0 > e1 > e2


def test_async_p2p_simulation_three_scenarios():
    got = async_p2p_simulation.main(CPU)
    for key in ("ideal", "hostile", "private"):
        q = got[key]["objective"]
        assert len(q) == 4 and np.isfinite(q).all() and q[-1] < q[0], key
    assert got["hostile"]["departed"] > 0
    assert got["private"]["eps_max"] <= 1.0 + 1e-9 and got["private"]["exhausted"] > 0


def test_sharded_async_simulation_smoke_parity():
    got = sharded_async_simulation.main(["--smoke"] + CPU)
    assert got["slots"] == 12 and got["parity_err"] <= sharded_async_simulation.PARITY_TOL
    assert got["halo_fraction"][1] < got["halo_fraction"][0]  # RCM shrinks the cut
    assert np.isfinite(got["objective"]).all() and got["wire_drift"] < 1e-2


def test_sharded_async_simulation_crash_and_resume(tmp_path):
    """The reference's crash rehearsal: checkpoint every 4 slots, die hard
    after 8 (exit code 7), then resume from the newest entry and finish."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    ck = str(tmp_path / "ckpts")
    base = [sys.executable, "-m", "repro_torch.examples.sharded_async_simulation", "--smoke",
            "--checkpoint-dir", ck, "--checkpoint-every", "4"] + CPU
    kill = subprocess.run(base + ["--kill-after", "8"], env=env, capture_output=True, text=True,
                          timeout=300)
    assert kill.returncode == 7, kill.stderr
    assert "checkpointed through slot 8" in kill.stdout
    done = subprocess.run(base + ["--resume"], env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr
    assert "[resume]   picked up slot 8" in done.stdout and "[parity]" in done.stdout


def test_serve_batched_smoke():
    got = serve_batched.main(["--smoke"] + CPU)
    assert got["version"] == got["slots"] == 6
    assert got["published"] == 1 + got["slots"] // got["snapshot_every"]
    # C4's limit: at a request's start the served version trails the newest
    # published one by at most snapshot_every (0 on the CPU: copies are
    # ready); the end lag adds the publications made while it ran
    assert 0 <= got["lag_start_max"] <= got["snapshot_every"]
    assert got["lag_start_max"] <= got["lag_max"] <= got["slots"]


def test_movielens_recommendation_reaches_the_runner(monkeypatch):
    calls = []
    monkeypatch.setattr(movielens_recommendation.movielens, "run",
                        lambda **kw: calls.append(kw) or {"ok": True})
    assert movielens_recommendation.main(CPU) == {"ok": True}
    assert movielens_recommendation.main(["--full"] + CPU) == {"ok": True}
    assert calls == [dict(fast=True, device="cpu"), dict(fast=False, device="cpu")]


def test_decentralized_lm_trains_and_reports_its_losses(tmp_path, monkeypatch, capsys):
    """Three rounds of the reference example's default (the launcher's
    ``small`` llama3.2-1b preset, one agent, 2 x 129 tokens, mu 0.5, alpha
    0.9), DP on, its checkpoint under the working directory."""
    monkeypatch.chdir(tmp_path)
    got = decentralized_lm.main(["--steps", "3", "--eps", "1.0"] + CPU)
    assert got["steps"] == 3 and [r["step"] for r in got["history"]] == [0, 2]
    assert np.isfinite(got["first_loss"]) and np.isfinite(got["last_loss"])
    assert got["improved"] == (got["last_loss"] < got["first_loss"])
    out = capsys.readouterr().out
    assert f"loss {got['first_loss']:.3f} -> {got['last_loss']:.3f}" in out
    assert "composed eps over run" in out
    assert (tmp_path / "results" / "decentralized_lm_ckpt").is_dir()
