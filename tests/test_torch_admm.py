"""repro_torch.core.admm_baseline and the Fig. 1 runner against the reference.

``run_admm`` on the reference's own ``quad_problem`` fixture
(``tests/test_admm_and_data.py``), T = 400, the same numpy rng: the edge
activations and the float64 z/u updates are the reference's, the node
updates run in float32 in both packages (the reference's jitted scan, the
port's PyTorch loop), so Theta and the objective agree to 1e-5 relative
(float32 rounding in another order; measured about 2e-7) and the
message counts exactly. The counterparts of the reference's two ADMM
tests run on the port alone. The Fig. 1 runner
(``repro_torch.bench.cd_vs_admm``) at a tiny size agrees with
``benchmarks/bench_cd_vs_admm.run``: objectives to 1e-5 relative,
accuracies to 1e-3 (one test point in a thousand), the verdict equal.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro.core import AgentData, make_objective, run_admm
from repro.data.synthetic import linear_classification_problem
from repro_torch.bench import cd_vs_admm
from repro_torch.convert import objective_from_reference

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _reference_bench(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quad_problem():
    prob = linear_classification_problem(n=8, p=5, m_low=5, m_high=15, seed=13)
    X = prob.train.X
    y = np.einsum("nmp,np->nm", X, prob.targets) * prob.train.mask
    data = AgentData(X=X, y=y, mask=prob.train.mask)
    ref = make_objective(prob.graph, data, "quadratic", mu=0.5)
    return ref, objective_from_reference(ref)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("record_every", [1, 7])
def test_run_admm_matches_reference(quad_problem, record_every):
    ref, port = quad_problem
    Theta0 = np.zeros((ref.n, ref.p))
    a = run_admm(ref, Theta0, T=400, rng=np.random.default_rng(0), rho=1.0,
                 local_grad_steps=10, record_every=record_every)
    b = tcore.run_admm(port, Theta0, T=400, rng=np.random.default_rng(0), rho=1.0,
                       local_grad_steps=10, record_every=record_every, device="cpu")
    assert b.Theta.dtype == np.float64 and b.Theta.shape == a.Theta.shape
    assert _rel(b.Theta, a.Theta) <= TOL
    assert np.all(np.abs(b.objective - a.objective) <= TOL * np.abs(a.objective))
    np.testing.assert_array_equal(b.messages, a.messages)


def test_run_admm_node_update_is_the_local_augmented_lagrangian_step(quad_problem):
    """One node update from the port's PyTorch loop, written out in numpy
    (float64) from the objective's formulas, at 1e-5."""
    _, port = quad_problem
    rng = np.random.default_rng(3)
    i, deg, p = 2, 3, port.p
    theta = rng.normal(size=p)
    zs, us = rng.normal(size=(deg + 1, p)), rng.normal(size=(deg + 1, p))
    mask = np.array([1.0, 1.0, 1.0, 0.0])
    dc = port.mu * port.degrees[i] * port.confidences[i]
    X, y, msk, lam = port.data.X[i], port.data.y[i], port.data.mask[i], port.lambdas[i]
    want = theta.copy()
    for _ in range(10):
        g = 2.0 * ((X @ want - y) * msk) @ X / max(msk.sum(), 1.0) + 2.0 * lam * want
        want = want - 0.05 * (dc * g + ((want[None] - zs + us) * mask[:, None]).sum(0))
    t = port.tensors("cpu", torch.float64)
    got = tcore.admm_baseline.node_update(
        port.loss, t["X"][i], t["y"][i], t["mask"][i], t["lam"][i], torch.tensor(dc),
        torch.tensor(theta), torch.tensor(zs), torch.tensor(us), torch.tensor(mask), 1.0, 0.05, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_admm_decreases_objective_toward_optimum(quad_problem):
    _, obj = quad_problem
    q_star = float(obj.value(torch.as_tensor(obj.solve_exact())))
    Theta0 = np.zeros((obj.n, obj.p))
    res = tcore.run_admm(obj, Theta0, T=400, rng=np.random.default_rng(0), rho=1.0,
                         local_grad_steps=10, device="cpu")
    gap0 = res.objective[0] - q_star
    gapT = res.objective[-1] - q_star
    assert gapT < 0.3 * gap0  # clear progress toward the same optimum


def test_cd_beats_admm_per_message(quad_problem):
    """The paper's Fig.-1 claim on the port: CD reaches a lower objective
    than ADMM for the same number of p-dimensional vectors transmitted."""
    _, obj = quad_problem
    Theta0 = np.zeros((obj.n, obj.p))
    admm = tcore.run_admm(obj, Theta0, T=150, rng=np.random.default_rng(1),
                          local_grad_steps=10, device="cpu")
    budget = admm.messages[-1]
    cd = tcore.run_scan(obj, Theta0, T=2000, rng=np.random.default_rng(2), device="cpu")
    k = min(int(np.searchsorted(cd.messages, budget)), len(cd.objective) - 1)
    assert cd.objective[k] < admm.objective[-1]


def test_fig1_runner_matches_reference_bench(tmp_path):
    kw = dict(n=10, p=5, T_cd=200, T_admm=20, verbose=False)
    a = _reference_bench("bench_cd_vs_admm").run(**kw)
    out = tmp_path / "summary.json"
    b = cd_vs_admm.run(device="cpu", out=out, **kw)
    assert set(a) <= set(b)
    for key in ("acc_local", "acc_cd", "acc_admm"):
        assert abs(b[key] - a[key]) <= 1e-3, key
    for key in ("obj_init", "obj_cd_final", "obj_admm_final", "obj_cd_at_admm_budget"):
        assert abs(b[key] - a[key]) <= TOL * abs(a[key]), key
    assert b["messages_admm"] == a["messages_admm"]
    assert b["cd_beats_admm_per_message"] == a["cd_beats_admm_per_message"] is True
    for key in a["curves"]:
        assert _rel(b["curves"][key], a["curves"][key]) <= TOL, key
    row = json.loads(out.read_text())["fig1_cd_vs_admm"]
    assert row["derived"] == "cd_beats_admm_per_message=True" and row["device"] == "cpu"


def test_fig1_runner_cli_writes_its_row(tmp_path):
    out = tmp_path / "summary.json"
    out.write_text(json.dumps({"other": {"kept": 1}}))
    cd_vs_admm.main(["--device", "cpu", "--fast", "--out", str(out)])
    summary = json.loads(out.read_text())
    assert summary["other"] == {"kept": 1}  # rows of other benches stay
    row = summary["fig1_cd_vs_admm"]
    assert (row["n"], row["p"]) == (30, 20) and row["cd_beats_admm_per_message"] is True
    assert row["acc_cd"] > row["acc_local"]


def test_run_admm_refuses_a_missing_card(quad_problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, obj = quad_problem
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.run_admm(obj, np.zeros((obj.n, obj.p)), T=2, rng=np.random.default_rng(0))
