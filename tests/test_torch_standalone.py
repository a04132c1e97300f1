"""The port stands alone: importing every repro_torch module loads no JAX
and nothing of the reference package, the kernel wrappers never fall
back to the plain version behind an ``except``, and they refuse what
the CUDA kernels do not take."""

import ast
import os
import re
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.kernels import _build, ops

SRC = Path(repro_torch.__file__).resolve().parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(SRC)], prefix="repro_torch.")
    )


def test_every_module_imports_without_jax_or_reference():
    mods = _modules()
    assert {"repro_torch.sim.engine", "repro_torch.kernels.ops", "repro_torch.convert",
            "repro_torch.models.hybrid", "repro_torch.kernels.ssm_chunk",
            "repro_torch.core.admm_baseline", "repro_torch.data.movielens",
            "repro_torch.bench.cd_vs_admm", "repro_torch.bench.movielens",
            "repro_torch.bench.privacy_utility", "repro_torch.bench.ablations",
            "repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.obs.report",
            "repro_torch.sim.capture", "repro_torch.sim.partition",
            "repro_torch.bench.dynamic_topology", "repro_torch.checkpoint",
            "repro_torch.checkpoint.checkpoint", "repro_torch.checkpoint.engine_io",
            "repro_torch.serve", "repro_torch.serve.__main__", "repro_torch.serve.handle",
            "repro_torch.serve.checkpoint_io", "repro_torch.bench.checkpoint",
            "repro_torch.bench.serving", "repro_torch.bench.sparse_scale",
            "repro_torch.bench.async_engine", "repro_torch.bench.kernels",
            "repro_torch.bench.sharded_engine", "repro_torch.bench.obs", "repro_torch.bench.run",
            "repro_torch.obs.trace", "repro_torch.obs.roofline", "repro_torch.examples",
            "repro_torch.examples.quickstart", "repro_torch.examples.p2p_linear_classification",
            "repro_torch.examples.sparse_p2p_scale", "repro_torch.examples.async_p2p_simulation",
            "repro_torch.examples.sharded_async_simulation",
            "repro_torch.examples.movielens_recommendation",
            "repro_torch.examples.serve_batched", "repro_torch.utils", "repro_torch.utils.tree",
            "repro_torch.optim", "repro_torch.optim.optimizers", "repro_torch.core.spmd",
            "repro_torch.launch", "repro_torch.launch.train", "repro_torch.launch.serve",
            "repro_torch.models.transformer", "repro_torch.models.moe",
            "repro_torch.models.encdec", "repro_torch.examples.decentralized_lm",
            "repro_torch.models.sharding", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
            "repro_torch.roofline", "repro_torch.roofline.analysis",
            "repro_torch.roofline.counter", "repro_torch.bench.roofline"} <= set(mods)
    code = textwrap.dedent(
        f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print("BAD", bad)
        """
    )
    env = dict(os.environ, PYTHONPATH=str(SRC.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "BAD []"


def test_kernel_modules_hold_no_except():
    """No try/except anywhere in the kernels package: a CUDA tensor
    launches the kernel or raises, it never falls back."""
    for path in sorted((SRC / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, f"{path.name}: try blocks at lines {tries}"


def test_capture_failures_raise_and_never_fall_back():
    """Every ``except`` in the captured-chunk module ends by raising: a
    capture or replay that fails never carries on eagerly."""
    tree = ast.parse((SRC / "sim" / "capture.py").read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert handlers
    for h in handlers:
        assert isinstance(h.body[-1], ast.Raise), f"capture.py:{h.lineno} does not re-raise"


def test_checkpoint_and_serving_failures_raise_and_never_fall_back():
    """No ``except`` in the checkpoint and serving modules (or their
    benches) lets a failed save, restore, publication or thread carry on:
    each handler ends by raising, but the rotation's fallback to an older
    entry (``_resolve_entry``), which collects each entry's error and
    raises when none verifies."""
    paths = sorted((SRC / "checkpoint").glob("*.py")) + sorted((SRC / "serve").glob("*.py"))
    paths += [SRC / "bench" / "checkpoint.py", SRC / "bench" / "serving.py"]
    fallbacks = 0
    for path in paths:
        tree = ast.parse(path.read_text())
        for fn in [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]:
            for h in [n for n in ast.walk(fn) if isinstance(n, ast.ExceptHandler)]:
                if fn.name == "_resolve_entry":
                    assert isinstance(fn.body[-1], ast.Raise)
                    fallbacks += 1
                else:
                    assert isinstance(h.body[-1], ast.Raise), f"{path.name}:{h.lineno}"
    assert fallbacks == 1


def test_every_kernel_has_a_source_and_a_counter():
    for name in _build.KERNELS:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert 'extern "C"' in src and "cudaGetLastError" in src
        assert "Replaces the Pallas TPU kernel" in src
    assert set(ops.launch_counts()) == set(_build.KERNELS)
    path = _build.library_path("sparse_mix")
    assert path.suffix == ".so" and path.parent == _build.build_dir()


def test_cpu_tensors_take_the_plain_version_without_launching():
    ops.reset_launch_counts()
    theta = torch.randn(6, 3)
    idx = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    w = torch.rand(2, 2)
    got = ops.sparse_mix(idx, w, theta)
    torch.testing.assert_close(got, w[:, :1] * theta[[0, 2]] + w[:, 1:] * theta[[1, 3]])
    ops.graph_mix(torch.eye(6), theta)
    assert ops.launch_counts() == {k: 0 for k in _build.KERNELS}


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks run before any build or launch, so they hold on the CPU."""
    from repro_torch.kernels.fused_row_update import MAX_P, fused_row_update_cuda
    from repro_torch.kernels.sparse_mix import sparse_mix_cuda

    cpu = torch.device("cpu")
    theta = torch.randn(8, 4)
    with pytest.raises(TypeError, match="int32"):
        sparse_mix_cuda(torch.zeros((2, 2), dtype=torch.int64), torch.rand(2, 2), theta)
    with pytest.raises(TypeError, match="float32"):
        sparse_mix_cuda(torch.zeros((2, 2), dtype=torch.int32), torch.rand(2, 2), theta.double())
    with pytest.raises(ValueError, match="shape"):
        sparse_mix_cuda(torch.zeros((2, 2), dtype=torch.int32), torch.rand(2, 3), theta)
    with pytest.raises(ValueError, match="contiguous"):
        _build.check_tensor(theta.t(), "theta", dtype=torch.float32, ndim=2, device=cpu)
    with pytest.raises(ValueError, match="is on"):
        _build.check_tensor(theta, "theta", dtype=torch.float32, ndim=2,
                            device=torch.device("cuda", 0))
    B, K, m, p = 2, 3, 2, MAX_P + 1
    args = (torch.zeros(B, dtype=torch.int32), torch.zeros((B, K), dtype=torch.int32),
            torch.rand(B, K), torch.rand(B, 4), torch.rand(B, m, p), torch.rand(B, m),
            torch.rand(B, m), None, torch.rand(8, p))
    with pytest.raises(ValueError, match="p <= "):
        fused_row_update_cuda(*args, 8)


def test_ssm_chunk_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks run before any build or launch, so they hold on the CPU."""
    from repro_torch.kernels.ssm_chunk import MAX_Q, ssm_chunk_cuda

    def args(G=4, Q=16, N=8, P=8, heads=1, dtype=torch.float32):
        return (torch.rand(G // heads, Q, N, dtype=dtype), torch.rand(G // heads, Q, N, dtype=dtype),
                torch.rand(G, Q), torch.rand(G, Q), torch.rand(G, Q, P, dtype=dtype))

    with pytest.raises(ValueError, match="Q <= "):
        ssm_chunk_cuda(*args(Q=MAX_Q + 1))
    with pytest.raises(ValueError, match="N <= "):
        ssm_chunk_cuda(*args(N=129))
    with pytest.raises(ValueError, match="heads=3"):
        ssm_chunk_cuda(*args(G=4), heads=3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssm_chunk_cuda(*args(dtype=torch.float64))
    C, B, cum, dt, x = args()
    with pytest.raises(TypeError, match="C must be torch.bfloat16"):
        ssm_chunk_cuda(C, B, cum, dt, x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ssm_chunk_cuda(C, B, cum, dt, x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        ssm_chunk_cuda(C, B, cum, dt, x, heads=2)


def test_ssm_chunk_wrapper_refuses_a_head_group_not_dividing_heads():
    """The override of head_plan is checked before any build or launch."""
    from repro_torch.kernels.ssm_chunk import ssm_chunk_cuda

    G, Q, N, P, heads = 8, 16, 8, 8, 4
    args = (torch.rand(G // heads, Q, N), torch.rand(G // heads, Q, N), torch.rand(G, Q),
            torch.rand(G, Q), torch.rand(G, Q, P))
    for bad in (0, 3, 8):
        with pytest.raises(ValueError, match=f"head_group={bad} must divide heads=4"):
            ssm_chunk_cuda(*args, heads=heads, head_group=bad)


def test_mix_wrappers_take_theta_at_any_offset_and_refuse_strides():
    """A contiguous Theta at a storage offset passes the checks (the
    kernels' scalar instances read it; see tests/test_torch_mix_plans.py);
    a transposed mix or Theta is refused, as is a mix of another size. The
    checks run before any build or launch, so they hold on the CPU."""
    from repro_torch.kernels.graph_mix import graph_mix_cuda
    from repro_torch.kernels.sparse_mix import sparse_mix_cuda

    cpu = torch.device("cpu")
    shifted = torch.rand(6 * 4 + 1)[1:].view(6, 4)
    _build.check_tensor(shifted, "theta", dtype=torch.float32, ndim=2, device=cpu)
    A = torch.rand(6, 6)
    with pytest.raises(ValueError, match="contiguous"):
        graph_mix_cuda(A.t(), shifted)
    with pytest.raises(ValueError, match="shape"):
        graph_mix_cuda(torch.rand(5, 5), shifted)
    with pytest.raises(ValueError, match="contiguous"):
        graph_mix_cuda(A, torch.rand(4, 6).t())
    idx, w = torch.zeros((3, 2), dtype=torch.int32), torch.rand(3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        sparse_mix_cuda(idx, w, torch.rand(4, 6).t())
    with pytest.raises(ValueError, match="contiguous"):
        sparse_mix_cuda(idx, torch.rand(2, 3).t(), shifted)


def test_deviations_name_existing_tests_and_current_figures():
    """Every recording test ``DEVIATIONS.md`` names exists (a ``::name``
    after a file names a test of that file), the alignment deviation of
    ``fused_row_update`` has its row, and the ``ssm_chunk`` shared-memory
    figure is the layout's own."""
    from repro_torch.kernels.ssm_chunk import smem_bytes

    text = (SRC / "DEVIATIONS.md").read_text()
    tests = SRC.parents[1] / "tests"
    named, current = [], None
    for hit in re.finditer(r"`(tests/[\w/]+\.py)?::(test_\w+)", text):
        current = hit.group(1) or current
        named.append((current, hit.group(2)))
    assert len(named) > 30
    for path, name in named:
        assert path is not None and f"def {name}(" in (tests.parent / path).read_text(), (path, name)
    assert "`fused_row_update`'s bits depend on alignment" in text
    assert "test_fused_row_update_scalar_instance_at_a_storage_offset" in text
    assert f"{smem_bytes(128, 128, 128):,} B at Q, N, P = 128, 128, 128" in text
    assert "208 KB" not in text


# The reference packages the port has done (ROADMAP A1-A14, A15a-A15d),
# and the public names of theirs the port leaves out on purpose, each with
# the text of its recorded deviation in DEVIATIONS.md.
DONE_PACKAGES = ("core", "sim", "obs", "checkpoint", "serve", "models", "configs", "data",
                 "kernels", "optim", "utils", "launch", "roofline")
RECORDED_ABSENT = {
    "sim.SimState.key": "`.generator` in place of `.key` / `keys`",
    "sim.ShardedSimState.keys": "`.generator` in place of `.key` / `keys`",
    "roofline.analyze_compiled": "`analyze_traced` in place of `analyze_compiled`",
}
# The ``init_*`` functions of ``repro.models`` whose port is a module class
# drawing from a generator, with their deviation's text.
MODELS_ABSENT = {f"models.{k}": "`init_*` functions are module constructors" for k in (
    "attention.init_attention", "layers.init_dense", "layers.init_rmsnorm", "layers.init_swiglu",
    "layers.init_embedding", "moe.init_moe", "ssm.init_mamba2", "xlstm.init_mlstm",
    "xlstm.init_slstm")}
# The modules of ``repro.models`` and ``repro.launch`` not ported yet, each
# with the text of the DEVIATIONS.md row naming its ROADMAP item: none since
# A15d (the mesh, sharding, dry-run and hill-climb modules).
MODULES_WAITING = {}
# The reference modules whose import sets XLA_FLAGS for 512 host devices.
SET_XLA_FLAGS = ("launch.dryrun", "launch.hillclimb")
# The functions and classes ``repro.core.spmd`` defines that the port's
# ``core/spmd.py`` leaves out, with their deviation's text: none since A15d.
SPMD_ABSENT = {}


def test_every_public_name_of_a_done_reference_package_is_ported_or_recorded():
    """Each public name of a done reference package, and each public member
    of its public classes, exists in the port's package, or is listed in
    ``RECORDED_ABSENT`` with its deviation's text in DEVIATIONS.md."""
    import importlib
    import inspect

    absent = set()
    for pkg in DONE_PACKAGES:
        ref = importlib.import_module(f"repro.{pkg}")
        port = importlib.import_module(f"repro_torch.{pkg}")
        if getattr(ref, "__file__", None) is None:
            # A namespace package (``repro.launch``): its names are its
            # modules, each ported (their contents are checked below).
            mods = {m.name for m in pkgutil.iter_modules(ref.__path__)}
            absent.update(f"{pkg}.{m}" for m in mods
                          if not (SRC / pkg / f"{m}.py").exists())
            continue
        names = getattr(ref, "__all__", None) or [k for k in dir(ref) if not k.startswith("_")]
        for name in names:
            if not hasattr(port, name):
                absent.add(f"{pkg}.{name}")
                continue
            cls, mine = getattr(ref, name), getattr(port, name)
            if inspect.isclass(cls):
                absent.update(f"{pkg}.{name}.{k}" for k in dir(cls)
                              if not k.startswith("_") and not hasattr(mine, k))
    assert absent == set(RECORDED_ABSENT)
    text = (SRC / "DEVIATIONS.md").read_text()
    for why in RECORDED_ABSENT.values():
        assert why in text
    # The members a repair added: reachable on the port's classes.
    from repro_torch.core import AgentData, Objective
    from repro_torch.sim import AsyncEngine, ShardedAsyncEngine

    for cls, member in ((AgentData, "from_lists"), (Objective, "grad_check"),
                        (AsyncEngine, "phase_program"), (AsyncEngine, "phase_names"),
                        (ShardedAsyncEngine, "phase_program"),
                        (ShardedAsyncEngine, "phase_names")):
        assert hasattr(cls, member)
    # The modules of repro.models and repro.launch: each function and class
    # a ported module defines is in its port, or recorded; each module not
    # ported yet waits for its ROADMAP item.
    import repro.launch
    import repro.models

    text = (SRC / "DEVIATIONS.md").read_text()
    for pkg, ref_pkg in (("models", repro.models), ("launch", repro.launch)):
        for info in pkgutil.iter_modules(ref_pkg.__path__):
            name = f"{pkg}.{info.name}"
            if name in MODULES_WAITING:
                assert not (SRC / pkg / f"{info.name}.py").exists(), name
                assert MODULES_WAITING[name] in text, name
                continue
            if name in SET_XLA_FLAGS:
                # Importing these sets the reference's 512-device flag: their
                # top-level functions and classes are read from the source.
                tree = ast.parse((SRC.parent / "repro" / pkg / f"{info.name}.py").read_text())
                port = importlib.import_module(f"repro_torch.{name}")
                defined = {n.name for n in tree.body
                           if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                           and not n.name.startswith("_")}
                assert defined and all(hasattr(port, k) for k in defined), name
                continue
            ref = importlib.import_module(f"repro.{name}")
            port = importlib.import_module(f"repro_torch.{name}")
            defined = {k for k, v in vars(ref).items() if not k.startswith("_")
                       and (inspect.isfunction(v) or inspect.isclass(v))
                       and v.__module__ == ref.__name__}
            missing = {f"{name}.{k}" for k in defined if not hasattr(port, k)}
            assert missing <= set(MODELS_ABSENT), missing
            for why in (MODELS_ABSENT[k] for k in missing):
                assert why in text
    assert MODULES_WAITING == {}


def test_every_function_of_the_reference_spmd_is_ported_or_recorded():
    """Each function and class ``repro.core.spmd`` defines (the private
    ``_ring_perm`` and ``_tree_norm`` included) is in the port's
    ``core.spmd``, or listed in ``SPMD_ABSENT`` with its deviation's text."""
    import inspect

    from repro.core import spmd as ref
    from repro_torch.core import spmd as port

    defined = {name for name, obj in vars(ref).items()
               if (inspect.isfunction(obj) or inspect.isclass(obj))
               and obj.__module__ == ref.__name__}
    assert {"make_train_step", "make_fedavg_step", "gossip_ppermute", "clip_and_noise",
            "P2PPlan", "_ring_perm", "_tree_norm"} <= defined
    absent = {name for name in defined if not hasattr(port, name)}
    assert absent == set(SPMD_ABSENT) == set()
    assert {"shardings_for", "jit_train_step"} <= defined
    text = (SRC / "DEVIATIONS.md").read_text()
    for why in SPMD_ABSENT.values():
        assert why in text


def test_from_lists_and_grad_check_match_the_reference():
    import numpy as np

    from repro.core import AgentData as JAgentData
    from repro.core import make_objective as jmake
    from repro.core import ring_graph as jring
    from repro_torch.convert import objective_from_reference
    from repro_torch.core import AgentData

    rng = np.random.default_rng(3)
    Xs = [rng.normal(size=(m, 3)) for m in (2, 0, 4)]
    ys = [rng.normal(size=m) for m in (2, 0, 4)]
    got, want = AgentData.from_lists(Xs, ys), JAgentData.from_lists(Xs, ys)
    for name in ("X", "y", "mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    ref = jmake(jring(3), want, "quadratic", mu=0.5)
    port = objective_from_reference(ref)
    Theta = rng.normal(size=(3, 3))
    # Both finite-difference errors are rounding-sized; the port's float64
    # block gradient is the reference's within 1e-10 (DEVIATIONS.md).
    assert port.grad_check(Theta) < 1e-6 and ref.grad_check(Theta) < 1e-6
