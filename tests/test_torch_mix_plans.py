"""The launch planning of the graph_mix and sparse_mix kernels, in Python.

The CUDA kernels run only on a card, but what surrounds them is planned
here and reached by these CPU tests:

* ``graph_mix.split_plan``: the contraction [0, n) cut into parts, each a
  multiple of the kernel's 8-step stage, covering [0, n) exactly and in
  order; the partial products summed in rank order agree with the JAX
  Pallas kernel (interpret mode) to 1e-5 of the largest output, the
  CUDA kernels' bound against their plain versions (sums over up to 384
  terms of magnitude up to 20, in another order);
* the 16-byte (float4) instances of both kernels are chosen exactly when
  p is a multiple of 4 floats and Theta starts on a 16-byte boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, graph_mix

KTOL = 4e-6
SPLIT_TOL = 1e-5  # relative to max(1, max |Y|): the CUDA kernels' bound against plain


@pytest.mark.parametrize("p,sms", [(1, 132), (100, 132), (300, 132), (100, 16), (257, 1)])
def test_split_plan_covers_the_contraction_in_order(p, sms):
    for n in range(1, 4097):
        plan = graph_mix.split_plan(n, p, sms)
        bounds = plan.bounds(n)
        assert len(bounds) == plan.splits >= 1
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a < b for a, b in bounds)  # no empty part
        assert all(b == c for (_, b), (c, _) in zip(bounds, bounds[1:]))  # contiguous, in order
        assert plan.chunk % graph_mix.TILE_K == 0
        tiles = -(-n // graph_mix.TILE_M) * -(-p // graph_mix.TILE_N)
        assert plan.splits == 1 or plan.splits * tiles <= sms  # one wave, one block an SM


def test_split_plan_at_the_dense_main_path():
    # n = 2047, p = 100: 16 row tiles, 8 parts of 256 steps, 128 blocks on 132 SMs.
    plan = graph_mix.split_plan(2047, 100, 132)
    assert plan == graph_mix.SplitPlan(splits=8, chunk=256)
    assert plan.bounds(2047)[-1] == (1792, 2047)
    assert graph_mix.split_plan(5000, 100, 132).splits == 3  # 40 row tiles
    assert graph_mix.split_plan(600, 300, 132).splits == 8  # 15 tiles: 8 parts of 80 steps
    assert graph_mix.split_plan(40, 100, 132).splits == 1  # shorter than one part


@pytest.mark.parametrize("n,p", [(100, 8), (128, 37), (256, 37), (384, 129)])
def test_split_partials_summed_in_rank_order_match_pallas(n, p):
    """The kernel's arithmetic order, written out: each part's partial
    product, then the parts added in rank order. (The Pallas kernel takes
    n <= 128 or a multiple of its 128-step contraction tile.)"""
    rng = np.random.default_rng(n + p)
    A = rng.random((n, n)).astype(np.float32)
    theta = rng.normal(size=(n, p)).astype(np.float32)
    plan = graph_mix.split_plan(n, p, 132)
    assert plan.splits > 1
    At, tt = torch.as_tensor(A), torch.as_tensor(theta)
    parts = [At[:, a:b] @ tt[a:b] for a, b in plan.bounds(n)]
    got = parts[0]
    for part in parts[1:]:
        got = got + part
    want = np.asarray(jops.graph_mix(jnp.asarray(A), jnp.asarray(theta), interpret=True))
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= SPLIT_TOL * scale


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 8, 31, 100, 101, 128])
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_vector_instances_are_picked_exactly_when_aligned(p, offset):
    """Both wrappers ask _build.vector_loads: 16-byte loads of Theta exactly
    when p % 4 == 0 and Theta starts on a 16-byte boundary (a storage
    offset of a multiple of 4 floats from an aligned buffer)."""
    buf = torch.zeros(16 * p + 8)
    assert buf.data_ptr() % 16 == 0
    theta = buf[offset:offset + 16 * p].view(16, p)
    assert theta.is_contiguous() and theta.storage_offset() == offset
    want = p % 4 == 0 and offset % 4 == 0
    assert _build.vector_loads(theta) == want
