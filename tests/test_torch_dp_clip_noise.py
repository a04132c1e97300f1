"""repro_torch's dp_clip_noise (its plain version, the CPU path) against
the reference's Pallas kernel run with ``interpret=True`` and its
``ref.dp_clip_noise_ref``, at the reference's own test shapes
(``tests/test_kernels.py``). Tolerance 1e-5 for float32 gradients, 3e-2
for bfloat16 (the reference's bounds: both sides read the same bf16
values, the Pallas kernel sums them per tile in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref


def _inputs(N, D, dtype, seed):
    rng = np.random.default_rng(seed)
    grads = jnp.asarray(rng.normal(size=(N, D)) * 3.0, dtype)
    noise = jnp.asarray(rng.laplace(size=(D,)), jnp.float32)
    tgrads = torch.tensor(np.asarray(grads.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        tgrads = tgrads.to(torch.bfloat16)  # exact: the values are bf16 already
    return grads, noise, tgrads, torch.tensor(np.asarray(noise))


@pytest.mark.parametrize("N,D", [(8, 128), (33, 200), (128, 512), (200, 1000), (1, 128)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_pallas_and_reference(N, D, dtype):
    grads, noise, tg, tn = _inputs(N, D, dtype, N * 1000 + D)
    clip, s = 1.5, 0.37
    ops.reset_launch_counts()
    got = ops.dp_clip_noise(tg, tn, clip, s)
    assert ops.launch_counts()["dp_clip_noise"] == 0  # a CPU tensor takes the plain version
    assert got.dtype == torch.float32 and got.shape == (D,)
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    for want in (jops.dp_clip_noise(grads, noise, clip, s, interpret=True),
                 jref.dp_clip_noise_ref(grads, noise, clip, s)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_array_equal(ref.dp_clip_noise_ref(tg, tn, clip, s).numpy(), got.numpy())


def test_clips_every_row():
    """With zero noise the output's norm is at most the clip."""
    rng = np.random.default_rng(0)
    grads = torch.as_tensor(rng.normal(size=(16, 256)) * 100.0, dtype=torch.float32)
    out = ops.dp_clip_noise(grads, torch.zeros(256), 1.0, 0.0)
    assert float(torch.linalg.norm(out)) <= 1.0 + 1e-5
    small = grads * 1e-4  # rows under the clip pass unscaled: the plain mean
    torch.testing.assert_close(ops.dp_clip_noise(small, torch.zeros(256), 1e3, 0.0),
                               small.mean(dim=0), rtol=1e-6, atol=1e-7)
    zero = ops.dp_clip_noise(torch.zeros(3, 5), torch.ones(5), 1.0, 0.5)
    torch.testing.assert_close(zero, torch.full((5,), 0.5))
