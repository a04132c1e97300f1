"""Mamba2 intra-chunk SSD: the causal chunk output and the chunk-end state.

Port of ``repro/kernels/ssm_scan.py::ssm_chunk``. For each group g (one
batch row, chunk and SSM head) over the Q positions of a chunk:

    y[g,q,p]     = sum_{t<=q} (C[q].B[t]) exp(clip(cum[q]-cum[t], -60, 0)) dt[t] x[t,p]
    s_loc[g,p,n] = sum_t exp(clip(cum[Q-1]-cum[t], -60, 0)) dt[t] x[t,p] B[t,n]

in float32. ``heads`` is the number of consecutive groups that share one
block of C and B: C and B are (G / heads, Q, N), and group g reads block
g // heads. ``heads=1`` is the reference's (G, Q, N) layout; the Mamba2
block passes its (batch * chunks, Q, N) tensors with its head count, so
they are never copied once per head.

The CUDA kernel is ``csrc/ssm_chunk.cu`` (one block per group, summing
in a fixed order: a second launch gives the same bits);
:func:`ssm_chunk_plain` is the plain PyTorch version: the CPU path and the
kernel's yardstick.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_Q = 128  # chunk length
MAX_N = 128  # state width
MAX_P = 128  # head width


def ssm_chunk_plain(C, B, cum, dt, x, heads: int = 1):
    """C, B (G / heads, Q, N); cum, dt (G, Q); x (G, Q, P), any float type
    -> y (G, Q, P), s_loc (G, P, N), float32."""
    f32 = torch.float32
    Gc, Q, N = C.shape
    G, _, P = x.shape
    C, B = C.to(f32), B.to(f32)
    cum = cum.to(f32).reshape(Gc, heads, Q)
    dt = dt.to(f32).reshape(Gc, heads, Q)
    x = x.to(f32).reshape(Gc, heads, Q, P)
    cb = torch.einsum("gqn,gtn->gqt", C, B)[:, None]  # (Gc, 1, Q, Q)
    decay = torch.exp(torch.clamp(cum[..., :, None] - cum[..., None, :], -60.0, 0.0))
    causal = torch.ones((Q, Q), dtype=torch.bool, device=C.device).tril()
    scores = torch.where(causal, cb * decay * dt[..., None, :], 0.0)
    y = scores @ x
    w_end = torch.exp(torch.clamp(cum[..., -1:] - cum, -60.0, 0.0)) * dt
    s_loc = (w_end[..., None] * x).transpose(-1, -2) @ B[:, None]
    return y.reshape(G, Q, P), s_loc.reshape(G, P, N)


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def ssm_chunk_cuda(C, B, cum, dt, x, heads: int = 1):
    """Launch the CUDA kernel. C, B (G / heads, Q, N) and x (G, Q, P) all
    float32 or all bfloat16; cum, dt (G, Q) float32; contiguous, on one
    CUDA device; 1 <= Q, N, P <= 128 and ``heads`` dividing G >= 1."""
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _build.check_tensor(x, "x", dtype=x.dtype, ndim=3, device=dev)
    G, Q, P = x.shape
    if heads < 1 or G < 1 or G % heads:
        raise ValueError(f"heads={heads} must divide the group count G={G} >= 1")
    if not (1 <= Q <= MAX_Q and 1 <= P <= MAX_P):
        raise ValueError(f"ssm_chunk takes Q <= {MAX_Q} and P <= {MAX_P}, got Q={Q}, P={P}")
    _build.check_tensor(C, "C", dtype=x.dtype, ndim=3, device=dev)
    N = C.shape[2]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"ssm_chunk takes N <= {MAX_N}, got N={N}")
    _build.check_tensor(C, "C", dtype=x.dtype, ndim=3, device=dev, shape=(G // heads, Q, N))
    _build.check_tensor(B, "B", dtype=x.dtype, ndim=3, device=dev, shape=(G // heads, Q, N))
    _build.check_tensor(cum, "cum", dtype=torch.float32, ndim=2, device=dev, shape=(G, Q))
    _build.check_tensor(dt, "dt", dtype=torch.float32, ndim=2, device=dev, shape=(G, Q))
    y = torch.empty((G, Q, P), dtype=torch.float32, device=dev)
    s_loc = torch.empty((G, P, N), dtype=torch.float32, device=dev)
    fn = _build.bind("ssm_chunk", "ssm_chunk_launch", _ARGTYPES)
    with _build.on_device(dev):
        status = fn(C.data_ptr(), B.data_ptr(), cum.data_ptr(), dt.data_ptr(), x.data_ptr(),
                    y.data_ptr(), s_loc.data_ptr(), G, Q, N, P, heads,
                    int(x.dtype == torch.bfloat16), _build.stream_of(dev))
    _build.finish_launch("ssm_chunk", status)
    return y, s_loc
