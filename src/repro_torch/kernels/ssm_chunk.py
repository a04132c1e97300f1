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

The CUDA kernel is ``csrc/ssm_chunk.cu``: one block per (batch, chunk,
group of ``hg`` heads), which computes C.B^T once and reuses it for its
heads, every output summed in a fixed order (a second launch gives the
same bits, whatever ``hg`` is). :func:`head_plan` picks ``hg`` here, in
Python, so the CPU tests reach it. :func:`ssm_chunk_plain` is the plain
PyTorch version: the CPU path and the kernel's yardstick.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_Q = 128  # chunk length
MAX_N = 128  # state width
MAX_P = 128  # head width
SMEM_PER_SM = 233472  # the shared memory of an H100 SM, bytes
SMEM_RESERVED = 1024  # the runtime's share of it per resident block


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one block (``csrc/ssm_chunk.cu``
    ``layout_of``): B, the triangular S, one head's x, its cum, dt and end
    weights; C is staged over S and x first."""
    Qp = -(-Q // 16) * 16
    nb = Qp // 16
    ldb = -(-N // 32) * 32 + 4
    Px = 32 if P <= 32 else 64 if P <= 64 else 128
    off_x = Qp * ldb + 128 * nb * (nb + 1)
    end = off_x + Qp * Px + 3 * Qp
    return 4 * max(end, 2 * Qp * ldb)


def blocks_per_sm(Q: int, N: int, P: int) -> int:
    """Blocks an SM holds at once: two where P <= 64 (the kernel is built
    for two, at most 128 registers a thread) and their shared memory fits,
    else one."""
    if P <= 64 and 2 * (smem_bytes(Q, N, P) + SMEM_RESERVED) <= SMEM_PER_SM:
        return 2
    return 1


def head_plan(G: int, heads: int, sms: int, Q: int, N: int, P: int) -> int:
    """Heads per block ``hg``: the divisor of ``heads`` with the least
    estimated time, waves x (hg + share), where a wave is
    ``blocks_per_sm * sms`` blocks and ``share`` is C.B^T's work in units
    of one head's (C.B^T is computed once a block); ties go to more blocks.

    A larger hg computes C.B^T fewer times, but leaves fewer blocks: at the
    zamba2 prefill (G = 4096, 64 heads, Q = 128, N = P = 64, 132 SMs, two
    blocks an SM, share 0.5) hg = 16 gives 256 blocks, one wave; hg = 8 two
    waves of 8.5 heads' work, hg = 32 one of 32.5.
    """
    if G < 1 or heads < 1 or G % heads:
        raise ValueError(f"heads={heads} must divide the group count G={G} >= 1")
    tri = Q * (Q + 1) / 2
    share = tri * N / (tri * P + Q * P * N)
    slots = blocks_per_sm(Q, N, P) * sms

    def cost(hg):
        return -(-(G // hg) // slots) * (hg + share)

    return min((d for d in range(1, heads + 1) if heads % d == 0), key=lambda d: (cost(d), d))


def blocks_of(G: int, hg: int) -> list[list[int]]:
    """The groups each block computes, in launch order: block k takes the
    hg consecutive groups from k * hg (``csrc/ssm_chunk.cu``: block k's
    C/B block is k * hg // heads)."""
    return [list(range(k * hg, (k + 1) * hg)) for k in range(G // hg)]


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


def vector_copies(x) -> bool:
    """Whether the kernel may copy x's rows 16 bytes at a time with
    cp.async: float32, P % 4 == 0, and a start on a 16-byte boundary. The
    kernel loads x with plain (widening) loads otherwise."""
    return x.dtype == torch.float32 and x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def ssm_chunk_cuda(C, B, cum, dt, x, heads: int = 1, head_group: int | None = None):
    """Launch the CUDA kernel. C, B (G / heads, Q, N) and x (G, Q, P) all
    float32 or all bfloat16; cum, dt (G, Q) float32; contiguous, on one
    CUDA device; 1 <= Q, N, P <= 128 and ``heads`` dividing G >= 1.
    ``head_group`` (a divisor of ``heads``) overrides :func:`head_plan`'s
    heads per block; the results are the same bits either way."""
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
    if head_group is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        head_group = head_plan(G, heads, sms, Q, N, P)
    elif head_group < 1 or heads % head_group:
        raise ValueError(f"head_group={head_group} must divide heads={heads}")
    y = torch.empty((G, Q, P), dtype=torch.float32, device=dev)
    s_loc = torch.empty((G, P, N), dtype=torch.float32, device=dev)
    fn = _build.bind("ssm_chunk", "ssm_chunk_launch", _ARGTYPES)
    with _build.on_device(dev):
        status = fn(C.data_ptr(), B.data_ptr(), cum.data_ptr(), dt.data_ptr(), x.data_ptr(),
                    y.data_ptr(), s_loc.data_ptr(), G, Q, N, P, heads, head_group,
                    int(x.dtype == torch.bfloat16), int(vector_copies(x)), _build.stream_of(dev))
    _build.finish_launch("ssm_chunk", status)
    return y, s_loc
