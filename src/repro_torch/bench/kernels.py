"""Kernel micro-bench on the port: each CUDA kernel against its plain version.

Port of ``benchmarks/bench_kernels.py``, at its four shapes and on its
numpy-seeded inputs:

* ``dp_clip_noise`` on (256, 4096) float32 per-example gradients (clip
  1.0, noise scale 0.1, Laplace noise);
* ``graph_mix``, a 64 x 64 mixing matrix times a 64 x 8192 Theta;
* ``ssm_chunk`` at G = 8 groups, Q = 128, N = P = 64, float32;
* ``fused_row_update`` at B = 256 woken rows, K = 16 neighbours, m = 4
  points, p = 128, over a 4,096-row slab.

On the CPU only the plain versions run, under the reference's oracle row
names (``<kernel>_ref_<shape>``, host clock, us). On a CUDA device each
kernel is checked against its plain version on the same inputs within
the tolerance of ``src/repro_torch/DEVIATIONS.md`` (1e-5, 2e-5 for
``fused_row_update`` and ``ssm_chunk``, relative to max(1, max |plain|))
and both are timed with CUDA events; the kernel rows take the
reference's kernel-row names (``<kernel>_<shape>``), and where one
PyTorch call computes the same function (``torch.matmul`` with TF32 off,
for ``graph_mix``) it is timed too (``graph_mix_library_64x8192``).
:func:`measure` returns each kernel's error, times and bound (the larger
of its bytes over 3.35 TB/s and its float32 flops over 67 TFLOP/s).

    python -m repro_torch.bench.kernels [--device D] [--out PATH]

``--fast`` changes nothing (the reference bench has one size). The rows
merge into ``results/BENCH_torch_summary.json`` under ``kernels``.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

from repro_torch.bench import parser, write_row
from repro_torch.obs.roofline import F32_FLOP_PER_S, HBM_BYTES_PER_S

# max |kernel - plain| allowed, relative to max(1, max |plain|)
TOL = {"dp_clip_noise": 1e-5, "graph_mix": 1e-5, "ssm_chunk": 2e-5, "fused_row_update": 2e-5}
SPIN_CYCLES = 40_000_000  # ~20 ms at the H100's ~2 GHz: the card busy while calls are queued


def _inputs(device):
    """The reference bench's inputs, drawn in its order from
    ``default_rng(0)``, as float32/int32 tensors on ``device``."""
    import torch

    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    grads = t(rng.normal(size=(256, 4096)))
    noise = t(rng.laplace(size=(4096,)))
    mix = t(rng.random((64, 64)))
    theta = t(rng.normal(size=(64, 8192)))
    G, Q, N, Pd = 8, 128, 64, 64
    C = t(rng.normal(size=(G, Q, N)))
    Bm = t(rng.normal(size=(G, Q, N)))
    cum = t(np.cumsum(-np.abs(rng.normal(size=(G, Q)) * 0.1), 1))
    dt = t(np.abs(rng.normal(size=(G, Q))))
    x = t(rng.normal(size=(G, Q, Pd)))
    Bf, K, m, p, nt = 256, 16, 4, 128, 4096
    frows = t(rng.choice(nt, size=Bf, replace=False), torch.int32)
    fidx = t(rng.integers(0, nt, size=(Bf, K)), torch.int32)
    fw = t(rng.random((Bf, K)))
    coef = t(np.stack([np.full(Bf, 0.5), np.full(Bf, float(K)), np.full(Bf, 0.1),
                       np.full(Bf, 0.2)], 1))
    fX = t(rng.normal(size=(Bf, m, p)))
    fy = t(rng.normal(size=(Bf, m)))
    fmask = torch.ones((Bf, m), dtype=torch.float32, device=device)
    fnoise = torch.zeros((Bf, p), dtype=torch.float32, device=device)
    ftheta = t(rng.normal(size=(nt, p)))
    real = int((fw != 0).sum())
    rows_read = int(torch.unique(torch.cat([fidx[fw != 0], frows])).numel())
    tri = Q * (Q + 1) / 2
    return {
        "dp_clip_noise": dict(
            shape="256x4096", args=(grads, noise, 1.0, 0.1),
            nbytes=(256 * 4096 + 2 * 4096) * 4, flops=4.0 * 256 * 4096),
        "graph_mix": dict(
            shape="64x8192", args=(mix, theta),
            nbytes=(64 * 64 + 2 * 64 * 8192) * 4, flops=2.0 * 64 * 64 * 8192),
        "ssm_chunk": dict(
            shape="8x128", args=(C, Bm, cum, dt, x),
            nbytes=(2 * G * Q * N + G * Q * Pd + 2 * G * Q + G * Q * Pd + G * Pd * N) * 4,
            flops=2.0 * (G * tri * N + G * tri * Pd + G * Q * Pd * N)),
        "fused_row_update": dict(
            shape="256x128", args=(frows, fidx, fw, coef, fX, fy, fmask, fnoise), theta=ftheta,
            limit=nt,
            # row inputs and the noise once, each distinct slab row read
            # (neighbours and the woken rows), the new rows written
            nbytes=(Bf * (4 + 2 * K * 4 + 16 + m * p * 4 + 2 * m * 4 + p * 4)
                    + rows_read * p * 4 + Bf * p * 4),
            flops=2.0 * real * p + Bf * (4.0 * m * p + 8.0 * p)),
    }


def _calls(name, case):
    """(kernel call, plain call) for one case; the fused update writes
    into a slab of its own for each."""
    from repro_torch.kernels import ops, ref

    if name == "fused_row_update":
        slab_k, slab_p = case["theta"].clone(), case["theta"].clone()
        a, lim = case["args"], case["limit"]
        return (lambda: ops.fused_row_update(*a, slab_k, lim),
                lambda: ref.fused_row_update_ref(*a, slab_p, lim))
    fk = getattr(ops, name)
    fp = getattr(ref, f"{name}_ref")
    return (lambda: fk(*case["args"])), (lambda: fp(*case["args"]))


def _flat(out):
    import torch

    return torch.cat([t.flatten() for t in out]) if isinstance(out, tuple) else out.flatten()


def _host_us(fn, iters=5) -> float:
    """The reference's timer: one warm call, then ``iters`` calls (us)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def _device_ms(fn, calls: int = 20, runs: int = 7) -> float:
    """Device time of one call: CUDA events around ``calls`` calls queued
    behind a spin kernel, over the count; the median of ``runs``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def measure(device="cuda") -> dict:
    """Per kernel: the shape, the plain version's time and, on a CUDA
    device, the kernel's time, its max |kernel - plain| (raising beyond
    ``TOL``), the library call's time where one exists, the bytes, flops
    and bound. Times in ms (CUDA events) on the card, host us on the CPU."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    out = {}
    for name, case in _inputs(dev).items():
        kernel, plain = _calls(name, case)
        bytes_ms = case["nbytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = case["flops"] / F32_FLOP_PER_S * 1e3
        row = dict(shape=case["shape"], nbytes=case["nbytes"], flops=case["flops"],
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        if not cuda:
            row["plain_us"] = _host_us(plain)
            out[name] = row
            continue
        got, want = _flat(kernel()), _flat(plain())
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        if not (bool(torch.isfinite(got).all()) and err <= TOL[name] * scale):
            raise AssertionError(f"{name} at {case['shape']}: kernel disagrees with its plain "
                                 f"version (max |err| {err} > {TOL[name]} x {scale})")
        row.update(max_abs_err=err, tol=TOL[name] * scale, ms=_device_ms(kernel),
                   plain_ms=_device_ms(plain), library_ms=None)
        if name == "graph_mix":
            mix, theta = case["args"]
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False  # the kernel's full float32
            try:
                row["library_ms"] = _device_ms(lambda: torch.matmul(mix, theta))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
        out[name] = row
    return out


def bench_rows(res: dict) -> list:
    """:func:`measure`'s dict as the reference's ``(name, us, note)`` rows."""
    rows = []
    for name, r in res.items():
        if "plain_us" in r:
            rows.append((f"{name}_ref_{r['shape']}", r["plain_us"], "plain PyTorch, host clock"))
            continue
        rows.append((f"{name}_ref_{r['shape']}", r["plain_ms"] * 1e3,
                     "plain PyTorch, CUDA events"))
        rows.append((f"{name}_{r['shape']}", r["ms"] * 1e3,
                     f"CUDA kernel, max_abs_err={r['max_abs_err']:.3g}, "
                     f"bound={r['bound_ms'] * 1e3:.4g}us ({r['bound_by']})"))
        if r["library_ms"] is not None:
            rows.append((f"{name}_library_{r['shape']}", r["library_ms"] * 1e3,
                         "torch.matmul, TF32 off"))
    return rows


def run(device="cuda", verbose=True, out=None):
    """Returns the ``(name, us, note)`` rows (merged into ``out`` when given)."""
    rows = bench_rows(measure(device))
    if verbose:
        for name, us, note in rows:
            print(f"{name},{us:.1f},{note}")
    if out is not None:
        write_row(out, "kernels", {"device": str(device),
                                   "rows": [[k, float(v), note] for k, v, note in rows]})
    return rows


def main(argv=None):
    """CLI entry point."""
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    run(device=args.device, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
