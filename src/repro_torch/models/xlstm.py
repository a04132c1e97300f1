"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, sequential) with exponential gating + stabilizers.

Port of ``repro/models/xlstm.py``. The mLSTM forward is the chunkwise form
(quadratic within chunks of ``cfg.xlstm.chunk`` positions, recurrent across
them), its inter-chunk scan a Python loop over the chunks; the sLSTM
forward is one autograd Function over time (:class:`SLSTMScan`) where the
reference has a ``lax.scan``: Python loops on the CPU, captured CUDA
graphs of ``SCAN_CHUNK`` steps on the card, forward and backward. Both
decode one token from an O(1) state.

Cast points, as in the reference: the projections run in the model type;
``q``, ``k``, ``v`` and the gates are float32 (``igate``/``fgate`` and the
sLSTM ``bias`` are float32 parameters in any model type, so their inputs
are promoted as JAX promotes them); ``y`` is cast back before the norm.

The reference's ``jnp.maximum``/``jnp.max`` split the gradient between
tied operands; ``torch.maximum`` and ``amax`` do the same, ``torch.clamp``
and ``max(dim)`` do not, so neither appears here. The sLSTM's
``h / max(n, 1)`` ties at the first step on every head whose input gate
sets the stabilizer (``n = exp(0) = 1`` on its largest lane). The
stabilizers are differentiated through, as in the reference.

The sLSTM time scan hoists out of the step what gives the same values:
the float32 cast of the recurrent weights ``r`` and of the input
projection, laid out heads first once a call, so that a step is 23
operations; the bias is still added after the recurrent term,
``(x + rec) + bias``, the reference's order.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, RMSNorm, dense, normal_, rms_norm
from repro_torch.models.sharding import einsum  # torch.einsum off a mesh
from repro_torch.roofline.counter import active_counter

F32 = torch.float32


def _dims(cfg):
    """(d_inner, heads, mLSTM head size)."""
    di = int(cfg.xlstm.proj_factor * cfg.d_model)
    return di, cfg.num_heads, di // cfg.num_heads


def _dense32(p: Dense, x):
    """A float32 projection (``igate``/``fgate``) of ``x`` in any type: the
    input promoted to float32 first, as JAX promotes a bf16 @ f32 product."""
    return dense(p, x.to(F32))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """The reference's ``init_mlstm`` tree: ``up`` (d -> 2 di: [x_in, z
    gate]), ``q``/``k``/``v`` (di -> di), ``igate``/``fgate`` (di -> heads,
    float32), ``down`` (di -> d) and ``norm`` (di)."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d = cfg.d_model
        di, H, _ = _dims(cfg)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.up = Dense(d, 2 * di, **kw)
        self.q = Dense(di, di, **kw)
        self.k = Dense(di, di, **kw)
        self.v = Dense(di, di, **kw)
        self.igate = Dense(di, H, device=device, dtype=F32, generator=generator)
        self.fgate = Dense(di, H, device=device, dtype=F32, generator=generator)
        self.down = Dense(di, d, **kw)
        self.norm = RMSNorm(di, **kw)


def _mlstm_inputs(params: MLSTM, xin, cfg):
    """The projections of ``xin`` (..., d): q, k (scaled by 1/sqrt(hd)), v
    as (..., H, hd) float32, the log input gate and the log forget gate
    (..., H) float32, and the output gate's ``z`` in the model type."""
    di, H, hd = _dims(cfg)
    up = dense(params.up, xin)
    xi, z = up[..., :di], up[..., di:]
    lead = xin.shape[:-1]
    q = dense(params.q, xi).reshape(*lead, H, hd).to(F32)
    k = dense(params.k, xi).reshape(*lead, H, hd).to(F32) / math.sqrt(hd)
    v = dense(params.v, xi).reshape(*lead, H, hd).to(F32)
    ig = _dense32(params.igate, xi)
    fg = F.logsigmoid(_dense32(params.fgate, xi))
    return q, k, v, ig, fg, z


def _mlstm_out(params: MLSTM, y, z, xin, cfg):
    """The block's output from the float32 cell output ``y``: cast back,
    normed, gated by silu(z), projected down."""
    y = rms_norm(params.norm, y.to(xin.dtype), cfg.norm_eps)
    return dense(params.down, y * F.silu(z))


_MLSTM_STATE = ("C", "n", "m")


def _mlstm_chunk_state(consts, xs, state):
    """The state after one chunk from the state entering it: C (B, H, hd,
    hd), n (B, H, hd) and the stabilizer m (B, H); ``xs`` the chunk's
    cumulative log forget gates, log input gates, keys, values and total
    log forget gate; no ``consts`` (a scan step's signature)."""
    cumc, igcc, kcc, vcc, totalc = xs
    w = cumc[:, -1][:, None] - cumc + igcc  # (B, Q, H): exp weight of k_t v_t
    m_loc = w.amax(dim=1)  # (B, H)
    m_prev = state["m"] + totalc
    m_new = torch.maximum(m_prev, m_loc)
    scale_prev = torch.exp(m_prev - m_new)  # (B, H)
    wexp = torch.exp(w - m_new[:, None, :])  # (B, Q, H)
    C_loc = einsum("bqhk,bqhv->bhkv", wexp[..., None] * kcc, vcc)
    n_loc = einsum("bqh,bqhk->bhk", wexp, kcc)
    return {"C": scale_prev[:, :, None, None] * state["C"] + C_loc,
            "n": scale_prev[:, :, None] * state["n"] + n_loc, "m": m_new}


def mlstm_forward(params: MLSTM, xin, cfg):
    """Chunkwise-parallel mLSTM. xin: (B, S, d) -> (B, S, d); S must be a
    multiple of the chunk (or shorter than one)."""
    di, H, hd = _dims(cfg)
    B, S, _ = xin.shape
    Q = min(cfg.xlstm.chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not divisible by chunk {Q}")
    nc = S // Q
    q, k, v, ig, fg, z = _mlstm_inputs(params, xin, cfg)

    qc = q.reshape(B, nc, Q, H, hd)
    kc = k.reshape(B, nc, Q, H, hd)
    vc = v.reshape(B, nc, Q, H, hd)
    igc = ig.reshape(B, nc, Q, H)
    cum = torch.cumsum(fg.reshape(B, nc, Q, H), dim=2)  # inclusive cumulative log forget
    total = cum[:, :, -1]  # (B, nc, H)

    # Intra-chunk: D[q, t] = exp(cum_q - cum_t + ig_t) for t <= q (log-space,
    # stabilized by the per-row max m).
    logD = cum[:, :, :, None, :] - cum[:, :, None, :, :] + igc[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xin.device).tril()[None, None, :, :, None]
    logD = torch.where(causal, logD, -math.inf)

    # Inter-chunk: the state entering each chunk, carrying its own
    # stabilizer m. The state after the last chunk is not needed.
    state = {"C": torch.zeros((B, H, hd, hd), dtype=F32, device=xin.device),
             "n": torch.zeros((B, H, hd), dtype=F32, device=xin.device),
             "m": torch.full((B, H), -1e30, dtype=F32, device=xin.device)}
    if active_counter() is None:
        entering = [state]
        for c in range(nc - 1):
            state = _mlstm_chunk_state((), (cum[:, c], igc[:, c], kc[:, c], vc[:, c],
                                            total[:, c]), state)
            entering.append(state)
        C_in, n_in, m_in = (torch.stack([e[k] for e in entering], dim=1)
                            for k in _MLSTM_STATE)
    else:  # counted (the dry-run): one Function, its steps weighted (see MLSTMChunkScan)
        after = MLSTMChunkScan.apply(*(t[:, :-1] for t in (cum, igc, kc, vc, total)),
                                     *state.values()) if nc > 1 else ()
        C_in, n_in, m_in = (torch.cat([state[k].unsqueeze(1), *after[i:i + 1]], dim=1)
                            for i, k in enumerate(_MLSTM_STATE))
    # C_in (B, nc, H, hd, hd), n_in (B, nc, H, hd), m_in (B, nc, H)

    # Stabilized combination of the intra and inter parts.
    finite = torch.isfinite(logD)
    m_intra = torch.where(finite, logD, -1e30).amax(dim=3)  # (B, nc, Q, H)
    m_inter = cum + m_in[:, :, None, :]  # log weight scale of the inter contribution
    m_row = torch.maximum(m_intra, m_inter)
    Dexp = torch.exp(torch.where(finite, logD - m_row[:, :, :, None, :], -math.inf))
    Dexp = torch.where(causal, Dexp, 0.0)

    qk = einsum("bcqhd,bcthd->bcqth", qc, kc)
    y_intra = einsum("bcqth,bcthv->bcqhv", qk * Dexp, vc)
    # normalizer: n = sum_t D_t k_t (+ inter part), denom = max(|q.n|, exp(-m))
    n_intra = einsum("bcqth,bcthd->bcqhd", Dexp, kc)

    w_inter = torch.exp(m_inter - m_row)  # (B, nc, Q, H)
    y_inter = einsum("bcqhd,bchdv->bcqhv", qc, C_in) * w_inter[..., None]
    n_inter = n_in[:, :, None, :, :] * w_inter[..., None]  # (B, nc, Q, H, hd)

    num = y_intra + y_inter
    nvec = n_intra + n_inter
    denom = torch.abs(einsum("bcqhd,bcqhd->bcqh", qc, nvec))
    denom = torch.maximum(denom, torch.exp(-m_row))  # xLSTM: max(|q.n|, exp(-m))
    y = (num / denom[..., None]).reshape(B, S, di)
    return _mlstm_out(params, y, z, xin, cfg)


def init_mlstm_cache(cfg, batch, device):
    """The recurrent state: C (B, H, hd, hd), n (B, H, hd), m (B, H) = -1e30."""
    _, H, hd = _dims(cfg)
    return {
        "C": torch.zeros((batch, H, hd, hd), dtype=F32, device=device),
        "n": torch.zeros((batch, H, hd), dtype=F32, device=device),
        "m": torch.full((batch, H), -1e30, dtype=F32, device=device),
    }


def mlstm_decode(params: MLSTM, xin, cfg, cache):
    """One-token recurrent mLSTM step. xin: (B, 1, d) -> ((B, 1, d), new cache)."""
    di, H, hd = _dims(cfg)
    B = xin.shape[0]
    q, k, v, ig, fg, z = _mlstm_inputs(params, xin[:, 0], cfg)

    m_prev = fg + cache["m"]
    m_new = torch.maximum(m_prev, ig)
    scale_prev = torch.exp(m_prev - m_new)
    scale_in = torch.exp(ig - m_new)
    C = scale_prev[:, :, None, None] * cache["C"] + scale_in[:, :, None, None] * einsum(
        "bhk,bhv->bhkv", k, v)
    n = scale_prev[:, :, None] * cache["n"] + scale_in[:, :, None] * k
    num = einsum("bhk,bhkv->bhv", q, C)
    denom = torch.maximum(torch.abs(einsum("bhk,bhk->bh", q, n)), torch.exp(-m_new))
    y = (num / denom[..., None]).reshape(B, di)
    return _mlstm_out(params, y, z, xin[:, 0], cfg)[:, None], {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """The reference's ``init_slstm`` tree: ``w_in`` (d -> 4 d: the gates i,
    f, z, o), ``r`` (4, heads, hd, hd) per-head block-diagonal recurrent
    weights drawn N(0, 1/hd), ``bias`` (4 d, float32, zero), ``down`` (d ->
    d) and ``norm`` (d)."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        hd = d // H
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.w_in = Dense(d, 4 * d, **kw)
        self.r = nn.Parameter(torch.empty((4, H, hd, hd), device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty((4 * d,), device=device, dtype=F32))
        self.down = Dense(d, d, **kw)
        self.norm = RMSNorm(d, **kw)
        if generator is not None:
            normal_(self.r, generator, 1.0 / math.sqrt(hd))
            with torch.no_grad():
                self.bias.zero_()


def init_slstm_cache(cfg, batch, device):
    """The recurrent state: c, n, h (B, H, hd) and the stabilizer m (B, H),
    all zero (m starts at 0, not at -1e30 as the mLSTM's does)."""
    H = cfg.num_heads
    hd = cfg.d_model // H
    z = lambda: torch.zeros((batch, H, hd), dtype=F32, device=device)  # noqa: E731
    return {"c": z(), "n": z(), "h": z(), "m": torch.zeros((batch, H), dtype=F32, device=device)}


def _step_constants(params: SLSTM, device):
    """What every time step reads, cast and laid out once: ``r`` as float32
    (H, hd, 4 hd), column g hd + v of head h being ``r[g, h, :, v]``, so
    ``h @ r`` gives every gate's recurrent term; the bias (H, 1, 4 hd); a
    float32 1.0 for ``max(n, 1)``."""
    g, H, hd, _ = params.r.shape
    r32 = params.r.to(F32).permute(1, 2, 0, 3).reshape(H, hd, g * hd)
    bias = params.bias.reshape(g, H, hd).transpose(0, 1).reshape(H, 1, g * hd)
    return r32, bias, torch.ones((), dtype=F32, device=device)


def _to_step(state):
    """A (B, H) state {c, n, h: (B, H, hd), m: (B, H)} as the step's views,
    heads leading: c, n, h (H, B, hd), m (H, B, 1)."""
    out = {k: state[k].transpose(0, 1) for k in ("c", "n", "h")}
    out["m"] = state["m"].transpose(0, 1)[..., None]
    return out


def _from_step(state):
    """The inverse of :func:`_to_step`."""
    out = {k: state[k].transpose(0, 1) for k in ("c", "n", "h")}
    out["m"] = state["m"][..., 0].transpose(0, 1)
    return out


def _slstm_step(r32, bias, xt, state, one):
    """One sLSTM time step, heads leading: ``r32``, ``bias`` and ``one``
    from :func:`_step_constants`, ``xt`` (H, B, 4 hd) the float32 input
    projection (gates i, f, z, o), ``state`` from :func:`_to_step`. The
    reference's ``_slstm_cell``, value for value, in 23 operations."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    it, ft, zt, ot = (xt + torch.bmm(h, r32) + bias).split(h.shape[-1], dim=-1)
    # Exponential gating with stabilizer state m (per head: the max over dims).
    it_s = it.amax(dim=-1, keepdim=True)  # (H, B, 1) head-level log input gate scale
    ft_m = F.logsigmoid(ft.mean(dim=-1, keepdim=True)) + m
    m_new = torch.maximum(ft_m, it_s)
    i_gate = torch.exp(it - m_new)
    f_gate = torch.exp(ft_m - m_new)
    c_new = f_gate * c + i_gate * torch.tanh(zt)
    n_new = f_gate * n + i_gate
    h_new = torch.sigmoid(ot) * c_new / torch.maximum(n_new, one)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _heads_first(x, cfg):
    """An input projection (..., 4 d) as (H, ..., 4 hd), gate-major within a
    head, float32 (a copy, then the cast: the reference's values)."""
    H = cfg.num_heads
    hd = cfg.d_model // H
    lead = x.shape[:-1]
    x = x.reshape(*lead, 4, H, hd).movedim(-2, 0)  # (H, ..., 4, hd)
    return x.reshape(H, *lead, 4 * hd).to(F32)


def _slstm_cell(params: SLSTM, cfg, xt, state):
    """One sLSTM time step. xt: (B, 4 d) pre-computed input projection;
    ``state`` {c, n, h: (B, H, hd), m: (B, H)}, returned likewise."""
    r32, bias, one = _step_constants(params, xt.device)
    return _from_step(_slstm_step(r32, bias, _heads_first(xt, cfg), _to_step(state), one))


# ---------------------------------------------------------------------------
# The sLSTM time scan: one autograd Function
# ---------------------------------------------------------------------------

SCAN_CHUNK = 64  # steps a captured graph runs (K); a shorter tail has a graph of its own
_STATE = ("c", "n", "h", "m")
_CAPTURED = [True]  # False inside eager_scan()


@contextlib.contextmanager
def eager_scan():
    """On the card, the scans started inside run their eager loops, forward
    and backward (the yardstick of the captured graphs). A scan reads the
    mode when its forward starts; its backward keeps it."""
    _CAPTURED.append(False)
    try:
        yield
    finally:
        _CAPTURED.pop()


def _same(t):
    return t


def _vjp(step, consts, xs_t, state, g_out):
    """One step's vector-Jacobian product, by autograd of ``step(consts,
    xs_t, state)`` recomputed on fresh leaves from its entering ``state``:
    ``(g consts, g xs_t, g state)`` for the gradients ``g_out`` of its
    output state (autograd's tie rules for ``amax`` and ``torch.maximum``,
    as the plain loop's backward has them). Outer saved-tensor hooks (a
    checkpoint's) are kept out."""
    keys = tuple(state)
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(_same, _same):
        c_in = [t.detach().requires_grad_() for t in consts]
        x_in = [t.detach().requires_grad_() for t in xs_t]
        st = {k: state[k].detach().requires_grad_() for k in keys}
        out = step(c_in, x_in, st)
        leaves = c_in + x_in + [st[k] for k in keys]
        grads = torch.autograd.grad([out[k] for k in keys], leaves, [g_out[k] for k in keys],
                                    allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g for g, v in zip(grads, leaves)]
    nc, nx = len(consts), len(xs_t)
    return grads[:nc], grads[nc:nc + nx], dict(zip(keys, grads[nc + nx:]))


def _stack_runs(runs, dim):
    """``torch.stack`` along ``dim`` of each tensor of ``runs``, a list of
    (tensor, n), repeated n times: one ``cat`` of expanded views, which
    moves the bytes and allocates the storage the stack of every copy
    would, with one operation for a weighted loop's repeated step."""
    return torch.cat([t.unsqueeze(dim).expand(*t.shape[:dim], n, *t.shape[dim:])
                      for t, n in runs], dim=dim)


def _layout(*states) -> tuple:
    """What decides how a step dispatches: each state tensor's type, shape,
    dtype and placements (a DTensor's)."""
    return tuple((type(v), tuple(v.shape), v.dtype, tuple(getattr(v, "placements", ())))
                 for s in states for v in s.values())


def _weighs(counter) -> bool:
    return counter is not None and counter.weight_loops


def _forward_runs(step, consts, xs, dim, state0, counter):
    """A scan's output states, in order, as runs (state, n): n steps giving
    that state; step t reads ``xs`` at index t of ``dim``. Under a counter
    that weights loops, a step entering with the layout the previous step
    entered with repeats it, and so does every later one: it is traced
    once, weighted by the steps left, and its run stands for all of them."""
    T = xs[0].shape[dim]
    runs, state, prev = [], state0, None
    for t in range(T):
        key = _layout(state) if _weighs(counter) else None
        xs_t = [x.select(dim, t) for x in xs]
        if key is not None and key == prev:
            with counter.weighted(T - t):
                state = step(consts, xs_t, state)
            return runs + [(state, T - t)]
        prev = key
        state = step(consts, xs_t, state)
        runs.append((state, 1))
    return runs


def _backward_walk(step, consts, xs, dim, state0, outs, g_outs, counter):
    """A scan's reverse walk from its stacked output states ``outs`` and
    their gradients ``g_outs`` (a key may be missing: no gradient):
    ``(g consts, g xs, g state0)``, the constants' gradients summed over
    the steps from the last to the first. Under a counter that weights
    loops, a step t >= 1 entering with the layouts (state and carried
    gradient) step t + 1 entered with stands for steps t down to 1,
    weighted by t; step 0 (from the initial state) is traced on its own."""
    T = xs[0].shape[dim]
    g = {k: torch.zeros_like(v) for k, v in state0.items()}
    g_c = [torch.zeros_like(c) for c in consts]
    g_xs, prev, t = [], None, T - 1
    while t >= 0:
        state = state0 if t == 0 else {k: outs[k].select(dim, t - 1) for k in state0}
        key = _layout(state, g) if _weighs(counter) else None
        n = t if key is not None and key == prev and t >= 1 else 1
        prev = key
        with counter.weighted(n) if n > 1 else contextlib.nullcontext():
            g_out = {k: g[k] + g_outs[k].select(dim, t) if k in g_outs else g[k] for k in g}
            gc_t, gx_t, g = _vjp(step, consts, [x.select(dim, t) for x in xs], state, g_out)
            g_c = [a + b for a, b in zip(g_c, gc_t)]
        g_xs.append((gx_t, n))
        t -= n
    g_xs = [_stack_runs([(gx[i], n) for gx, n in reversed(g_xs)], dim) for i in range(len(xs))]
    return g_c, g_xs, g


class MLSTMChunkScan(torch.autograd.Function):
    """The mLSTM's inter-chunk recurrence as one Function, taken only under
    an :class:`~repro_torch.roofline.counter.OpCounter` (the dry-run; a run
    takes the plain loop): from the chunks' ``cum, igc, kc, vc, total``
    (chunks on dim 1) and the entering state ``C0, n0, m0``, the state
    after each chunk, stacked on dim 1. Its forward and its backward (each
    step's VJP recomputed, :func:`_vjp`) weight repeated steps as
    :class:`SLSTMScan` does, so a training row's 32 chunks a block and a
    prefill's 255 are traced a few times each."""

    @staticmethod
    def forward(ctx, cum, igc, kc, vc, total, C0, n0, m0):
        xs = (cum, igc, kc, vc, total)
        state0 = dict(zip(_MLSTM_STATE, (C0, n0, m0)))
        runs = _forward_runs(_mlstm_chunk_state, (), xs, 1, state0, active_counter())
        outs = [_stack_runs([(s[k], n) for s, n in runs], 1) for k in _MLSTM_STATE]
        ctx.save_for_backward(*xs, C0, n0, m0, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, g_C, g_n, g_m):
        saved = ctx.saved_tensors
        xs, state0 = saved[:5], dict(zip(_MLSTM_STATE, saved[5:8]))
        outs = dict(zip(_MLSTM_STATE, saved[8:]))
        g_outs = dict(zip(_MLSTM_STATE, (g_C, g_n, g_m)))
        _, g_xs, g0 = _backward_walk(_mlstm_chunk_state, (), xs, 1, state0, outs, g_outs,
                                     active_counter())
        return (*g_xs, g0["C"], g0["n"], g0["m"])


def _slstm_scan_step(one):
    """:func:`_slstm_step` as a scan step: ``consts`` (r32, bias), ``xs``
    the step's input projection."""
    return lambda consts, xs_t, state: _slstm_step(consts[0], consts[1], xs_t[0], state, one)


class _ScanGraphs:
    """The captured chunks of one (heads, batch, head size, device): for
    each length L (``SCAN_CHUNK`` and the tails met), a forward graph of L
    steps and a backward graph of their L reverse steps, all captured at
    the first forward that needs that length, on a stream of their own
    and in one memory pool, over static buffers: the weights, a chunk of
    inputs and the carried state (forward); the chunk's entering states,
    output gradients, the carried state gradient and the weight gradient
    sums (backward). A replay runs on the caller's current stream; the
    graph carries its state (or gradient) into the static carry, so the
    chunks chain with copies of the inputs and outputs only."""

    def __init__(self, H, B, hd, device):
        f = dict(dtype=F32, device=device)
        K = SCAN_CHUNK
        with torch.inference_mode(False):
            self.r32 = torch.zeros((H, hd, 4 * hd), **f)
            self.bias = torch.zeros((H, 1, 4 * hd), **f)
            self.one = torch.ones((), **f)
            self.x = torch.zeros((H, B, K, 4 * hd), **f)
            shapes = {"c": (H, B, hd), "n": (H, B, hd), "h": (H, B, hd), "m": (H, B, 1)}
            self.carry = {k: torch.zeros(v, **f) for k, v in shapes.items()}
            self.outs = {k: torch.zeros((H, B, K, v[-1]), **f) for k, v in shapes.items()}
            self.ins = {k: torch.zeros((H, B, K, v[-1]), **f) for k, v in shapes.items()}
            self.g_hs = torch.zeros((H, B, K, hd), **f)
            self.g_x = torch.zeros((H, B, K, 4 * hd), **f)
            self.g_carry = {k: torch.zeros(v, **f) for k, v in shapes.items()}
            self.g_r = torch.zeros_like(self.r32)
            self.g_b = torch.zeros_like(self.bias)
        self.stream = torch.cuda.Stream(device)
        self.forward_graphs: dict = {}
        self.backward_graphs: dict = {}
        self.pool = None
        self.warm = False
        self.capture_s = 0.0
        self.replays = 0

    def _forward_body(self, L):
        st = dict(self.carry)
        for i in range(L):
            st = _slstm_step(self.r32, self.bias, self.x[:, :, i], st, self.one)
            for k in _STATE:
                self.outs[k][:, :, i].copy_(st[k])
        for k in _STATE:
            self.carry[k].copy_(st[k])

    def _backward_body(self, L):
        g = dict(self.g_carry)
        for i in reversed(range(L)):
            g_out = dict(g, h=g["h"] + self.g_hs[:, :, i])
            (gr, gb), (gx,), g = _vjp(_slstm_scan_step(self.one), (self.r32, self.bias),
                                      (self.x[:, :, i],),
                                      {k: self.ins[k][:, :, i] for k in _STATE}, g_out)
            self.g_r.add_(gr)
            self.g_b.add_(gb)
            self.g_x[:, :, i].copy_(gx)
        for k in _STATE:
            self.g_carry[k].copy_(g[k])

    def ensure(self, lengths):
        """Capture the forward and backward graphs of each length not yet
        captured (after one eager warm-up step of each on the capture
        stream). A failure raises; nothing runs eagerly in its place."""
        from repro_torch.sim.capture import capture

        todo = [L for L in lengths if L not in self.forward_graphs]
        if not todo:
            return
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.inference_mode(False):
            if not self.warm:
                with torch.cuda.stream(self.stream):
                    self._forward_body(1)
                    self._backward_body(1)
                self.warm = True
            for L in todo:
                try:
                    for graphs, body in ((self.forward_graphs, self._forward_body),
                                         (self.backward_graphs, self._backward_body)):
                        graph, _, _ = capture(lambda: body(L), None, self.stream, self.pool)
                        self.pool = self.pool or graph.pool()
                        graphs[L] = graph
                except Exception as e:
                    raise RuntimeError(f"capturing {L} sLSTM step(s) as a CUDA graph failed: "
                                       f"{e}") from e
        current.wait_stream(self.stream)
        self.capture_s += time.perf_counter() - t0

    def forward(self, r32, bias, x, state0, keys):
        """The steps' output states ``keys``, stacked (H, B, T, .), by replays."""
        T = x.shape[2]
        self.r32.copy_(r32)
        self.bias.copy_(bias)
        for k in _STATE:
            self.carry[k].copy_(state0[k])
        outs = {k: x.new_empty((*self.outs[k].shape[:2], T, self.outs[k].shape[-1]))
                for k in keys}
        for t0 in range(0, T, SCAN_CHUNK):
            L = min(SCAN_CHUNK, T - t0)
            self.x[:, :, :L].copy_(x[:, :, t0:t0 + L])
            self.forward_graphs[L].replay()
            self.replays += 1
            for k in keys:
                outs[k][:, :, t0:t0 + L].copy_(self.outs[k][:, :, :L])
        return outs

    def backward(self, r32, bias, x, state0, outs, g_hs):
        """``(g r32, g bias, g x, g state0)`` by replays, chunks last to first."""
        T = x.shape[2]
        self.r32.copy_(r32)
        self.bias.copy_(bias)
        self.g_r.zero_()
        self.g_b.zero_()
        for k in _STATE:
            self.g_carry[k].zero_()
        g_x = torch.empty_like(x)
        for t0 in reversed(range(0, T, SCAN_CHUNK)):
            L = min(SCAN_CHUNK, T - t0)
            self.x[:, :, :L].copy_(x[:, :, t0:t0 + L])
            self.g_hs[:, :, :L].copy_(g_hs[:, :, t0:t0 + L])
            for k in _STATE:
                first = state0[k] if t0 == 0 else outs[k][:, :, t0 - 1]
                self.ins[k][:, :, 0].copy_(first)
                self.ins[k][:, :, 1:L].copy_(outs[k][:, :, t0:t0 + L - 1])
            self.backward_graphs[L].replay()
            self.replays += 1
            g_x[:, :, t0:t0 + L].copy_(self.g_x[:, :, :L])
        return (self.g_r.clone(), self.g_b.clone(), g_x,
                {k: v.clone() for k, v in self.g_carry.items()})


_GRAPHS: dict = {}  # (H, B, hd, device) -> _ScanGraphs


def scan_graphs() -> dict:
    """The captured scans by (heads, batch, head size, device)."""
    return dict(_GRAPHS)


def _graphs_for(x):
    """The captured scans of ``x``'s key, every length its T needs
    captured (at the forward: never inside the autograd engine's thread)."""
    H, B, T, g_hd = x.shape
    key = (H, B, g_hd // 4, x.device)
    if key not in _GRAPHS:
        _GRAPHS[key] = _ScanGraphs(H, B, g_hd // 4, x.device)
    graphs = _GRAPHS[key]
    graphs.ensure(sorted({min(SCAN_CHUNK, T), T % SCAN_CHUNK} - {0}))
    return graphs


class SLSTMScan(torch.autograd.Function):
    """``hs`` (H, B, T, hd) of the sLSTM steps over ``x`` (H, B, T, 4 hd)
    from the state ``c0, n0, h0, m0`` (:func:`_to_step`'s layout): the
    reference's ``lax.scan`` of its cell. The forward keeps every step's
    output state as the residual (the scan's stacked carries) where an
    input needs a gradient, else only ``hs``; the
    backward walks time in reverse, each step's vector-Jacobian product
    by autograd of the step recomputed from its entering state
    (:func:`_vjp`), the gradients of ``r32`` and ``bias`` summed over
    the steps. On a CPU tensor (or inside :func:`eager_scan`) both walks
    are Python loops; on a CUDA tensor they replay the captured chunks of
    :class:`_ScanGraphs`. Under an :class:`~repro_torch.roofline.counter.OpCounter`
    that weights loops, the distinct steps are traced once each, weighted
    by the steps they stand for."""

    @staticmethod
    def forward(ctx, r32, bias, x, c0, n0, h0, m0, one):
        state0 = {"c": c0, "n": n0, "h": h0, "m": m0}
        counter = active_counter()
        captured = x.device.type == "cuda" and _CAPTURED[-1] and counter is None
        keys = _STATE if any(ctx.needs_input_grad) else ("h",)
        if captured:
            outs = _graphs_for(x).forward(r32, bias, x, state0, keys)
        else:
            runs = _forward_runs(_slstm_scan_step(one), (r32, bias), (x,), 2, state0, counter)
            outs = {k: _stack_runs([(s[k], n) for s, n in runs], 2) for k in keys}
        ctx.captured = captured
        if keys == _STATE:
            ctx.save_for_backward(r32, bias, x, c0, n0, h0, m0, one, outs["c"], outs["n"],
                                  outs["h"], outs["m"])
        return outs["h"]

    @staticmethod
    def backward(ctx, g_hs):
        r32, bias, x, c0, n0, h0, m0, one, *rest = ctx.saved_tensors
        state0 = {"c": c0, "n": n0, "h": h0, "m": m0}
        outs = dict(zip(_STATE, rest))
        if ctx.captured:
            H, B, _, g_hd = x.shape
            g_r, g_b, g_x, g0 = _GRAPHS[(H, B, g_hd // 4, x.device)].backward(
                r32, bias, x, state0, outs, g_hs)
        else:
            (g_r, g_b), (g_x,), g0 = _backward_walk(_slstm_scan_step(one), (r32, bias), (x,), 2,
                                                    state0, outs, {"h": g_hs}, active_counter())
        return g_r, g_b, g_x, g0["c"], g0["n"], g0["h"], g0["m"], None


def slstm_scan(r32, bias, x, state, one):
    """:class:`SLSTMScan` of ``x`` (H, B, T, 4 hd) from ``state``
    (:func:`_to_step`'s layout): ``hs`` (H, B, T, hd)."""
    return SLSTMScan.apply(r32, bias, x, state["c"], state["n"], state["h"], state["m"], one)


def slstm_forward(params: SLSTM, xin, cfg):
    """Sequential sLSTM over the sequence. xin: (B, S, d) -> (B, S, d)."""
    B, S, d = xin.shape
    # Hoisted out of the time scan: the float32 weights and inputs, heads
    # leading, (H, B, S, 4 hd).
    x = _heads_first(dense(params.w_in, xin), cfg)
    r32, bias, one = _step_constants(params, xin.device)
    hs = slstm_scan(r32, bias, x, _to_step(init_slstm_cache(cfg, B, xin.device)), one)
    y = hs.permute(1, 2, 0, 3).reshape(B, S, d).to(xin.dtype)
    y = rms_norm(params.norm, y, cfg.norm_eps)
    return dense(params.down, y)


def slstm_decode(params: SLSTM, xin, cfg, cache):
    """One-token sLSTM step. xin: (B, 1, d) -> ((B, 1, d), new cache)."""
    new = _slstm_cell(params, cfg, dense(params.w_in, xin[:, 0]), cache)
    y = new["h"].reshape(xin.shape[0], cfg.d_model).to(xin.dtype)
    y = rms_norm(params.norm, y, cfg.norm_eps)
    return dense(params.down, y)[:, None], new
