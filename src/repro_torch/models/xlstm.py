"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, sequential) with exponential gating + stabilizers.

Port of ``repro/models/xlstm.py``. The mLSTM forward is the chunkwise form
(quadratic within chunks of ``cfg.xlstm.chunk`` positions, recurrent across
them), its inter-chunk scan a Python loop over the chunks; the sLSTM
forward is a Python loop over time where the reference has a ``lax.scan``.
Both decode one token from an O(1) state.

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

The sLSTM time loop hoists out of the step what gives the same values:
the float32 cast of the recurrent weights ``r`` and of the input
projection, laid out heads first once a call, so that a step is 23
operations; the bias is still added after the recurrent term,
``(x + rec) + bias``, the reference's order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, RMSNorm, dense, normal_, rms_norm
from repro_torch.models.sharding import einsum  # torch.einsum off a mesh

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
    Cst = torch.zeros((B, H, hd, hd), dtype=F32, device=xin.device)
    nst = torch.zeros((B, H, hd), dtype=F32, device=xin.device)
    mst = torch.full((B, H), -1e30, dtype=F32, device=xin.device)
    C_in, n_in, m_in = [Cst], [nst], [mst]
    for c in range(nc - 1):
        cumc, igcc, kcc = cum[:, c], igc[:, c], kc[:, c]
        w = cumc[:, -1][:, None] - cumc + igcc  # (B, Q, H): exp weight of k_t v_t
        m_loc = w.amax(dim=1)  # (B, H)
        m_prev = mst + total[:, c]
        m_new = torch.maximum(m_prev, m_loc)
        scale_prev = torch.exp(m_prev - m_new)  # (B, H)
        wexp = torch.exp(w - m_new[:, None, :])  # (B, Q, H)
        C_loc = einsum("bqhk,bqhv->bhkv", wexp[..., None] * kcc, vc[:, c])
        n_loc = einsum("bqh,bqhk->bhk", wexp, kcc)
        Cst = scale_prev[:, :, None, None] * Cst + C_loc
        nst = scale_prev[:, :, None] * nst + n_loc
        mst = m_new
        C_in.append(Cst)
        n_in.append(nst)
        m_in.append(mst)
    C_in = torch.stack(C_in, dim=1)  # (B, nc, H, hd, hd)
    n_in = torch.stack(n_in, dim=1)  # (B, nc, H, hd)
    m_in = torch.stack(m_in, dim=1)  # (B, nc, H)

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


def slstm_forward(params: SLSTM, xin, cfg):
    """Sequential sLSTM over the sequence. xin: (B, S, d) -> (B, S, d)."""
    B, S, d = xin.shape
    # Hoisted out of the time loop: the float32 weights and inputs, heads
    # leading, one (H, B, 4 hd) input a step.
    xs = _heads_first(dense(params.w_in, xin), cfg).unbind(2)
    r32, bias, one = _step_constants(params, xin.device)
    state = _to_step(init_slstm_cache(cfg, B, xin.device))
    hs = []
    for xt in xs:
        state = _slstm_step(r32, bias, xt, state, one)
        hs.append(state["h"])
    y = torch.stack(hs, dim=2).permute(1, 2, 0, 3).reshape(B, S, d).to(xin.dtype)
    y = rms_norm(params.norm, y, cfg.norm_eps)
    return dense(params.down, y)


def slstm_decode(params: SLSTM, xin, cfg, cache):
    """One-token sLSTM step. xin: (B, 1, d) -> ((B, 1, d), new cache)."""
    new = _slstm_cell(params, cfg, dense(params.w_in, xin[:, 0]), cache)
    y = new["h"].reshape(xin.shape[0], cfg.d_model).to(xin.dtype)
    y = rms_norm(params.norm, y, cfg.norm_eps)
    return dense(params.down, y)[:, None], new
