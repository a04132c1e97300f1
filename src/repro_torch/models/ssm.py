"""Mamba2-style selective SSM block (SSD), chunked.

Port of ``repro/models/ssm.py``. Prefill uses the chunked SSD algorithm:
quadratic attention-like compute within chunks of Q positions (the
``ssm_chunk`` kernel on the card) plus a linear inter-chunk state
recurrence (a loop over the chunks). Decode is the O(1) recurrent state
update.

Layout: d_inner = expand * d_model, nheads = d_inner / head_dim, a single
B/C group shared by every head, state_dim = N.

Cast points, as in the reference: the input projection and the causal
conv run in the model type; ``dt`` and its softplus in float32; the SSM
inputs ``x``, ``B`` and ``C`` are cast to float32, and the output ``y``
stays float32 until it is cast back before ``out_proj``. ``A_log``, ``D``
and ``dt_bias`` are float32 parameters in any model type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.layers import Dense, dense, normal_
from repro_torch.models.sharding import einsum, split_model  # the identity off a mesh


def _dims(cfg):
    """(d_inner, state_dim, nheads, head_dim)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return di, s.state_dim, di // s.head_dim, s.head_dim


class Mamba2(nn.Module):
    """The block's parameters (the reference's ``init_mamba2`` tree)."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d = cfg.d_model
        di, N, nheads, _ = _dims(cfg)
        f32 = torch.float32
        # in_proj packs [z, x, B, C, dt].
        self.in_proj = Dense(d, 2 * di + 2 * N + nheads, device=device, dtype=dtype,
                             generator=generator)
        self.conv = nn.Parameter(torch.empty((cfg.ssm.conv_kernel, di + 2 * N), device=device,
                                             dtype=dtype))
        self.A_log = nn.Parameter(torch.empty(nheads, device=device, dtype=f32))
        self.D = nn.Parameter(torch.empty(nheads, device=device, dtype=f32))
        self.dt_bias = nn.Parameter(torch.empty(nheads, device=device, dtype=f32))
        self.out_proj = Dense(di, d, device=device, dtype=dtype, generator=generator)
        self.norm_z = nn.Parameter(torch.empty(di, device=device, dtype=dtype))
        if generator is not None:
            normal_(self.conv, generator, 0.1)
            with torch.no_grad():
                grid = torch.linspace(1.0, 16.0, nheads, dtype=torch.float64)
                self.A_log.copy_(torch.log(grid))
                self.D.fill_(1.0)
                self.dt_bias.zero_()
                self.norm_z.fill_(1.0)


def _split_proj(proj, di, N, nheads):
    z = proj[..., :di]
    x = proj[..., di:2 * di]
    B = proj[..., 2 * di:2 * di + N]
    C = proj[..., 2 * di + N:2 * di + 2 * N]
    dt = proj[..., 2 * di + 2 * N:]
    return z, x, B, C, dt


def _causal_conv(x, w):
    """Depthwise causal conv along seq. x: (B, S, D), w: (K, D)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S] * w[i]
    return out


def _gated_norm(y, z, params):
    """Mamba2's gated RMS norm before ``out_proj``, in float32."""
    y = y * F.silu(z.to(torch.float32))
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-5) * params.norm_z.to(torch.float32)


def mamba2_forward(params: Mamba2, xin, cfg, use_kernel=None):
    """xin: (B, S, d_model) -> (B, S, d_model). Chunked SSD.

    ``use_kernel``: None takes the ``ssm_chunk`` kernel for a CUDA tensor
    and the plain einsums for a CPU one; True routes the intra-chunk
    compute through ``ops.ssm_chunk_ad`` on either device (its plain
    version on the CPU; the plain version's gradient on backward);
    False takes the einsums.
    """
    di, N, nheads, hd = _dims(cfg)
    Bsz, S, _ = xin.shape
    Q = min(cfg.ssm.chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} must be divisible by chunk {Q}")
    nc = S // Q
    if use_kernel is None:
        use_kernel = xin.device.type == "cuda"
    f32 = torch.float32

    proj = dense(params.in_proj, xin)
    z, x, Bssm, Cssm, dt = _split_proj(proj, di, N, nheads)
    conv_in = torch.cat([x, Bssm, Cssm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, params.conv))
    # On a mesh the heads are split over "model" (local slices).
    x = split_model(conv_out[..., :di], -1)
    Bssm = conv_out[..., di:di + N]
    Cssm = conv_out[..., di + N:]

    dt = F.softplus(split_model(dt, -1).to(f32) + params.dt_bias)  # (B, S, H)
    A = -torch.exp(params.A_log)  # (H,) negative
    loga = dt * A  # per-step log decay, <= 0

    xh = x.reshape(Bsz, nc, Q, nheads, hd).to(f32)
    Bc = Bssm.reshape(Bsz, nc, Q, N).to(f32)
    Cc = Cssm.reshape(Bsz, nc, Q, N).to(f32)
    dtc = dt.reshape(Bsz, nc, Q, nheads)
    cum = torch.cumsum(loga.reshape(Bsz, nc, Q, nheads), dim=2)  # (B, nc, Q, H) inclusive
    total = cum[:, :, -1]  # (B, nc, H)

    if use_kernel:
        # Groups (B, nc, H) flattened; C and B stay one copy per (B, nc),
        # shared by the H heads of the group block.
        G = Bsz * nc * nheads
        cumk = cum.permute(0, 1, 3, 2).reshape(G, Q)
        dtk = dtc.permute(0, 1, 3, 2).reshape(G, Q)
        xk = xh.permute(0, 1, 3, 2, 4).reshape(G, Q, hd)
        # Cc and Bc are still strided views of conv_out in a float32 model.
        yk, sk = ops.ssm_chunk_ad(Cc.reshape(Bsz * nc, Q, N).contiguous(),
                                  Bc.reshape(Bsz * nc, Q, N).contiguous(), cumk, dtk, xk, nheads)
        y_intra = yk.reshape(Bsz, nc, nheads, Q, hd).permute(0, 1, 3, 2, 4)
        s_loc = sk.reshape(Bsz, nc, nheads, hd, N)
    else:
        # scores[b,c,q,t,h] = exp(cum_q - cum_t) (C_q . B_t) dt_t for t <= q
        cb = einsum("bcqn,bctn->bcqt", Cc, Bc)
        decay = torch.exp(torch.clamp(cum[:, :, :, None, :] - cum[:, :, None, :, :], -60.0, 0.0))
        causal = torch.ones((Q, Q), dtype=torch.bool, device=xin.device).tril()
        scores = cb[..., None] * decay * dtc[:, :, None, :, :]
        scores = torch.where(causal[None, None, :, :, None], scores, 0.0)
        y_intra = einsum("bcqth,bcthp->bcqhp", scores, xh)
        # chunk-local end state: sum_t exp(total - cum_t) dt_t x_t B_t
        w_end = torch.exp(torch.clamp(total[:, :, None, :] - cum, -60.0, 0.0)) * dtc
        s_loc = einsum("bcqhp,bcqn->bchpn", w_end[..., None] * xh, Bc)

    # Inter-chunk recurrence S_c = exp(total_c) S_{c-1} + s_loc_c; each chunk
    # reads the state entering it.
    state = torch.zeros((Bsz, nheads, hd, N), dtype=f32, device=xin.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = torch.exp(total[:, c])[:, :, None, None] * state + s_loc[:, c]
    S_in = torch.stack(entering, dim=1)  # (B, nc, H, hd, N)

    # y_inter[q] = exp(cum_q) C_q . S_in
    w_in = torch.exp(torch.clamp(cum, -60.0, 0.0))  # (B, nc, Q, H)
    y_inter = einsum("bcqn,bchpn->bcqhp", Cc, S_in) * w_in[..., None]

    y = (y_intra + y_inter).reshape(Bsz, S, di)
    y = y + params.D.repeat_interleave(hd) * x.to(f32)
    return dense(params.out_proj, _gated_norm(y, z, params).to(xin.dtype))


def init_mamba2_cache(cfg, batch, dtype, device):
    di, N, nheads, hd = _dims(cfg)
    return {
        "state": torch.zeros((batch, nheads, hd, N), dtype=torch.float32, device=device),
        "conv_buf": torch.zeros((batch, cfg.ssm.conv_kernel - 1, di + 2 * N), dtype=dtype,
                                device=device),
    }


def mamba2_decode(params: Mamba2, xin, cfg, cache):
    """One-token decode. xin: (B, 1, d_model) -> ((B, 1, d_model), new cache)."""
    di, N, nheads, hd = _dims(cfg)
    Bsz = xin.shape[0]
    f32 = torch.float32

    proj = dense(params.in_proj, xin[:, 0])
    z, x, Bssm, Cssm, dt = _split_proj(proj, di, N, nheads)
    conv_in = torch.cat([x, Bssm, Cssm], dim=-1)  # (B, di + 2N)
    buf = torch.cat([cache["conv_buf"], conv_in[:, None]], dim=1)  # (B, K, .)
    conv_out = F.silu(einsum("bkd,kd->bd", buf, params.conv))
    x = conv_out[:, :di]
    Bssm = conv_out[:, di:di + N].to(f32)
    Cssm = conv_out[:, di + N:].to(f32)

    dt = F.softplus(dt.to(f32) + params.dt_bias)  # (B, H)
    a = torch.exp(dt * -torch.exp(params.A_log))  # (B, H)
    xh = x.reshape(Bsz, nheads, hd).to(f32)
    upd = (dt[:, :, None] * xh)[..., None] * Bssm[:, None, None, :]  # (B, H, hd, N)
    state = a[:, :, None, None] * cache["state"] + upd
    y = einsum("bn,bhpn->bhp", Cssm, state)  # (B, H, hd)
    y = y.reshape(Bsz, di) + params.D.repeat_interleave(hd) * x.to(f32)
    out = dense(params.out_proj, _gated_norm(y, z, params).to(xin.dtype))
    return out[:, None], {"state": state, "conv_buf": buf[:, 1:]}

