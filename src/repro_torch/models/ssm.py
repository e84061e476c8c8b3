"""Selective SSM (Mamba-style) head + Hymba parallel attn/SSM block; the
port of ``repro.models.ssm``.

Hymba (arXiv:2411.13676) fuses attention heads and mamba heads *in
parallel within the same layer*: both see the same normed input, their
outputs are normalized and mean-combined.  Attention uses a sliding
window, and the SSM branch carries unbounded context.

The SSM is a grouped selective scan (per-head state (N, dh), f32):
    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * (B_t ⊗ x_t)
    y_t = C_t · S_t + D_h * x_t
with dt, B, C data-dependent (input projections) and a k=4 causal
depthwise conv whose ``CONV_K - 1`` tail is carried through decode.
``ssm_scan`` runs token by token; ``ssm_scan_chunked`` runs the same
recurrence ``cfg.ssm_chunk`` timesteps at a time as masked matmuls.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime.mesh import batch_axes, constrain, is_dtensor
from .layers import (
    gqa_attention,
    gqa_decode,
    gqa_params_shape,
    merge_heads,
    rms_norm,
    split_heads,
)
from .scan import scan, scan_by_rank

CONV_K = 4


def ssm_params_shape(cfg):
    d = cfg.d_model
    nh, dh, N = cfg.ssm_heads, cfg.d_head, cfg.ssm_state
    di = nh * dh
    return {
        "w_in": (d, 2 * di),          # x branch + gate z
        "conv": (CONV_K, di),         # depthwise conv
        "w_dt": (di, nh),
        "dt_bias": (nh,),
        "w_B": (d, nh * N),
        "w_C": (d, nh * N),
        "A_log": (nh,),
        "D": (nh,),
        "w_out": (di, d),
    }


def _depthwise_conv(x, w):
    """causal depthwise conv: x (B, S, di), w (K, di)."""
    B, S, di = x.shape
    K = w.shape[0]
    if is_dtensor(x):
        # the same zeros ahead of the sequence, by a rule every torch's
        # DTensor has (some index out of range padding a DTensor)
        xp = torch.cat([x.new_zeros((B, K - 1, di)), x], dim=1)
    else:
        xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):      # K is tiny and static: unrolled taps
        out = out + xp[:, i: i + S, :] * w[i]
    return out


def _conv_branch(p, x, cfg, conv_tail):
    """The input projection and the causal conv: (u, z, new conv tail)."""
    S = x.shape[1]
    di = cfg.ssm_heads * cfg.d_head
    xz = x @ p["w_in"]
    xb, z = xz[..., :di], xz[..., di:]
    if conv_tail is not None:
        xb_ext = torch.cat([conv_tail, xb], dim=1)
        conv_out = _depthwise_conv(xb_ext, p["conv"])[:, -S:, :]
        new_tail = xb_ext[:, -(CONV_K - 1):, :]
    else:
        conv_out = _depthwise_conv(xb, p["conv"])
        new_tail = xb[:, -(CONV_K - 1):, :]
    return F.silu(conv_out), z, new_tail


def _scan_heads(step, state, xs, heads, n, ys_shape):
    """``scan`` of the SSM's recurrence over ``xs``: ``xs[0]`` the input
    u (B, ..., nh, dh), ``heads[i]`` the dimension of ``xs[i]``'s heads
    (None for a constant); ``state`` (B, nh, N, dh), None for zeros.
    DTensors run on each rank's batch rows and heads (``scan_by_rank``),
    as GSPMD partitions the reference's ``lax.scan``."""
    N = xs[2].shape[-1]

    def zeros(u, *_):
        return torch.zeros((u.shape[0], u.shape[-2], N, u.shape[-1]),
                           dtype=torch.float32, device=u.device)

    if not is_dtensor(xs[0]):
        return scan(step, zeros(xs[0]) if state is None else state, xs, n)
    ba = batch_axes()

    def spec(ndim, h):
        return tuple("model" if d == h else ba if d == 0 else None
                     for d in range(ndim))

    B, nh, dh = ys_shape[0], ys_shape[-2], ys_shape[-1]
    return scan_by_rank(
        step, state, xs, n, carry_spec=(ba, "model", None, None),
        xs_specs=[() if h is None else spec(t.ndim, h)
                  for t, h in zip(xs, heads)],
        ys_spec=spec(len(ys_shape), len(ys_shape) - 2),
        shapes=((B, nh, N, dh), ys_shape), init=zeros)


def ssm_scan(p, x, cfg, state=None, conv_tail=None):
    """x (B, S, d) -> (y (B, S, d), (state, conv_tail)).

    state (B, nh, N, dh); conv_tail (B, CONV_K-1, di) carries the causal
    conv context across decode steps.
    """
    B, S, d = x.shape
    nh, dh, N = cfg.ssm_heads, cfg.d_head, cfg.ssm_state
    u, z, new_tail = _conv_branch(p, x, cfg, conv_tail)       # (B,S,di)
    dt = F.softplus(u @ p["w_dt"] + p["dt_bias"])             # (B,S,nh)
    Bmat = split_heads(x @ p["w_B"], nh, N)
    Cmat = split_heads(x @ p["w_C"], nh, N)
    A = -torch.exp(p["A_log"].float())                        # (nh,)
    uh = split_heads(u, nh, dh)

    def step(state, t, uh, dt, Bmat, Cmat, A):
        u_t, dt_t, B_t, C_t = uh[:, t], dt[:, t], Bmat[:, t], Cmat[:, t]
        decay = torch.exp(dt_t.float() * A)[..., None, None]
        drive = (dt_t[..., None, None] * B_t[..., :, None]
                 * u_t[..., None, :]).float()
        state = decay * state + drive
        return state, torch.einsum("bhn,bhnd->bhd", C_t.float(), state)

    # the tokens as the reference's lax.scan runs them
    state, y = _scan_heads(step, state, (uh, dt, Bmat, Cmat, A),
                           (2, 2, 2, 2, 0), S, (B, S, nh, dh))
    y = y.to(x.dtype)                                         # (B,S,nh,dh)
    y = y + uh * p["D"][:, None]
    y = merge_heads(y) * F.silu(z)
    return y @ p["w_out"], (state, new_tail)


def ssm_scan_chunked(p, x, cfg, state=None, conv_tail=None):
    """Chunk-parallel selective scan (mamba2-style).

    Identical math to ``ssm_scan`` (per-head scalar decay A_h), processed
    ``cfg.ssm_chunk`` timesteps at once:

        cum_t  = sum_{s<=t} dt_s * A_h                (log-decay cumsum)
        y_t    = e^{cum_t} (C_t . S_0)
                 + sum_{s<=t} e^{cum_t - cum_s} dt_s (C_t . B_s) u_s
        S_next = e^{cum_L} S_0 + sum_s e^{cum_L - cum_s} dt_s B_s (x) u_s

    All kept exponents are <= 0 (s <= t); the masked ones are clamped to
    0 before the exponential (the reference overflows there into NaN on
    long chunks; wherever it is finite the two agree).  A length that is
    not a multiple of the chunk falls back to ``ssm_scan``.
    """
    B, S, d = x.shape
    L = max(1, min(cfg.ssm_chunk, S))
    if S % L != 0:
        return ssm_scan(p, x, cfg, state=state, conv_tail=conv_tail)
    nh, dh, N = cfg.ssm_heads, cfg.d_head, cfg.ssm_state
    u, z, new_tail = _conv_branch(p, x, cfg, conv_tail)
    dt = F.softplus(u @ p["w_dt"] + p["dt_bias"]).float()
    Bm = split_heads(x @ p["w_B"], nh, N).float()
    Cm = split_heads(x @ p["w_C"], nh, N).float()
    A = -torch.exp(p["A_log"].float())
    uh = split_heads(u, nh, dh).float()
    nc = S // L
    # chunked views: (B, nc, L, ...)
    dtc = dt.reshape(B, nc, L, nh)
    Bc = Bm.reshape(B, nc, L, nh, N)
    Cc = Cm.reshape(B, nc, L, nh, N)
    uc = uh.reshape(B, nc, L, nh, dh)
    mask = torch.tril(torch.ones((L, L), dtype=torch.float32,
                                 device=x.device))

    def step(state, c, uc, dtc, Bc, Cc, A, mask):
        dt_k, B_k, C_k, u_k = dtc[:, c], Bc[:, c], Cc[:, c], uc[:, c]
        log_a = dt_k * A                        # (B,L,nh), <= 0
        cum = torch.cumsum(log_a, dim=1)        # (B,L,nh)
        decay0 = torch.exp(cum)                 # e^{cum_t}
        # inter-chunk: y_t^0 = e^{cum_t} C_t . S_0
        y0 = torch.einsum("blhn,bhnd->blhd", C_k, state) * decay0[..., None]
        # intra-chunk quadratic form
        G = torch.einsum("blhn,bshn->bhls", C_k, B_k)        # (B,nh,L,L)
        # (B,l,s,h); the masked half (s > l) has positive exponents,
        # which overflow to inf once a chunk's log-decay spans more than
        # ~88 (hymba's chunk of 128 on a real prompt), and inf * 0 is
        # NaN: clamped to 0 they vanish under the mask, and every kept
        # entry (s <= l, exponent <= 0) is the reference's
        ratio = torch.exp(torch.clamp(
            cum[:, :, None, :] - cum[:, None, :, :], max=0.0))
        ratio = torch.movedim(ratio, 3, 1)                    # (B,nh,l,s)
        W = G * ratio * torch.movedim(dt_k, 2, 1)[:, :, None, :]
        W = W * mask[None, None]
        y1 = torch.einsum("bhls,bshd->blhd", W, u_k)
        # state propagation to chunk end
        decay_end = torch.exp(cum[:, -1:, :] - cum)           # (B,L,nh)
        drive = torch.einsum(
            "blh,blhn,blhd->bhnd", dt_k * decay_end, B_k, u_k)
        state = state * torch.exp(cum[:, -1, :])[..., None, None] + drive
        return state, y0 + y1

    # the chunks as the reference's lax.scan runs them
    state, y = _scan_heads(step, state, (uc, dtc, Bc, Cc, A, mask),
                           (3, 3, 3, 3, 0, None), nc, (B, nc, L, nh, dh))
    y = y.reshape(B, S, nh, dh)
    y = y + uh * p["D"][:, None]
    y = merge_heads(y.to(x.dtype)) * F.silu(z)
    return y @ p["w_out"], (state, new_tail)


def ssm_apply(p, x, cfg, state=None, conv_tail=None):
    """Dispatch: chunked when configured and applicable, else sequential."""
    if cfg.ssm_chunk and x.shape[1] > 1:
        return ssm_scan_chunked(p, x, cfg, state=state, conv_tail=conv_tail)
    return ssm_scan(p, x, cfg, state=state, conv_tail=conv_tail)


# ------------------------------------------------------------- hymba ---

def hybrid_params_shape(cfg):
    shapes = {"attn": gqa_params_shape(cfg), "ssm": ssm_params_shape(cfg)}
    shapes["attn_scale"] = (cfg.d_model,)
    shapes["ssm_scale"] = (cfg.d_model,)
    return shapes


def _reduced(y):
    """A branch's output projection with its partial sums over "model"
    reduced in its own dtype (a DTensor's), as GSPMD reduces it into the
    norm's input: DTensor otherwise carries them into ``rms_norm``'s f32
    square, and all-reduces that at twice the bytes."""
    return constrain(y, batch_axes(), None, None)


def hybrid_block(p, x, cfg, positions=None):
    attn_out, _kv = gqa_attention(p["attn"], x, cfg, positions)
    ssm_out, _st = ssm_apply(p["ssm"], x, cfg)
    attn_out, ssm_out = _reduced(attn_out), _reduced(ssm_out)
    out = 0.5 * (rms_norm(attn_out, p["attn_scale"])
                 + rms_norm(ssm_out, p["ssm_scale"]))
    return out, None


def hybrid_decode(p, x, cfg, cache):
    """cache = {"attn": rolling-window KV, "state", "conv_tail"}."""
    attn_out, attn_cache = gqa_decode(p["attn"], x, cfg, cache["attn"])
    ssm_out, (state, tail) = ssm_scan(
        p["ssm"], x, cfg, state=cache["state"], conv_tail=cache["conv_tail"])
    attn_out, ssm_out = _reduced(attn_out), _reduced(ssm_out)
    out = 0.5 * (rms_norm(attn_out, p["attn_scale"])
                 + rms_norm(ssm_out, p["ssm_scale"]))
    return out, {"attn": attn_cache, "state": state, "conv_tail": tail}
