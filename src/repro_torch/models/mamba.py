"""Mamba-2 (SSD, state-space duality) mixer: chunked prefill scan plus
O(1)-per-token recurrent decode.

The chunked algorithm is the quadratic-within-chunk / linear-across-chunk
decomposition of arXiv:2405.21060 §6: intra-chunk outputs come from a
masked (C Bᵀ ∘ L) X product, and the inter-chunk state is carried by a
loop over chunks.  All decays run in float32 (exp of non-positive
numbers; the ``-inf`` above the diagonal of L gives 0).

Logical shapes: d_inner = expand * d_model, H = d_inner / headdim P,
state N = cfg.ssm_state, a single B/C group.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._build import resolve_device

from .config import ModelConfig
from .layers import rmsnorm, weight_getter
from .schema import P


def mamba_schema(cfg: ModelConfig):
    d, di, N, H = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N
    d_in = 2 * di + 2 * N + H
    return {
        "in_proj": P((d, d_in), ("embed", "ssm")),
        "conv_w": P((cfg.ssm_conv, conv_dim), (None, "ssm"), "normal",
                    scale=0.5),
        "conv_b": P((conv_dim,), ("ssm",), "zeros"),
        "A_log": P((H,), (None,), "zeros"),      # A = -exp(A_log) = -1 init
        "dt_bias": P((H,), (None,), "zeros"),
        "D": P((H,), (None,), "ones"),
        "norm": P((di,), ("ssm",), "ones"),
        "out_proj": P((di, d), ("ssm", "embed")),
    }


def _segsum(x):
    """x [..., Q] -> [..., Q, Q]; out[..., i, j] = sum_{j<k<=i} x_k for
    i >= j, -inf above the diagonal (log-space decay matrix L)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(xdt, dA, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan.

    xdt [B,S,H,P] f32 (inputs pre-multiplied by dt), dA [B,S,H] f32
    (dt * A, <= 0), Bm/Cm [B,S,N] f32.  Returns (y [B,S,H,P] f32,
    h_final [B,H,P,N] f32).  A sequence that is not a multiple of the
    chunk is zero-padded: xdt = 0 injects nothing and dA = 0 decays by
    exp(0) = 1, so the final state is exact; padded outputs are dropped.
    """
    B, S, H, Pd = xdt.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        pad = Q - S % Q
        y, h = ssd_chunked(F.pad(xdt, (0, 0, 0, 0, 0, pad)),
                           F.pad(dA, (0, 0, 0, pad)),
                           F.pad(Bm, (0, 0, 0, pad)),
                           F.pad(Cm, (0, 0, 0, pad)), chunk, h0)
        return y[:, :S], h
    nc = S // Q
    xc = xdt.reshape(B, nc, Q, H, Pd)
    dAc = dA.reshape(B, nc, Q, H)
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)

    cs = torch.cumsum(dAc, dim=2)                      # [B,nc,Q,H]
    # Intra-chunk (the "quadratic attention-like" branch).
    L = torch.exp(_segsum(dAc.movedim(-1, -2)))        # [B,nc,H,Q,Q]
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)   # [B,nc,Q,Q]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores[:, :, None] * L, xc)

    # Per-chunk end states.
    decay_states = torch.exp(cs[:, :, -1:, :] - cs)    # [B,nc,Q,H]
    states = torch.einsum("bcqn,bcqhp->bchpn", Bc,
                          xc * decay_states[..., None])

    # Inter-chunk recurrence: h_prevs[:, c] is the state entering chunk c.
    chunk_decay = torch.exp(cs[:, :, -1, :])           # [B,nc,H]
    h = (torch.zeros(B, H, Pd, N, dtype=torch.float32, device=xdt.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)              # [B,nc,H,P,N]

    # Contribution of carried-in state to each position.
    y_off = (torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prevs)
             * torch.exp(cs)[..., None])

    y = (y_diag + y_off).reshape(B, S, H, Pd)
    return y, h


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d.  xBC [B,S,D], w [K,D], b [D]."""
    K = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, k:k + S, :] * w[k][None, None, :] for k in range(K))
    return out + b[None, None, :]


def mamba_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cuda"):
    device = resolve_device(device)
    di, N, H, Pd = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                    cfg.ssm_headdim)
    conv_dim = di + 2 * N
    return {
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, conv_dim, dtype=dtype,
                            device=device),
        "ssd": torch.zeros(batch, H, Pd, N, dtype=torch.float32,
                           device=device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, N, H = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + conv_dim]
    dt = zxbcdt[..., di + conv_dim:]
    if dt.shape[-1] != H:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt columns for "
                         f"{H} heads")
    return z, xBC, dt


def _ssd_inputs(cfg: ModelConfig, p, xBC, dt):
    """Post-conv xBC + raw dt -> f32 (x [.., H, P], dA, Bm, Cm, dt_sp)."""
    di, N, H, Pd = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                    cfg.ssm_headdim)
    x = xBC[..., :di].to(torch.float32)
    Bm = xBC[..., di:di + N].to(torch.float32)
    Cm = xBC[..., di + N:].to(torch.float32)
    dt_sp = F.softplus(dt.to(torch.float32)
                       + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))       # [H]
    dA = dt_sp * A                                     # [..., H]
    x = x.reshape(*x.shape[:-1], H, Pd)
    return x, dA, Bm, Cm, dt_sp


def mamba(p, x, cfg: ModelConfig, deq=None, h0=None):
    """Full-sequence mixer.  x [B,S,d] -> (y [B,S,d], final state
    {"conv": the last K-1 pre-activation xBC rows, "ssd"})."""
    get = weight_getter(p, deq)
    B, S, d = x.shape
    zxbcdt = x @ get("in_proj").to(x.dtype)
    z, xBC_pre, dt = _split_proj(cfg, zxbcdt)
    xBC = F.silu(_causal_conv(xBC_pre, p["conv_w"].to(x.dtype),
                              p["conv_b"].to(x.dtype)))
    xs, dA, Bm, Cm, dt_sp = _ssd_inputs(cfg, p, xBC, dt)
    ssd0 = None if h0 is None else h0["ssd"]
    y, h_final = ssd_chunked(xs * dt_sp[..., None], dA, Bm, Cm,
                             cfg.ssm_chunk, ssd0)
    y = y + p["D"].to(torch.float32)[None, None, :, None] * xs
    y = y.reshape(B, S, cfg.ssm_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": p["norm"]}, y, cfg.norm_eps)
    out = y @ get("out_proj").to(x.dtype)
    # The decode conv window needs the last K-1 PRE-activation xBC rows,
    # left-padded with zeros when the prompt is shorter.
    K = cfg.ssm_conv
    conv_state = (xBC_pre[:, S - (K - 1):, :] if S >= K - 1 else
                  F.pad(xBC_pre, (0, 0, K - 1 - S, 0)))
    return out, {"conv": conv_state, "ssd": h_final}


def mamba_decode(p, x, cfg: ModelConfig, state, deq=None):
    """One-token recurrent step.  x [B,1,d] -> (y [B,1,d], new_state).

    The window ``[conv state | new row]`` takes the wider of the state's
    and the activations' dtypes, as the reference's promotion does."""
    get = weight_getter(p, deq)
    B = x.shape[0]
    di = cfg.ssm_inner
    zxbcdt = x[:, 0, :] @ get("in_proj").to(x.dtype)       # [B, d_in]
    z, xBC_new, dt = _split_proj(cfg, zxbcdt)

    wdt = torch.promote_types(state["conv"].dtype, x.dtype)
    window = torch.cat([state["conv"].to(wdt),
                        xBC_new[:, None, :].to(wdt)], dim=1)
    w = p["conv_w"].to(x.dtype).to(wdt)                    # [K, D]
    xBC = (torch.einsum("bkd,kd->bd", window, w)
           + p["conv_b"].to(x.dtype).to(wdt))
    xBC = F.silu(xBC)

    xs, dA, Bm, Cm, dt_sp = _ssd_inputs(cfg, p, xBC, dt)   # x [B,H,P]
    dec = torch.exp(dA)                                    # [B,H]
    inj = torch.einsum("bhp,bn->bhpn", xs * dt_sp[..., None], Bm)
    h = state["ssd"] * dec[:, :, None, None] + inj
    y = torch.einsum("bn,bhpn->bhp", Cm, h)
    y = y + p["D"].to(torch.float32)[None, :, None] * xs
    y = y.reshape(B, di).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": p["norm"]}, y, cfg.norm_eps)
    out = (y @ get("out_proj").to(x.dtype))[:, None, :]
    return out, {"conv": window[:, 1:, :], "ssd": h}


def ssd_reference(xdt, dA, Bm, Cm, h0=None):
    """Sequential SSD recurrence in float64, the plain version of
    :func:`ssd_chunked` (same arguments minus the chunk)."""
    xdt, dA, Bm, Cm = (t.to(torch.float64) for t in (xdt, dA, Bm, Cm))
    B, S, H, Pd = xdt.shape
    N = Bm.shape[-1]
    h = (torch.zeros(B, H, Pd, N, dtype=torch.float64, device=xdt.device)
         if h0 is None else h0.to(torch.float64))
    ys = []
    for t in range(S):
        h = h * torch.exp(dA[:, t])[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xdt[:, t], Bm[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h
