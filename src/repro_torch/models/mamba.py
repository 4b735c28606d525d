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

import functools

import torch
import torch.nn.functional as F

from repro_torch._build import resolve_device
from repro_torch.distributed.ctx import constrain, shard_local

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
    # Heads over "model" inside SSD (the chunk axis stays local: the
    # inter-chunk recurrence is sequential).
    xc = constrain(xdt.reshape(B, nc, Q, H, Pd),
                   "batch", None, None, "ssm", None)
    dAc = constrain(dA.reshape(B, nc, Q, H), "batch", None, None, "ssm")
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


def _ssd_inputs(cfg: ModelConfig, dt_bias, A_log, xBC, dt):
    """Post-conv xBC + raw dt -> f32 (x [.., H, P], dA, Bm, Cm, dt_sp)."""
    di, N, H, Pd = (cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads,
                    cfg.ssm_headdim)
    x = xBC[..., :di].to(torch.float32)
    Bm = xBC[..., di:di + N].to(torch.float32)
    Cm = xBC[..., di + N:].to(torch.float32)
    dt_sp = F.softplus(dt.to(torch.float32) + dt_bias.to(torch.float32))
    A = -torch.exp(A_log.to(torch.float32))            # [H]
    dA = dt_sp * A                                     # [..., H]
    x = x.reshape(*x.shape[:-1], H, Pd)
    return x, dA, Bm, Cm, dt_sp


# The small parameters of the mixer body, in :func:`_mix`'s order.
_BODY = ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm")
_BODY_AXES = ((None, None),) + ((None,),) * 5


def mamba(p, x, cfg: ModelConfig, deq=None, h0=None):
    """Full-sequence mixer.  x [B,S,d] -> (y [B,S,d], final state
    {"conv": the last K-1 pre-activation xBC rows, "ssd"}).

    Between the two projections every step works on one batch row, so
    on a mesh the body runs on each rank's rows (``shard_local``), the
    SSD inner features whole: the conv's padding and the SSD scan's
    chunk views have no DTensor rule that keeps them split."""
    get = weight_getter(p, deq)
    zxbcdt = constrain(x @ get("in_proj").to(x.dtype),
                       "batch", None, "ssm")
    extra = () if h0 is None else (h0["ssd"],)
    y, conv_state, h_final = shard_local(
        functools.partial(_mix, cfg=cfg, dtype=x.dtype),
        (zxbcdt,) + tuple(p[n] for n in _BODY) + extra,
        (("batch", None, None),) + _BODY_AXES
        + (("batch", None, None, None),) * len(extra), out_like=(0, 0, 0))
    return y @ get("out_proj").to(x.dtype), {"conv": conv_state,
                                             "ssd": h_final}


def _mix(zxbcdt, conv_w, conv_b, dt_bias, A_log, D, norm, ssd0=None, *,
         cfg: ModelConfig, dtype):
    """The mixer between its projections: (gated, normed y [B,S,di],
    conv state, final SSD state)."""
    B, S, _ = zxbcdt.shape
    z, xBC_pre, dt = _split_proj(cfg, zxbcdt)
    xBC = F.silu(_causal_conv(xBC_pre, conv_w.to(dtype), conv_b.to(dtype)))
    xs, dA, Bm, Cm, dt_sp = _ssd_inputs(cfg, dt_bias, A_log, xBC, dt)
    y, h_final = ssd_chunked(xs * dt_sp[..., None], dA, Bm, Cm,
                             cfg.ssm_chunk, ssd0)
    y = y + D.to(torch.float32)[None, None, :, None] * xs
    y = y.reshape(B, S, cfg.ssm_inner).to(dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": norm}, y, cfg.norm_eps)
    # The decode conv window needs the last K-1 PRE-activation xBC rows,
    # left-padded with zeros when the prompt is shorter.
    K = cfg.ssm_conv
    conv_state = (xBC_pre[:, S - (K - 1):, :] if S >= K - 1 else
                  F.pad(xBC_pre, (0, 0, K - 1 - S, 0)))
    return y, conv_state, h_final


def mamba_decode(p, x, cfg: ModelConfig, state, deq=None):
    """One-token recurrent step.  x [B,1,d] -> (y [B,1,d], new_state).

    The window ``[conv state | new row]`` takes the wider of the state's
    and the activations' dtypes, as the reference's promotion does.  On
    a mesh the step runs on each rank's rows, as :func:`mamba`'s body."""
    get = weight_getter(p, deq)
    zxbcdt = x[:, 0, :] @ get("in_proj").to(x.dtype)       # [B, d_in]
    y, conv, h = shard_local(
        functools.partial(_step, cfg=cfg, dtype=x.dtype),
        (zxbcdt, state["conv"], state["ssd"])
        + tuple(p[n] for n in _BODY),
        (("batch", None), ("batch", None, None),
         ("batch", None, None, None)) + _BODY_AXES, out_like=(0, 1, 2))
    return (y @ get("out_proj").to(x.dtype))[:, None, :], {"conv": conv,
                                                          "ssd": h}


def _step(zxbcdt, conv, ssd, conv_w, conv_b, dt_bias, A_log, D, norm, *,
          cfg: ModelConfig, dtype):
    """The recurrent step between the projections: (y [B,di], the new
    conv window, the new SSD state)."""
    B = zxbcdt.shape[0]
    z, xBC_new, dt = _split_proj(cfg, zxbcdt)
    wdt = torch.promote_types(conv.dtype, dtype)
    window = torch.cat([conv.to(wdt), xBC_new[:, None, :].to(wdt)], dim=1)
    w = conv_w.to(dtype).to(wdt)                           # [K, D]
    xBC = (torch.einsum("bkd,kd->bd", window, w)
           + conv_b.to(dtype).to(wdt))
    xBC = F.silu(xBC)

    xs, dA, Bm, Cm, dt_sp = _ssd_inputs(cfg, dt_bias, A_log, xBC,
                                        dt)                # x [B,H,P]
    dec = torch.exp(dA)                                    # [B,H]
    inj = torch.einsum("bhp,bn->bhpn", xs * dt_sp[..., None], Bm)
    h = ssd * dec[:, :, None, None] + inj
    y = torch.einsum("bn,bhpn->bhp", Cm, h)
    y = y + D.to(torch.float32)[None, :, None] * xs
    y = y.reshape(B, cfg.ssm_inner).to(dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": norm}, y, cfg.norm_eps)
    return y, window[:, 1:, :], h


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
