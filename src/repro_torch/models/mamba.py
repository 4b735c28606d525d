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
from .layers import weight_getter
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
    """``in_proj``'s output [..., d_in] as (z, x, BC, dt): the gate, the
    SSD input, the B and C columns and the raw step sizes."""
    di, N, H = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    if zxbcdt.shape[-1] != 2 * di + 2 * N + H:
        raise ValueError(f"in_proj gives {zxbcdt.shape[-1]} columns for "
                         f"d_inner {di}, state {N} and {H} heads")
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di],
            zxbcdt[..., 2 * di:2 * di + 2 * N], zxbcdt[..., 2 * di + 2 * N:])


def _ssd_inputs(cfg: ModelConfig, dt_bias, A_log, xBC, dt):
    """Post-conv xBC + raw dt of a rank's heads (all of them off a mesh)
    -> f32 (x [.., H, P], dA, Bm, Cm, dt_sp)."""
    N, Pd = cfg.ssm_state, cfg.ssm_headdim
    H = dt.shape[-1]
    di = H * Pd
    x = xBC[..., :di].to(torch.float32)
    Bm = xBC[..., di:di + N].to(torch.float32)
    Cm = xBC[..., di + N:].to(torch.float32)
    dt_sp = F.softplus(dt.to(torch.float32) + dt_bias.to(torch.float32))
    A = -torch.exp(A_log.to(torch.float32))            # [H]
    dA = dt_sp * A                                     # [..., H]
    x = x.reshape(*x.shape[:-1], H, Pd)
    return x, dA, Bm, Cm, dt_sp


def _blocks(cfg: ModelConfig, zxbcdt):
    """(z, x, BC, dt) of ``zxbcdt`` [..., d_in] in their own layouts: z,
    x and dt split by head (``"ssm"``), BC whole.  A column shard of the
    concatenation does not hold whole heads (the split falls where the
    block sizes put it), so on a mesh the activation is first gathered
    whole over the model axis; the split blocks are then local slices."""
    lead = ("batch",) + (None,) * (zxbcdt.ndim - 2)
    z, x, bc, dt = _split_proj(cfg, constrain(zxbcdt, *lead, None))
    return (constrain(z, *lead, "ssm"), constrain(x, *lead, "ssm"), bc,
            constrain(dt, *lead, "ssm"))


def _conv_split(cfg: ModelConfig, t, lead):
    """A tensor over the conv channels ``x | B | C`` (last dim; ``lead``
    the logical axes of the others) as (its x channels split by head,
    its B and C channels whole)."""
    t = constrain(t, *lead, None)
    di = cfg.ssm_inner
    return constrain(t[..., :di], *lead, "ssm"), t[..., di:]


def _body_args(cfg: ModelConfig, p):
    """The body's small parameters laid out for it, and their axes:
    the conv weight and bias split by channel block, the per-head
    vectors cut to a rank's heads."""
    w_x, w_bc = _conv_split(cfg, p["conv_w"], (None,))
    b_x, b_bc = _conv_split(cfg, p["conv_b"], ())
    return ((w_x, w_bc, b_x, b_bc, p["dt_bias"], p["A_log"], p["D"]),
            ((None, "ssm"), (None, None), ("ssm",), (None,), ("ssm",),
             ("ssm",), ("ssm",)))


def _gated_norm(cfg: ModelConfig, y, norm):
    """``rmsnorm`` over d_inner of the gated ``y`` [..., di] split by
    head: each rank's mean square, weighted by its share of the width,
    is a partial sum across the ranks (exactly the mean off a mesh: the
    weight is 1), then each rank scales its columns."""
    cols = ("batch",) + (None,) * (y.ndim - 2)
    ms = shard_local(functools.partial(_mean_square, width=cfg.ssm_inner),
                     (y,), ((*cols, "ssm"),), partial_of=(0, y.ndim - 1))
    return shard_local(functools.partial(_scaled, eps=cfg.norm_eps),
                       (y, ms, norm), ((*cols, "ssm"), (*cols, None),
                                       ("ssm",)))


def _mean_square(y, *, width: int):
    share = y.shape[-1] / width
    return torch.mean(torch.square(y.to(torch.float32)), dim=-1,
                      keepdim=True) * share


def _scaled(y, ms, scale, *, eps: float):
    """As ``layers.rmsnorm`` given the mean square ``ms``."""
    out = y.to(torch.float32) * torch.rsqrt(ms + eps)
    return (out * scale.to(torch.float32)).to(y.dtype)


def mamba(p, x, cfg: ModelConfig, deq=None, h0=None):
    """Full-sequence mixer.  x [B,S,d] -> (y [B,S,d], final state
    {"conv": the last K-1 pre-activation xBC rows, "ssd"}).

    Between the two projections every step works on one batch row and
    one head (the causal conv on its channels, the SSD scan, the gate;
    B and C are shared by all heads), so on a mesh the body runs on
    each rank's rows and heads (``shard_local``), as the reference
    anchors them; the gated norm then sums across the heads' ranks, and
    ``out_proj`` contracts the split width to a partial sum."""
    get = weight_getter(p, deq)
    zxbcdt = constrain(x @ get("in_proj").to(x.dtype),
                       "batch", None, "ssm")
    z, xs, bc, dt = _blocks(cfg, zxbcdt)
    small, small_axes = _body_args(cfg, p)
    rows = ("batch", None, "ssm")
    extra = () if h0 is None else (h0["ssd"],)
    y, conv_x, conv_bc, h_final = shard_local(
        functools.partial(_mix, cfg=cfg, dtype=x.dtype),
        (z, xs, bc, dt) + small + extra,
        (rows, rows, ("batch", None, None), rows) + small_axes
        + (("batch", "ssm", None, None),) * len(extra),
        out_like=(0, 1, 2, (3, (0, 2, None, None))))
    y = _gated_norm(cfg, y, p["norm"])
    conv = torch.cat([constrain(conv_x, "batch", None, None), conv_bc], -1)
    return y @ get("out_proj").to(x.dtype), {"conv": conv, "ssd": h_final}


def _mix(z, x, bc, dt, w_x, w_bc, b_x, b_bc, dt_bias, A_log, D, ssd0=None,
         *, cfg: ModelConfig, dtype):
    """The mixer between its projections on a rank's heads: (gated y
    [B,S,di], the conv state of the x and of the B/C channels, final
    SSD state)."""
    B, S, di = x.shape
    xBC_pre = torch.cat([x, bc], -1)
    w = torch.cat([w_x, w_bc], -1).to(dtype)
    xBC = F.silu(_causal_conv(xBC_pre, w, torch.cat([b_x, b_bc]).to(dtype)))
    xs, dA, Bm, Cm, dt_sp = _ssd_inputs(cfg, dt_bias, A_log, xBC, dt)
    y, h_final = ssd_chunked(xs * dt_sp[..., None], dA, Bm, Cm,
                             cfg.ssm_chunk, ssd0)
    y = y + D.to(torch.float32)[None, None, :, None] * xs
    y = y.reshape(B, S, di).to(dtype)
    y = y * F.silu(z)
    # The decode conv window needs the last K-1 PRE-activation xBC rows,
    # left-padded with zeros when the prompt is shorter.
    K = cfg.ssm_conv
    conv = (xBC_pre[:, S - (K - 1):, :] if S >= K - 1 else
            F.pad(xBC_pre, (0, 0, K - 1 - S, 0)))
    return y, conv[..., :di], conv[..., di:], h_final


def mamba_decode(p, x, cfg: ModelConfig, state, deq=None):
    """One-token recurrent step.  x [B,1,d] -> (y [B,1,d], new_state).

    The window ``[conv state | new row]`` takes the wider of the state's
    and the activations' dtypes, as the reference's promotion does.  On
    a mesh the step runs on each rank's rows and heads, as
    :func:`mamba`'s body: the SSD state stays split by head from the
    cache through the step and back."""
    get = weight_getter(p, deq)
    zxbcdt = x[:, 0, :] @ get("in_proj").to(x.dtype)       # [B, d_in]
    z, xs, bc, dt = _blocks(cfg, zxbcdt)
    conv_x, conv_bc = _conv_split(cfg, state["conv"], ("batch", None))
    small, small_axes = _body_args(cfg, p)
    rows = ("batch", "ssm")
    y, conv_x, conv_bc, h = shard_local(
        functools.partial(_step, cfg=cfg, dtype=x.dtype),
        (z, xs, bc, dt, conv_x, conv_bc, state["ssd"]) + small,
        (rows, rows, ("batch", None), rows, ("batch", None, "ssm"),
         ("batch", None, None), ("batch", "ssm", None, None)) + small_axes,
        out_like=(0, 4, 5, 6))
    y = _gated_norm(cfg, y, p["norm"])
    conv = torch.cat([constrain(conv_x, "batch", None, None), conv_bc], -1)
    return (y @ get("out_proj").to(x.dtype))[:, None, :], {"conv": conv,
                                                          "ssd": h}


def _step(z, x, bc, dt, conv_x, conv_bc, ssd, w_x, w_bc, b_x, b_bc,
          dt_bias, A_log, D, *, cfg: ModelConfig, dtype):
    """The recurrent step between the projections on a rank's heads:
    (gated y [B,di], the new conv window of the x and of the B/C
    channels, the new SSD state)."""
    B, di = x.shape
    conv = torch.cat([conv_x, conv_bc], -1)
    xBC_new = torch.cat([x, bc], -1)
    wdt = torch.promote_types(conv.dtype, dtype)
    window = torch.cat([conv.to(wdt), xBC_new[:, None, :].to(wdt)], dim=1)
    w = torch.cat([w_x, w_bc], -1).to(dtype).to(wdt)       # [K, D]
    xBC = (torch.einsum("bkd,kd->bd", window, w)
           + torch.cat([b_x, b_bc]).to(dtype).to(wdt))
    xBC = F.silu(xBC)

    xs, dA, Bm, Cm, dt_sp = _ssd_inputs(cfg, dt_bias, A_log, xBC,
                                        dt)                # x [B,H,P]
    dec = torch.exp(dA)                                    # [B,H]
    inj = torch.einsum("bhp,bn->bhpn", xs * dt_sp[..., None], Bm)
    h = ssd * dec[:, :, None, None] + inj
    y = torch.einsum("bn,bhpn->bhp", Cm, h)
    y = y + D.to(torch.float32)[None, :, None] * xs
    y = y.reshape(B, di).to(dtype)
    y = y * F.silu(z)
    return y, window[:, 1:, :di], window[:, 1:, di:], h


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
