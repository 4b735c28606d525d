"""Plain float32 reference of an OLMoE-style decoder served from
HOBFLOPS-quantized weights.

The model (OLMoE, arXiv:2409.02060, with the program's layout, as the
configuration file lists under ``assumed``): token embedding; per layer
RMSNorm, attention with per-head RMSNorm of q and k (qk-norm), rotary
embedding (half split) and a causal softmax, its output projection and a
residual add; RMSNorm, a softmax router over ``num_experts`` whose top
``num_experts_per_tok`` gates are renormalised, SwiGLU experts and a
residual add; a final RMSNorm and the logits over the padded vocabulary.

Routing runs under the program's capacity rule: within a group of T
tokens (a prompt's row at prefill, a single token at each decode step),
an expert keeps its first ``C(T)`` assignments in (token, choice) order
and drops the rest.

The quantized weights are worked out again from the float32 draw with
this file's own HOBFLOPS storage codec (``storage_round``): a per-slice
scale that puts the largest magnitude at 2^(emax - bias - 1), round to
nearest even into (w_e, w_f), flush below the smallest normal, saturate
above the largest.  Nothing here imports the program.

``lowp`` runs the same forward with every matmul the program runs in
bfloat16 taken in float8 (e4m3, one scale a tensor): the control.
"""
from __future__ import annotations

import math

import torch

FLT_MIN = 2.0 ** -126


def flush(t):
    return torch.where(t.abs() < FLT_MIN, t * 0, t)


def storage_round(v: torch.Tensor, w_e: int, w_f: int) -> torch.Tensor:
    """float32 values -> the nearest value of the exception-free storage
    format (w_e, w_f), as float32.  Zero and float32 subnormals give +0;
    results below 2^-bias flush to +0; exactly 2^-bias takes the next
    code up (code 0 means zero); results past the largest saturate."""
    bias = (1 << (w_e - 1)) - 1
    emax = (1 << w_e) - 1
    a = v.abs()
    m, e = torch.frexp(a)                       # a = m 2^e, m in [.5, 1)
    r = torch.round(m * float(1 << (w_f + 1)))  # half to even
    q = torch.ldexp(r, (e - (w_f + 1)).to(torch.float32))
    lo, hi = 2.0 ** -bias, (2.0 - 2.0 ** -w_f) * 2.0 ** (emax - bias)
    q = torch.where(q == lo, lo * (1 + 2.0 ** -w_f), q)
    q = torch.clamp(q, max=hi)
    q = torch.where((q < lo) | (a < FLT_MIN), 0.0, q)
    return torch.where((v < 0) & (q > 0), -q, q)


def quantized(w: torch.Tensor, w_e: int, w_f: int) -> torch.Tensor:
    """The float32 weight a HOBFLOPS-stored slice stands for."""
    w = flush(w.to(torch.float32))
    bias = (1 << (w_e - 1)) - 1
    emax = (1 << w_e) - 1
    amax = torch.clamp(w.abs().max(), min=1e-30)
    scale = flush(amax / 2.0 ** (emax - bias - 1))
    return flush(flush(storage_round(w / scale, w_e, w_f)) * scale)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale (its largest magnitude at
    448)."""
    s = torch.clamp(x.abs().max(), min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def capacity(cfg: dict, t: int) -> int:
    """Slots an expert keeps in a group of ``t`` tokens."""
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    c = int(cfg["capacity_factor"] * t * k / e)
    c = max(c, k, 8)
    return min(-(-c // 8) * 8, t * k)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x [L, H, D], pos [L]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


class Reference:
    """Weights layer by layer from ``leaf(path, layer)`` (float32 draws),
    quantized where ``cfg["quantized"]`` names the leaf (its last two
    path keys, as ``attn.wq``)."""

    def __init__(self, cfg: dict, leaf, lowp: bool = False):
        self.cfg, self.leaf, self.lowp = cfg, leaf, lowp
        self.w_e, self.w_f = cfg["weight_format"]

    def weight(self, path, layer=None):
        w = self.leaf(path, layer)
        if ".".join(path[-2:]) in self.cfg["quantized"]:
            w = quantized(w, self.w_e, self.w_f)
        return fp8(w) if self.lowp and w.dim() >= 2 else w

    def mm(self, x, w):
        return (fp8(x) if self.lowp else x) @ w

    def forward(self, tokens: torch.Tensor, prompt_len: int,
                at: torch.Tensor) -> torch.Tensor:
        """tokens [B, L] (each row a padded prompt of ``prompt_len``
        tokens, then generated ones) -> float32 logits [B, len(at), V] at
        positions ``at``."""
        c = self.cfg
        eps, theta = c["rms_norm_eps"], c["rope_theta"]
        hq, hkv = c["num_attention_heads"], c["num_key_value_heads"]
        n_b, n_l = tokens.shape
        x = self.leaf(("embed", "table"), None)[tokens]       # [B, L, d]
        dh = x.shape[-1] // hq
        pos = torch.arange(n_l, device=x.device)
        causal = torch.ones(n_l, n_l, dtype=torch.bool,
                            device=x.device).tril()
        b = ("blocks", "b0")
        for i in range(c["num_hidden_layers"]):
            h = rmsnorm(x, self.leaf(b + ("pre_norm", "scale"), i), eps)
            q = self.mm(h, self.weight(b + ("attn", "wq"), i))
            k = self.mm(h, self.weight(b + ("attn", "wk"), i))
            v = self.mm(h, self.weight(b + ("attn", "wv"), i))
            qn = self.leaf(b + ("attn", "q_norm"), i)
            kn = self.leaf(b + ("attn", "k_norm"), i)
            o = torch.empty_like(q)
            for r in range(n_b):
                qr = rope(rmsnorm(q[r].view(n_l, hq, dh), qn, eps), pos,
                          theta)
                kr = rope(rmsnorm(k[r].view(n_l, hkv, dh), kn, eps), pos,
                          theta)
                vr = v[r].view(n_l, hkv, dh)
                g = hq // hkv
                kr = kr.repeat_interleave(g, dim=1)
                vr = vr.repeat_interleave(g, dim=1)
                s = torch.einsum("qhd,khd->hqk", qr, kr) / math.sqrt(dh)
                s = torch.where(causal, s, -math.inf)
                o[r] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                    vr).reshape(n_l, hq * dh)
            x = x + self.mm(o, self.weight(b + ("attn", "wo"), i))
            h = rmsnorm(x, self.leaf(b + ("mlp_norm", "scale"), i), eps)
            x = x + self.moe(h, i, prompt_len)
        h = rmsnorm(x[:, at], self.leaf(("final_norm", "scale"), None), eps)
        return self.mm(h, self.weight(("logits", "w"), None))

    def moe(self, h, i: int, prompt_len: int):
        """h [B, L, d] -> [B, L, d]: prompt rows routed as one group
        each, every later position as a group of its own."""
        c = self.cfg
        e, k = c["num_experts"], c["num_experts_per_tok"]
        n_b, n_l, d = h.shape
        b = ("blocks", "b0", "moe")
        probs = torch.softmax(h @ self.leaf(b + ("router",), i), -1)
        gate, expert = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        gate, expert = gate[..., :k], expert[..., :k]
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        keep = torch.ones_like(expert, dtype=torch.bool)
        cp = capacity(c, prompt_len)
        onehot = torch.nn.functional.one_hot(
            expert[:, :prompt_len].reshape(n_b, -1), e)       # [B, S k, E]
        rank = ((onehot.cumsum(1) - 1) * onehot).sum(-1)
        keep[:, :prompt_len] = (rank < cp).view(n_b, prompt_len, k)
        if capacity(c, 1) < k:
            raise ValueError("a single token's capacity is below top-k")
        weight = (gate * keep).reshape(-1, k)
        expert = expert.reshape(-1, k)
        flat = h.reshape(-1, d)
        y = torch.zeros_like(flat)
        wg = self.weight(b + ("w_gate",), i)
        wu = self.weight(b + ("w_up",), i)
        wd = self.weight(b + ("w_down",), i)
        for j in range(e):
            tok, slot = torch.nonzero(expert == j, as_tuple=True)
            if tok.numel() == 0:
                continue
            xs = flat[tok]
            hid = torch.nn.functional.silu(self.mm(xs, wg[j])) \
                * self.mm(xs, wu[j])
            y.index_add_(0, tok, self.mm(hid, wd[j])
                         * weight[tok, slot, None])
        return y.view(n_b, n_l, d)
