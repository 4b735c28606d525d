"""The benchmark's inputs, drawn from ``--seed``: conv kernels and image
pools, LM weights and prompts.  The program and the plain reference are
handed the same tensors; the reference can draw any one layer of any
weight again, since each (leaf, layer) has a generator of its own.

Draws run on the device, with a ``torch.Generator`` there, one call a
tensor (a layer slice for stacked LM weights)."""
from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit generator seed for ``keys`` under the run's ``seed``
    (any whole number, negative or past 64 bits included)."""
    h = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def normal(shape, std: float, device, seed: int, *keys) -> torch.Tensor:
    g = generator(device, seed, *keys)
    return torch.randn(tuple(shape), generator=g, device=device,
                       dtype=torch.float32).mul_(std)


# ---------------------------------------------------------------------------
# Conv cells
# ---------------------------------------------------------------------------
def conv_kernels(layers, device, seed: int) -> list[torch.Tensor]:
    """He-normal float32 [kh, kw, cin, cout] kernels, one a layer."""
    return [normal((s["kh"], s["kw"], s["cin"], s["cout"]),
                   math.sqrt(2.0 / (s["kh"] * s["kw"] * s["cin"])),
                   device, seed, "conv", i)
            for i, s in enumerate(layers)]


def image_pool(n: int, hwc, device, seed: int) -> torch.Tensor:
    """[n, H, W, C] standard normal float32 images."""
    return normal((n,) + tuple(hwc), 1.0, device, seed, "images")


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def vocab_padded(cfg: dict) -> int:
    """The vocabulary rounded up to a multiple of 512, as the program
    lays out its embedding and logits."""
    return -(-cfg["vocab_size"] // 512) * 512


def lm_leaves(cfg: dict) -> list[tuple[tuple, tuple, bool, str]]:
    """(path, one layer's shape, stacked over layers?, init) of every
    parameter of a decoder-only MoE transformer with qk-norm, in a fixed
    order.  ``init`` is ``normal`` (std 1 / sqrt(fan-in); 1 for the
    embedding) or ``norm`` (1 + 0.1 N(0, 1), a norm's scale)."""
    d, e, f = cfg["hidden_size"], cfg["num_experts"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // hq
    v = vocab_padded(cfg)
    b = ("blocks", "b0")
    return [
        (("embed", "table"), (v, d), False, "normal"),
        (b + ("pre_norm", "scale"), (d,), True, "norm"),
        (b + ("attn", "wq"), (d, hq * dh), True, "normal"),
        (b + ("attn", "wk"), (d, hkv * dh), True, "normal"),
        (b + ("attn", "wv"), (d, hkv * dh), True, "normal"),
        (b + ("attn", "wo"), (hq * dh, d), True, "normal"),
        (b + ("attn", "q_norm"), (dh,), True, "norm"),
        (b + ("attn", "k_norm"), (dh,), True, "norm"),
        (b + ("mlp_norm", "scale"), (d,), True, "norm"),
        (b + ("moe", "router"), (d, e), True, "normal"),
        (b + ("moe", "w_gate"), (e, d, f), True, "normal"),
        (b + ("moe", "w_up"), (e, d, f), True, "normal"),
        (b + ("moe", "w_down"), (e, f, d), True, "normal"),
        (("final_norm", "scale"), (d,), False, "norm"),
        (("logits", "w"), (d, v), False, "normal"),
    ]


def lm_leaf(cfg: dict, path: tuple, layer: int | None, device,
            seed: int) -> torch.Tensor:
    """One layer of one leaf (``layer`` None: an unstacked leaf)."""
    for p, shape, _, init in lm_leaves(cfg):
        if p == path:
            break
    else:
        raise KeyError(path)
    keys = ("lm",) + path + (layer,)
    if init == "norm":
        return normal(shape, 0.1, device, seed, *keys).add_(1.0)
    std = 1.0 if path == ("embed", "table") else 1.0 / math.sqrt(shape[-2])
    return normal(shape, std, device, seed, *keys)


def lm_tree(cfg: dict, device, seed: int) -> dict:
    """Every leaf, stacked leaves as [layers, ...], as a nested dict."""
    tree: dict = {}
    n = cfg["num_hidden_layers"]
    for path, shape, stacked, _ in lm_leaves(cfg):
        if stacked:
            t = torch.empty((n,) + shape, dtype=torch.float32, device=device)
            for i in range(n):
                t[i] = lm_leaf(cfg, path, i, device, seed)
        else:
            t = lm_leaf(cfg, path, None, device, seed)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def prompt_lengths(mix: dict) -> list[int]:
    """The mix's prompt lengths: the ``batch`` quantiles (i + 1/2) / batch
    of a lognormal of median ``prompt_median`` and shape
    ``prompt_sigma``, clipped to ``prompt_min``..``prompt_max``.  The same
    set for every seed; the seed orders it."""
    n = mix["batch"]
    nd = torch.distributions.Normal(0.0, 1.0)
    z = nd.icdf(torch.tensor([(i + 0.5) / n for i in range(n)],
                             dtype=torch.float64))
    lens = torch.exp(math.log(mix["prompt_median"]) + mix["prompt_sigma"] * z)
    return [int(min(max(round(float(x)), mix["prompt_min"]),
                    mix["prompt_max"])) for x in lens]


def prompts(cfg: dict, mix: dict, device, seed: int, wave: int = 0):
    """-> (tokens [batch, S] int64 on ``device``, lengths): token ids
    uniform over the published vocabulary; each prompt left-padded to the
    longest by repeating its first token (every position a real token,
    as the program's ``ServeEngine`` pads)."""
    lens = prompt_lengths(mix)
    g = generator("cpu", seed, "order", wave)
    order = torch.randperm(len(lens), generator=g).tolist()
    lens = [lens[i] for i in order]
    s = max(lens)
    ids = torch.randint(0, cfg["vocab_size"], (len(lens), s),
                        generator=generator(device, seed, "tokens", wave),
                        device=device)
    for i, n in enumerate(lens):
        ids[i, :s - n] = ids[i, s - n]
    return ids, lens
