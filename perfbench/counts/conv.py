"""Frozen work counts of a HOBFLOPS conv stack (a configuration's
``layers`` at ``input_hwc``), and the fused MAC kernel's bound.

MACs: Ho x Wo x kh x kw x cin x cout a conv and image (SAME padding,
``stride``): 565,182,464 an image for ``mobilenet-14x14x512-h9``.
Logic operations: MACs x the format's avx512 cells per 4-channel chain
step / 4 / 32 lanes (``mac_gates.<format>.json``).  Bytes of one
``fused_mac`` launch, each read or written once: the per-pixel input
masks ``[P, K, nbits]`` int32, the weight planes ``[K, nbits, cout/32]``
int32 and the output planes ``[acc nbits, P, cout/32]`` int32 (``nbits``
of the format, 3 + w_e + w_f; the accumulator's one more).  Peaks:
``h100.json``."""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _json(name: str) -> dict:
    with open(HERE / name) as f:
        return json.load(f)


def _nbits(fmt: str) -> int:
    n = int(fmt.removeprefix("hobflops"))     # hobflopsN: 3 + 5 + (N - 6)
    return n + 2


def _shapes(cfg: dict):
    h, w, _ = cfg["input_hwc"]
    for s in cfg["layers"]:
        st = s.get("stride", 1)
        h, w = -(-h // st), -(-w // st)
        yield h * w, s["kh"] * s["kw"] * s["cin"], s["cout"]


def macs_per_image(cfg: dict) -> int:
    return sum(p * k * m for p, k, m in _shapes(cfg))


def logic_ops(cfg: dict, images: int) -> float:
    g = _json(f"mac_gates.{cfg['format']}.json")
    return macs_per_image(cfg) * images * g["cells_per_4_channels"] / 4 \
        / g["lanes"]


def fused_mac_bytes(cfg: dict, images: int) -> float:
    nb = _nbits(cfg["format"])
    return images * sum(4 * (p * k * nb + k * nb * m / 32
                             + (nb + 1) * p * m / 32)
                        for p, k, m in _shapes(cfg))


def fused_mac_bound_s(cfg: dict, images: int) -> float:
    """The least time the card takes for the wave's MACs: the larger of
    the logic operations at the logic peak and the bytes at HBM's."""
    peak = _json("h100.json")
    return max(logic_ops(cfg, images) / peak["logic_ops_per_s"],
               fused_mac_bytes(cfg, images) / peak["hbm_bytes_per_s"])
