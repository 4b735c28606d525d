"""LM serving steps (prefill, greedy decode)."""
from .steps import make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step"]
