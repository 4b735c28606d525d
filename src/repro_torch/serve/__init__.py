"""LM serving: prefill and greedy decode steps, and the wave-scheduled
engine."""
from .engine import Request, ServeEngine
from .steps import make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step", "Request",
           "ServeEngine"]
