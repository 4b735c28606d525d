"""Model substrate: configs, schemas, layers and full-model assembly."""
from .config import ModelConfig, QuantConfig, ShapeConfig, SHAPES
from .transformer import (decode_step, forward_logits, init_cache, lm_loss,
                          model_schema, prefill)

__all__ = ["ModelConfig", "QuantConfig", "ShapeConfig", "SHAPES",
           "model_schema", "forward_logits", "lm_loss", "prefill",
           "decode_step", "init_cache"]
