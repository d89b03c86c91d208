"""Model families of the port."""
from .transformer import (TransformerConfig, TransformerDecodeModel,
                          init_transformer, params_from_jax,
                          transformer_forward, transformer_loss)

__all__ = ["TransformerConfig", "TransformerDecodeModel",
           "init_transformer", "params_from_jax", "transformer_forward",
           "transformer_loss"]
