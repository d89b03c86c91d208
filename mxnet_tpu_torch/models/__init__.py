"""Model families of the port: the transformer, and the symbol builders
of ResNet and LeNet."""
from . import lenet, resnet
from .transformer import (TransformerConfig, TransformerDecodeModel,
                          init_transformer, params_from_jax,
                          transformer_forward, transformer_loss)

__all__ = ["TransformerConfig", "TransformerDecodeModel",
           "init_transformer", "params_from_jax", "transformer_forward",
           "transformer_loss", "lenet", "resnet"]
