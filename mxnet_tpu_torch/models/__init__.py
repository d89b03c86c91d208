"""Model families of the port: the transformer, and the symbol builders
of ResNet, LeNet and the MLP (``get_symbol(network, ...)`` by name, as
``mxnet_tpu/models/__init__.py:7-10``)."""
import importlib

from . import lenet, mlp, resnet
from .transformer import (TransformerConfig, TransformerDecodeModel,
                          init_transformer, params_from_jax,
                          transformer_forward, transformer_loss)

__all__ = ["TransformerConfig", "TransformerDecodeModel",
           "init_transformer", "params_from_jax", "transformer_forward",
           "transformer_loss", "lenet", "mlp", "resnet", "get_symbol"]


def get_symbol(network, **kwargs):
    """``models.<network>.get_symbol(**kwargs)``; the module is found by
    this package's own name, so an alias of it loads no second copy."""
    return importlib.import_module(__name__ + "." + network).get_symbol(
        **kwargs)
