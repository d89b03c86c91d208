"""``mx.nd`` of the port: ``NDArray`` over a torch.Tensor and the
``.params`` format (the imperative op namespace is not yet ported,
ROADMAP A6)."""
from .ndarray import NDArray, array, concatenate, empty, ones, zeros
from .utils import load, save

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "concatenate",
           "load", "save"]
