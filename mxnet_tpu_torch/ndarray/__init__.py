"""``mx.nd`` of the port: ``NDArray`` over a torch.Tensor and the
``.params`` format (ROADMAP A2; the imperative op namespace is not yet
ported)."""
from .ndarray import NDArray, array, zeros
from .utils import load, save

__all__ = ["NDArray", "array", "zeros", "load", "save"]
