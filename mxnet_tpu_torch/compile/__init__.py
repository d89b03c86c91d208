"""Program build seam of the port."""
from .builder import ProgramBuilder, TensorSpec

__all__ = ["ProgramBuilder", "TensorSpec"]
