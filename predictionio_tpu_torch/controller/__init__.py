"""DASE controller API of the port (serving half)."""

from predictionio_tpu_torch.controller.base import Algorithm, Params, Serving
from predictionio_tpu_torch.controller.serving import FirstServing

__all__ = ["Algorithm", "FirstServing", "Params", "Serving"]
