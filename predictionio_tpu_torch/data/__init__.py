"""Event data of the port: the event record and the columnar training read.

Port of ``predictionio_tpu/data/__init__.py``: the same re-exports of the
event model (``DataMap``, ``Event`` and their errors).
"""

from predictionio_tpu_torch.data.datamap import DataMap, DataMapError, PropertyMap
from predictionio_tpu_torch.data.event import Event, EventValidationError

__all__ = [
    "DataMap",
    "PropertyMap",
    "DataMapError",
    "Event",
    "EventValidationError",
]
