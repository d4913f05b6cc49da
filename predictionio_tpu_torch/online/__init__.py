"""Continuous learning: WAL tail -> snapshot refresh -> fold-in -> hot swap.

Port of ``predictionio_tpu/online`` (``pio retrain --follow``):

- :mod:`online.follower` tails the ingest WAL from a durable cursor, so
  "did anything new land, and for whom?" never rescans SQL;
- :mod:`online.foldin` solves ONLY the touched user rows against frozen
  item factors (kernel B1 on the card), with a staleness budget that
  escalates to a full retrain when drift gets too large;
- :mod:`online.registry` stores every produced model as an immutable,
  CRC-guarded, monotonically versioned generation with instant rollback;
- :mod:`online.loop` orchestrates the cycle and hot-swaps each version
  into running query servers (the swap epoch of
  ``workflow/create_server``).

Crash anywhere recovers from the cursor + registry manifests: the cursor
only advances past records whose model version was published AND
swapped, and fold-in re-derives touched users' factors from their FULL
history, so overlapping replay windows are harmless by construction.
"""

from predictionio_tpu_torch.online.follower import TailCursor, WalTail
from predictionio_tpu_torch.online.foldin import (
    FoldinDelta,
    StalenessBudget,
    fold_in_users,
)
from predictionio_tpu_torch.online.registry import ModelRegistry, RegistryError
from predictionio_tpu_torch.online.loop import RetrainConfig, RetrainLoop

__all__ = [
    "FoldinDelta",
    "ModelRegistry",
    "RegistryError",
    "RetrainConfig",
    "RetrainLoop",
    "StalenessBudget",
    "TailCursor",
    "WalTail",
    "fold_in_users",
]
