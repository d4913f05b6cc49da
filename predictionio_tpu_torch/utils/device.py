"""Device resolution for the port's entry points.

Counterpart of ``predictionio_tpu/utils/platform.py``, with the opposite
policy: the JAX package degrades to the host backend when an accelerator
is missing, the port does not. Every entry point runs on ``cuda`` unless
its caller names ``"cpu"`` (the CPU tests do); with no card and no
explicit CPU request it raises, so a run can never report host numbers
as the card's.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` by default, or the device the caller named.

    On ``cuda`` this also turns TF32 off for matmuls and cuDNN, so the
    stage-2 re-rank and every other float32 product run in full float32
    (the reference's ``preferred_element_type=float32`` arithmetic)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the host"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
