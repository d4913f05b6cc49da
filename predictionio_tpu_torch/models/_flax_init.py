"""flax's default initializers and array carry-over, shared by the port's
``nn.Module`` models (NCF, SASRec).

- ``embed_normal_``: ``nn.Embed``'s ``variance_scaling(1.0, "fan_in",
  "normal", out_axis=0)``, i.e. N(0, 1/E) for an ``[N, E]`` table.
- ``lecun_normal_``: ``nn.Dense``'s ``lecun_normal`` kernel (a normal
  truncated at two standard deviations, scaled so its standard deviation
  is ``1/sqrt(fan_in)``) and zero bias.
- ``f32``: any array (numpy, a JAX array) as a host f32 tensor, copied.

The values are the port's own, drawn from a ``torch.Generator``, not
flax's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

#: std of a standard normal truncated to [-2, 2] (flax's lecun_normal
#: divides by it so the truncated draw has the intended std)
_TRUNC_STD = 0.87962566103423978


def embed_normal_(table: nn.Embedding, generator) -> None:
    nn.init.normal_(table.weight, 0.0, 1.0 / math.sqrt(table.embedding_dim),
                    generator=generator)


def lecun_normal_(layer: nn.Linear, generator) -> None:
    std = 1.0 / math.sqrt(layer.in_features) / _TRUNC_STD
    nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
