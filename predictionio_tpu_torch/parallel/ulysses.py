"""Ulysses-style sequence parallelism: all-to-all head-scatter attention.

Port of ``predictionio_tpu/parallel/ulysses.py``, the second strategy
beside ``parallel.ring_attention``, on each rank's blocks
(``parallel.mesh.seq_parallel_shard_map``'s contract: q, k, v ``[B/d, T/s,
H, D]``, the key mask ``[B/d, T/s]``). One all-to-all swaps the sharded
dim from sequence to heads, every rank attends over the full sequence for
its head group, a second all-to-all swaps back:

- ``all_to_all(split=2 heads, concat=1 seq)``: ``[B, T, H/s, D]``, head
  group ``r`` on the axis's rank ``r`` (the reference's tiled order, so
  ``proj`` sees the heads where it put them);
- an ``all_gather`` of the key mask along the sequence: ``[B, T]``;
- the local attention: ``ops/flash_attention.flash_attention`` when
  ``use_flash`` (on the card kernel B4 forward and the fused B5 + B6
  backward through its autograd Function; on the CPU their plain twins),
  else ``plain_attention``;
- the inverse ``all_to_all(split=1 seq, concat=2 heads)``.

Both all-to-alls are differentiable (``parallel.mesh.all_to_all``: the
backward swaps the axes). H must divide over the axis: heads are the
scattered dim (the reference's ``ValueError``).
"""

from __future__ import annotations

import functools

import torch

from predictionio_tpu_torch.parallel.mesh import all_gather, all_to_all, seq_parallel_shard_map
from predictionio_tpu_torch.parallel.ring_attention import plain_attention


def _ulysses_local(q, k, v, kv_mask, *, mesh, axis_name: str, causal: bool, sm_scale,
                   use_flash: bool = False):
    """One rank's body. Shapes: q,k,v [B, Tl, H, D]; kv_mask [B, Tl].

    all_to_all #1: shard heads, gather sequence  -> [B, T, H/sp, D]
    local attention over the full sequence for H/sp heads
    all_to_all #2: shard sequence, gather heads  -> [B, Tl, H, D]
    """
    scatter = lambda x: all_to_all(mesh, axis_name, x, split_axis=2, concat_axis=1)
    q_h, k_h, v_h = scatter(q), scatter(k), scatter(v)
    mask_full = all_gather(mesh, axis_name, kv_mask, dim=1)
    if use_flash:
        from predictionio_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(q_h, k_h, v_h, mask_full, causal=causal, sm_scale=sm_scale)
    else:
        out = plain_attention(q_h, k_h, v_h, causal=causal, mask=mask_full,
                              sm_scale=sm_scale)
    return all_to_all(mesh, axis_name, out, split_axis=1, concat_axis=2)


def ulysses_attention(
    q,
    k,
    v,
    mesh,
    axis_name: str = "seq",
    causal: bool = True,
    mask=None,
    sm_scale: float | None = None,
    use_flash: bool = False,
):
    """Attention with the sequence dim sharded over ``mesh[axis_name]``.

    Same contract as ``ring_attention``: this rank's q,k,v ``[B/d, T/s, H,
    D]`` blocks and optional ``[B/d, T/s]`` key validity mask; the result
    is this rank's ``[B/d, T/s, H, D]`` block. H must be divisible by the
    axis size (heads are the scattered dim).
    """
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    axis_size = mesh.shape[axis_name] if axis_name in mesh.axis_names else 1
    h = q.shape[2]
    if h % axis_size:
        raise ValueError(
            f"ulysses needs num_heads ({h}) divisible by the '{axis_name}' "
            f"axis size ({axis_size}); use ring attention otherwise"
        )
    fn = seq_parallel_shard_map(
        functools.partial(_ulysses_local, mesh=mesh, axis_name=axis_name, causal=causal,
                          sm_scale=sm_scale, use_flash=use_flash),
        mesh,
        axis_name,
    )
    return fn(q, k, v, mask)
