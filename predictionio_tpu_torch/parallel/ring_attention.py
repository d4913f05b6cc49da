"""Ring attention: sequence-parallel attention over a mesh axis.

Port of ``predictionio_tpu/parallel/ring_attention.py``.

``plain_attention`` (reference ``:33``) is the single-device attention on
tensors: the full ``[B, H, T, T]`` score matrix, masked scores set to the
finite -1e30, a softmax over the keys. A query row whose every key is
masked returns the uniform average of the values (the flash kernels and
the ring return 0 there).

``ring_attention`` (reference ``:110``) runs on each rank's blocks of a
sequence sharded over ``mesh[axis_name]`` (``parallel.mesh.
seq_parallel_shard_map``'s contract: q, k, v ``[B/d, T/s, H, D]``, the key
mask ``[B/d, T/s]``). The queries stay put; the key/value blocks and
their mask go round the ring, one ``ppermute`` hop (rank j to j + 1) a
step, and each step folds the block in with the flash online softmax
carried across steps: step 0 folds the resident block, every later step
rotates first and then folds, so no hop carries a block nobody reads; the
output is ``o / max(l, 1e-20)``. Query and key positions are global (the
rank's ``axis_index`` times the block length), so causality holds across
blocks. The body is plain torch, as the reference's is plain ``jnp``: no
kernel runs in it. Autograd differentiates through the loop; the shift's
backward is the shift back (``parallel.mesh.ppermute``), as JAX's
transpose of ``ppermute`` inside ``scan``.
"""

from __future__ import annotations

import functools

import torch

from predictionio_tpu_torch.parallel.mesh import ppermute, seq_parallel_shard_map

_NEG = -1e30  # finite "masked" score: keeps exp() NaN-free on all-masked rows


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Reference attention. Shapes: q,k,v [B, T, H, D] -> [B, T, H, D].

    ``mask``: optional [B, Tk] key validity (padding) mask.
    """
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        cm = torch.arange(tq, device=q.device)[:, None] >= torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(~cm[None, None], _NEG)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _ring_attention_local(q, k, v, kv_mask, *, mesh, axis_name: str, causal: bool,
                          sm_scale):
    """One rank's body: local queries stay put, K/V blocks rotate the ring.

    Shapes (per rank): q,k,v [B, Tl, H, D]; kv_mask [B, Tl] bool.
    """
    b, t_local, h, d = q.shape
    axis_size = mesh.axis_size(axis_name)
    my_rank = mesh.axis_index(axis_name)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    local = torch.arange(t_local, device=q.device)
    q_pos = my_rank * t_local + local  # global query positions

    def accumulate(acc, blocks, i):
        """Fold one K/V block (originally from rank ``my_rank - i``) into
        the running flash-attention statistics."""
        o, m, l = acc
        k_blk, v_blk, msk_blk = blocks
        src = (my_rank - i) % axis_size
        k_pos = src * t_local + local
        s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
        valid = msk_blk[:, None, None, :]  # [B,1,1,Tk]
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])[None, None]
        s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * valid  # zero fully-masked entries
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
        return o, m_new, l

    o0 = q.new_zeros((b, h, t_local, d))
    m0 = q.new_full((b, h, t_local), _NEG)
    l0 = q.new_zeros((b, h, t_local))
    blocks = (k, v, kv_mask)
    # step 0 folds the resident block; steps 1..S-1 rotate FIRST, then fold
    acc = accumulate((o0, m0, l0), blocks, 0)
    for i in range(1, axis_size):
        blocks = tuple(ppermute(mesh, axis_name, x) for x in blocks)
        acc = accumulate(acc, blocks, i)
    o, _, l = acc
    o = o / torch.clamp(l, min=1e-20)[..., None]
    return o.transpose(1, 2)  # [B, Tl, H, D]


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis_name: str = "seq",
    causal: bool = True,
    mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Attention with the sequence dim sharded over ``mesh[axis_name]``.

    This rank's blocks: q,k,v ``[B/d, T/s, H, D]``; ``mask`` ``[B/d, T/s]``
    marks valid (non-padding) key positions (all valid when None). The
    batch shards over the mesh's ``data`` axis when present (dp x sp
    composes); the result is this rank's ``[B/d, T/s, H, D]`` block.
    """
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    fn = seq_parallel_shard_map(
        functools.partial(_ring_attention_local, mesh=mesh, axis_name=axis_name,
                          causal=causal, sm_scale=sm_scale),
        mesh,
        axis_name,
    )
    return fn(q, k, v, mask)
