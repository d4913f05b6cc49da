"""Flash attention: online-softmax attention and its backward on the card.

Port of ``predictionio_tpu/ops/flash_attention.py``. Shapes follow
``plain_attention``: q, k, v ``[B, T, H, D]`` f32; an optional key-validity
``mask`` ``[B, T]`` bool; causal masking over absolute positions;
``sm_scale`` defaults to ``D ** -0.5``. A query row with no valid key
comes out as exactly 0 with ``lse`` about -1e30 and gets no gradient (the
reference's convention, ``:232-235``), where ``plain_attention`` would
return the uniform average of the values. ``lse`` is ``[B, H, T]``: the
reference's ``[B*H, 1, T_padded]`` without its Mosaic padding.

Three kernels, each with its plain torch twin that computes exactly what
the kernel computes (the recomputation form: P is rebuilt from the saved
``lse``, never stored):

- ``flash_forward`` (kernel B4, ``csrc/flash_attention.cu``) and
  ``flash_forward_plain`` -> ``(out, lse)``;
- ``flash_dq`` (B5) and ``flash_dq_plain`` -> ``dq``;
- ``flash_dkv`` (B6) and ``flash_dkv_plain`` -> ``(dk, dv)``.

A CUDA tensor launches the kernel (and counts it in the wrapper's
``launches``) or raises: the kernels take f32, head dims 8, 16, 32 and 64,
and q, k, v whose heads and features are contiguous with one shared
batch and time stride (the thirds of one ``[B, T, 3 H D]`` projection
qualify). A CPU tensor takes the plain version.

``flash_attention`` is the ``torch.autograd.Function`` twin of the
reference's ``custom_vjp`` (``:228``, ``:349``): B4 forward; backward
computes ``delta = rowsum(dO o O)`` in torch, as the reference does
outside Pallas (``:297``), then B5 and B6.
"""

from __future__ import annotations

import torch

#: the reference's finite masked score (keeps exp() NaN-free)
NEG = -1e30

#: head dims the kernels are compiled for (a template parameter)
HEAD_DIMS = (8, 16, 32, 64)


def _check(q, k, v, mask):
    """Shapes, dtypes and devices every version needs; returns
    ``(B, T, H, D)``."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must be one [B, T, H, D] shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("flash attention takes float32 q, k, v")
    b, t = q.shape[:2]
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (b, t)):
        raise ValueError(f"mask must be a [{b}, {t}] bool tensor, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    devices = {x.device for x in (q, k, v) + (() if mask is None else (mask,))}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    return q.shape


def _scale(d: int, sm_scale) -> float:
    return d ** -0.5 if sm_scale is None else float(sm_scale)


def _valid(mask, t: int, causal: bool, device) -> torch.Tensor:
    """``[B or 1, 1, T_query, T_key]``: the key is valid and, with
    ``causal``, not after the query."""
    valid = torch.ones((1, 1, t, t), dtype=torch.bool, device=device)
    if causal:
        valid = torch.tril(valid)
    if mask is not None:
        valid = valid & mask[:, None, None, :]
    return valid


def _probs(q, k, mask, lse, causal, scale):
    """``P = exp(s - lse)`` on valid pairs, 0 elsewhere: ``[B, H, T, T]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    valid = _valid(mask, q.shape[1], causal, q.device)
    return torch.where(valid, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))


def flash_forward_plain(q, k, v, mask=None, causal=True, sm_scale=None):
    """``(out [B, T, H, D], lse [B, H, T])`` in plain torch, the forward
    kernel's arithmetic over the whole key range at once: masked scores
    are -1e30, ``p = exp(s - max) * valid``, ``out = p V / max(l, 1e-20)``,
    ``lse = max + log(max(l, 1e-20))``."""
    _, t, _, d = _check(q, k, v, mask)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * _scale(d, sm_scale)
    valid = _valid(mask, t, causal, q.device)
    s = s.masked_fill(~valid, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1).clamp_min(1e-20)                     # [B, H, T]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v) / l.permute(0, 2, 1)[..., None]
    return out, m[..., 0] + torch.log(l)


def flash_dq_plain(q, k, v, mask, do, lse, delta, causal=True, sm_scale=None):
    """``dq = sum_k P (dO . v - delta) * scale * k`` in plain torch."""
    d = _check(q, k, v, mask)[3]
    scale = _scale(d, sm_scale)
    p = _probs(q, k, mask, lse, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bhqk,bkhd->bqhd", ds, k)


def flash_dkv_plain(q, k, v, mask, do, lse, delta, causal=True, sm_scale=None):
    """``(dk, dv)``: ``dv = sum_q P dO``, ``dk = sum_q P (dO . v - delta)
    * scale * q``, in plain torch."""
    d = _check(q, k, v, mask)[3]
    scale = _scale(d, sm_scale)
    p = _probs(q, k, mask, lse, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    return (torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, do))


def _launch_args(q, k, v):
    """What every kernel needs of the inputs on the card: ``(B, T, H, D,
    batch stride, time stride)``; raises on what the kernels do not
    take."""
    b, t, h, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernels are built for {HEAD_DIMS}")
    strides = {x.stride() for x in (q, k, v)}
    sb, st, sh, sd = q.stride()
    if len(strides) != 1 or sd != 1 or sh != d:
        raise ValueError(
            "q, k, v need contiguous [H, D] rows and one shared batch and time "
            f"stride, got strides {sorted(strides)}"
        )
    return b, t, h, d, sb, st


def _mask_ptr(mask):
    return None if mask is None else mask.data_ptr()


def _call(fn: str, *args) -> None:
    from predictionio_tpu_torch import _kernels

    lib = _kernels.library("flash_attention")
    stream = torch.cuda.current_stream().cuda_stream
    _kernels.check(getattr(lib, fn)(*args, stream), fn)


def flash_forward(q, k, v, mask=None, causal=True, sm_scale=None):
    """``flash_forward_plain``'s ``(out, lse)``. CUDA tensors launch kernel
    B4 (counted in ``flash_forward.launches``) or raise; CPU tensors take
    the plain version."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, mask, causal, sm_scale)
    b, t, h, d, sb, st = _launch_args(q, k, v)
    mask = None if mask is None else mask.contiguous()
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if out.numel():
        with torch.cuda.device(q.device):
            _call("flash_fwd_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  _mask_ptr(mask), out.data_ptr(),
                  lse.data_ptr(), b, t, h, d, sb, st, _scale(d, sm_scale), int(causal))
        flash_forward.launches += 1
    return out, lse


def _backward_operands(q, k, v, mask, do, lse, delta):
    b, t, h, _ = q.shape
    if do.shape != q.shape or do.dtype != torch.float32:
        raise ValueError(f"dO must be f32 {tuple(q.shape)}, got {do.dtype} {tuple(do.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (b, h, t) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [{b}, {h}, {t}], got {x.dtype} {tuple(x.shape)}")
    return do.contiguous(), lse.contiguous(), delta.contiguous()


def flash_dq(q, k, v, mask, do, lse, delta, causal=True, sm_scale=None):
    """``flash_dq_plain``'s ``dq``. CUDA tensors launch kernel B5 (counted
    in ``flash_dq.launches``) or raise; CPU tensors take the plain
    version."""
    _check(q, k, v, mask)
    do, lse, delta = _backward_operands(q, k, v, mask, do, lse, delta)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, mask, do, lse, delta, causal, sm_scale)
    b, t, h, d, sb, st = _launch_args(q, k, v)
    mask = None if mask is None else mask.contiguous()
    dq = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    if dq.numel():
        with torch.cuda.device(q.device):
            _call("flash_dq_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  _mask_ptr(mask), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                  b, t, h, d, sb, st, _scale(d, sm_scale), int(causal))
        flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, mask, do, lse, delta, causal=True, sm_scale=None):
    """``flash_dkv_plain``'s ``(dk, dv)``. CUDA tensors launch kernel B6
    (counted in ``flash_dkv.launches``) or raise; CPU tensors take the
    plain version."""
    _check(q, k, v, mask)
    do, lse, delta = _backward_operands(q, k, v, mask, do, lse, delta)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, mask, do, lse, delta, causal, sm_scale)
    b, t, h, d, sb, st = _launch_args(q, k, v)
    mask = None if mask is None else mask.contiguous()
    dk = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel():
        with torch.cuda.device(q.device):
            _call("flash_dkv_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  _mask_ptr(mask), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  b, t, h, d, sb, st, _scale(d, sm_scale), int(causal))
        flash_dkv.launches += 1
    return dk, dv


#: kernel launches since the last reset (``chip_smoke.py`` reads them to
#: show the training and serving paths went through the kernels)
flash_forward.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """B4 forward; B5 and B6 backward over the saved ``(q, k, v, mask,
    out, lse)``. The module's wrappers are looked up at call time."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, sm_scale):
        out, lse = flash_forward(q, k, v, mask, causal, sm_scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        # delta[b, h, i] = rowsum(dO o O): the softmax Jacobian's correction
        delta = torch.einsum("bthd,bthd->bht", g, out)
        dq = flash_dq(q, k, v, mask, g, lse, delta, ctx.causal, ctx.sm_scale)
        dk, dv = flash_dkv(q, k, v, mask, g, lse, delta, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, mask=None, causal=True, sm_scale=None):
    """Flash attention, q, k, v ``[B, T, H, D]`` -> ``[B, T, H, D]``,
    differentiable in q, k and v. Rows whose every key is masked come
    back 0 (``plain_attention`` would return a uniform average): such
    rows are padding and the caller masks them out of the loss."""
    return _FlashAttention.apply(q, k, v, mask, causal, sm_scale)


__all__ = [
    "HEAD_DIMS",
    "NEG",
    "flash_attention",
    "flash_dkv",
    "flash_dkv_plain",
    "flash_dq",
    "flash_dq_plain",
    "flash_forward",
    "flash_forward_plain",
]
