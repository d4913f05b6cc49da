"""Flash attention: online-softmax attention and its backward on the card.

Port of ``predictionio_tpu/ops/flash_attention.py``. Shapes follow
``plain_attention``: q, k, v ``[B, T, H, D]`` f32; an optional key-validity
``mask`` ``[B, T]`` bool; causal masking over absolute positions;
``sm_scale`` defaults to ``D ** -0.5``. A query row with no valid key
comes out as exactly 0 with ``lse`` about -1e30 and gets no gradient (the
reference's convention, ``:232-235``), where ``plain_attention`` would
return the uniform average of the values. ``lse`` is ``[B, H, T]``: the
reference's ``[B*H, 1, T_padded]`` without its Mosaic padding.

Two kernels, each with its plain torch twin that computes exactly what
the kernel computes (the recomputation form: P is rebuilt from the saved
``lse``, never stored):

- ``flash_forward`` (kernel B4, ``csrc/flash_attention.cu``) and
  ``flash_forward_plain`` -> ``(out, lse)``;
- ``flash_backward`` (the reference's two backward kernels fused,
  ``csrc/flash_backward.cu``) and ``flash_backward_plain`` -> ``(dq,
  dk, dv)`` from ``dO``, ``out`` and ``lse``, ``delta = rowsum(dO o O)``
  included; ``flash_dq_plain`` and ``flash_dkv_plain`` are its parts.

A CUDA tensor launches the kernel (and counts it in the wrapper's
``launches``) or raises: the kernels take f32 and q, k, v whose heads and
features are contiguous with one shared batch and time stride (the thirds
of one ``[B, T, 3 H D]`` projection qualify). They are built for head
dims 8, 16, 32, 64 and 128, and past 128 for every multiple of 64 (one
instance that walks D in 64-column chunks); any other D is zero-padded
to the next of those (``padded_forward``, ``padded_backward``). A CPU
tensor takes the plain version.

``flash_attention`` is the ``torch.autograd.Function`` twin of the
reference's ``custom_vjp`` (``:228``, ``:349``): B4 forward, one fused
backward launch (the reference computes delta outside Pallas, ``:297``,
and runs two backward kernels).
"""

from __future__ import annotations

import torch

from predictionio_tpu_torch.ops.launches import counted

#: the reference's finite masked score (keeps exp() NaN-free)
NEG = -1e30

#: head dims the kernels are compiled for (a template parameter) up to
#: 128; past it one instance takes every multiple of HEAD_DIM_CHUNK
HEAD_DIMS = (8, 16, 32, 64, 128)
HEAD_DIM_CHUNK = 64

#: keys one block of the fused backward owns (``kTile`` in
#: ``csrc/flash_backward.cu``); past one such tile blocks add into dq
KEY_TILE = 64


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


def flash_backward_plain(q, k, v, mask, do, out, lse, causal=True, sm_scale=None):
    """``(dq, dk, dv)`` in plain torch: ``delta = rowsum(dO o O)``, then
    ``flash_dq_plain`` and ``flash_dkv_plain``."""
    delta = torch.einsum("bthd,bthd->bht", do, out)
    dq = flash_dq_plain(q, k, v, mask, do, lse, delta, causal, sm_scale)
    return (dq, *flash_dkv_plain(q, k, v, mask, do, lse, delta, causal, sm_scale))


def _launch_args(q, k, v):
    """What every kernel needs of the inputs on the card: ``(B, T, H, D,
    batch stride, time stride)``; raises on what the kernels do not
    take."""
    b, t, h, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    strides = {x.stride() for x in (q, k, v)}
    sb, st, sh, sd = q.stride()
    if len(strides) != 1 or sd != 1 or sh != d:
        raise ValueError(
            "q, k, v need contiguous [H, D] rows and one shared batch and time "
            f"stride, got strides {sorted(strides)}"
        )
    return b, t, h, d, sb, st


def built_head_dim(d: int) -> int:
    """The smallest head dim the kernels are built for that holds ``d``:
    the next of ``HEAD_DIMS`` up to 128, past it the next multiple of
    ``HEAD_DIM_CHUNK`` (129 -> 192, 256 -> 256, 300 -> 320)."""
    for size in HEAD_DIMS:
        if d <= size:
            return size
    return -(-d // HEAD_DIM_CHUNK) * HEAD_DIM_CHUNK


def _pad(x, dp: int):
    d = x.shape[-1]
    return x if d == dp else torch.nn.functional.pad(x, (0, dp - d))


def padded_forward(forward, q, k, v, mask=None, causal=True, sm_scale=None):
    """``forward`` (``flash_forward`` or its plain version) at the built
    head dim ``built_head_dim(D)``: q, k and v zero-padded along D, the
    caller's scale (``1/sqrt(D)`` of the unpadded D unless given), ``out``
    sliced back to D. Zero columns leave every q.k unchanged and give
    ``out`` zero columns, which are dropped; ``lse`` is unchanged."""
    d = q.shape[-1]
    dp = built_head_dim(d)
    out, lse = forward(_pad(q, dp), _pad(k, dp), _pad(v, dp), mask, causal, _scale(d, sm_scale))
    return out[..., :d].contiguous(), lse


def padded_backward(backward, q, k, v, mask, do, out, lse, causal=True, sm_scale=None):
    """``backward`` (``flash_backward`` or its plain version) at the built
    head dim, as ``padded_forward``: q, k, v, ``do`` and ``out`` zero-padded
    along D, the caller's scale, dq, dk and dv sliced back to D. The zero
    columns leave delta = rowsum(dO o O) and every gradient column below D
    unchanged; theirs come out 0 and are dropped."""
    d = q.shape[-1]
    dp = built_head_dim(d)
    grads = backward(_pad(q, dp), _pad(k, dp), _pad(v, dp), mask, _pad(do, dp), _pad(out, dp),
                     lse, causal, _scale(d, sm_scale))
    return tuple(g[..., :d].contiguous() for g in grads)


def _mask_ptr(mask):
    return None if mask is None else mask.data_ptr()


def _call(fn: str, *args, source: str = "flash_attention") -> None:
    from predictionio_tpu_torch import _kernels

    lib = _kernels.library(source)
    stream = torch.cuda.current_stream().cuda_stream
    _kernels.check(getattr(lib, fn)(*args, stream), fn)


@counted
def flash_forward(q, k, v, mask=None, causal=True, sm_scale=None):
    """``flash_forward_plain``'s ``(out, lse)``. CUDA tensors launch kernel
    B4 (counted in ``flash_forward.launches``; a head dim it is not built
    for through ``padded_forward``) or raise; CPU tensors take the plain
    version."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, mask, causal, sm_scale)
    if built_head_dim(q.shape[-1]) != q.shape[-1]:
        return padded_forward(flash_forward, q, k, v, mask, causal, sm_scale)
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


def _backward_operands(q, full: dict, rows: dict) -> list:
    """Contiguous copies of the backward's extra inputs, ``full`` ones
    (dO, out) shaped like q and ``rows`` ones (lse) ``[B, H, T]``,
    all f32 on q's device; raises on anything else."""
    b, t, h, _ = q.shape
    checked = []
    for name, x in (*full.items(), *rows.items()):
        shape = tuple(q.shape) if name in full else (b, h, t)
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 {list(shape)}, got {x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        checked.append(x.contiguous())
    return checked


@counted
def flash_backward(q, k, v, mask, do, out, lse, causal=True, sm_scale=None):
    """``flash_backward_plain``'s ``(dq, dk, dv)`` from the forward's
    ``out`` and ``lse`` and the gradient ``do``. CUDA tensors launch the
    fused kernel (counted in ``flash_backward.launches``; a head dim it is
    not built for through ``padded_backward``) or raise; CPU tensors take
    the plain version. Beyond one 64-key tile (T > 64) the kernel adds dq
    up with atomics, so its last bits vary run to run."""
    _check(q, k, v, mask)
    do, out, lse = _backward_operands(q, {"dO": do, "out": out}, {"lse": lse})
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, mask, do, out, lse, causal, sm_scale)
    if built_head_dim(q.shape[-1]) != q.shape[-1]:
        return padded_backward(flash_backward, q, k, v, mask, do, out, lse, causal, sm_scale)
    b, t, h, d, sb, st = _launch_args(q, k, v)
    mask = None if mask is None else mask.contiguous()
    zeros_or_empty = torch.zeros if t > KEY_TILE else torch.empty
    dq = zeros_or_empty((b, t, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    if dq.numel():
        with torch.cuda.device(q.device):
            _call("flash_bwd_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  _mask_ptr(mask), do.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  b, t, h, d, sb, st, _scale(d, sm_scale), int(causal), source="flash_backward")
        flash_backward.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """B4 forward; the fused backward over the saved ``(q, k, v, mask,
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
        dq, dk, dv = flash_backward(q, k, v, mask, g, out, lse, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, mask=None, causal=True, sm_scale=None):
    """Flash attention, q, k, v ``[B, T, H, D]`` -> ``[B, T, H, D]``,
    differentiable in q, k and v. Rows whose every key is masked come
    back 0 (``plain_attention`` would return a uniform average): such
    rows are padding and the caller masks them out of the loss."""
    return _FlashAttention.apply(q, k, v, mask, causal, sm_scale)


__all__ = [
    "HEAD_DIMS",
    "HEAD_DIM_CHUNK",
    "NEG",
    "built_head_dim",
    "flash_attention",
    "flash_backward",
    "flash_backward_plain",
    "flash_dkv_plain",
    "flash_dq_plain",
    "flash_forward",
    "flash_forward_plain",
    "padded_backward",
    "padded_forward",
]
