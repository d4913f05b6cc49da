"""The port's flash attention against the JAX package's, on the CPU.

The reference runs its Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` does; the port runs the plain versions
that its CUDA kernels (B4 and the fused backward) are held to, and the
head-dim padding its wrappers use for head dims the kernels are not built
for. Tolerances are the reference
tests' own: forward ``out`` and ``lse`` within ``atol`` 2e-5 at T=50
and 3e-5 at T=300 (several 128-key tiles in the reference; f32 sums in
other orders); gradients within 5e-5 at T=40 and 1e-4 at T=256 (the
reference's bars for its backward against ``plain_attention``). A row
with no valid key is exactly 0 with lse about -1e30 in both, and gets no
gradient. Kernel-against-plain tests need a card (``cuda`` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.flash_attention import _flash_forward
from predictionio_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from predictionio_tpu.parallel.ring_attention import plain_attention as jax_plain_attention
from predictionio_tpu_torch.ops import flash_attention as fa
from predictionio_tpu_torch.parallel.ring_attention import plain_attention


def inputs(b=2, t=50, h=2, d=8, seed=0, pads=None):
    """q, k, v [B, T, H, D] f32 and a left-padding key mask (the first
    ``pads[b]`` keys invalid: with causal masking those query rows see no
    valid key), or None."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3))
    mask = None if pads is None else np.arange(t)[None, :] >= np.asarray(pads)[:, None]
    return q, k, v, mask


def torch_args(q, k, v, mask):
    return ([torch.from_numpy(x) for x in (q, k, v)],
            None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("t,atol", [(50, 2e-5), (300, 3e-5)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pads", [None, (0, 7), (12, 30)])
def test_forward_and_lse_match_the_reference(t, atol, causal, pads):
    q, k, v, mask = inputs(t=t, pads=pads, seed=t)
    want_out, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal, None, True)
    b, _, h, _ = q.shape
    want_lse = np.asarray(want_lse).reshape(b, h, -1)[:, :, :t]   # [B*H, 1, T_padded]
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    out, lse = fa.flash_forward(tq, tk, tv, tm, causal)
    assert out.shape == q.shape and lse.shape == (b, h, t)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=atol)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=atol)
    if causal and pads is not None:
        for row, pad in enumerate(pads):  # rows with no valid key
            assert not out[row, :pad].any()
            assert bool((lse[row, :, :pad] <= -1e29).all())


def test_plain_attention_matches_the_reference_copy():
    q, k, v, mask = inputs(t=40, pads=(3, 11))
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    for causal in (True, False):
        want = jax_plain_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                   mask=jnp.asarray(mask))
        got = plain_attention(tq, tk, tv, causal=causal, mask=tm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_equals_plain_attention_on_rows_with_a_valid_key():
    """Away from fully-masked rows the two attentions are one function;
    on such rows flash gives 0 and plain the uniform average."""
    q, k, v, mask = inputs(t=30, pads=(0, 9))
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    got = fa.flash_attention(tq, tk, tv, tm)
    want = plain_attention(tq, tk, tv, mask=tm)
    torch.testing.assert_close(got[:, 9:], want[:, 9:], atol=2e-5, rtol=0)
    torch.testing.assert_close(got[0], want[0], atol=2e-5, rtol=0)
    assert not got[1, :9].any()
    torch.testing.assert_close(want[1, :9], tv[1].mean(0).expand(9, 2, 8), atol=2e-5, rtol=0)


def jax_grads(q, k, v, mask, w, causal):
    def loss(q, k, v):
        m = None if mask is None else jnp.asarray(mask)
        return (jax_flash_attention(q, k, v, m, causal=causal, interpret=True) * w).sum()

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


def torch_grads(q, k, v, mask, w, causal):
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    (fa.flash_attention(*leaves, tm, causal=causal) * torch.from_numpy(w)).sum().backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_the_reference(causal):
    q, k, v, mask = inputs(b=2, t=40, pads=(0, 6), seed=1)
    w = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    for got, want, name in zip(torch_grads(q, k, v, mask, w, causal),
                               jax_grads(q, k, v, mask, w, causal), "qkv"):
        np.testing.assert_allclose(got, want, atol=5e-5, err_msg=f"d{name}")


def test_gradients_match_the_reference_across_tiles():
    q, k, v, _ = inputs(b=1, t=256, h=1, seed=3)
    w = np.ones(q.shape, np.float32)
    for got, want in zip(torch_grads(q, k, v, None, w, True), jax_grads(q, k, v, None, w, True)):
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_fully_masked_rows_get_zero_and_no_nan():
    q, k, v, mask = inputs(b=2, t=20, pads=(5, 20))   # batch row 1: every key masked
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = fa.flash_attention(*leaves, tm)
    out.sum().backward()
    assert not out[0, :5].any() and not out[1].any()
    for g in leaves:
        assert bool(torch.isfinite(g.grad).all())
        assert not g.grad[1].any()                    # nothing reaches a dead row
    assert not leaves[0].grad[0, :5].any()            # nor the queries without keys
    assert not leaves[1].grad[0, :5].any() and not leaves[2].grad[0, :5].any()  # nor masked keys


def test_backward_runs_the_two_backward_wrappers(monkeypatch):
    """The autograd Function calls B4 forward and the fused backward
    (the reference's two backward kernels in one launch) through the
    module's two wrappers, and no other: its gradients are
    ``flash_backward_plain``'s, delta = rowsum(dO o O) included."""
    calls = []
    for name in ("flash_forward", "flash_backward"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    q, k, v, mask = inputs(t=12, pads=(0, 2))
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = fa.flash_attention(*leaves, tm)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(g)
    assert calls == ["flash_forward", "flash_backward"]
    _, lse = fa.flash_forward_plain(tq, tk, tv, tm)
    want = fa.flash_backward_plain(tq, tk, tv, tm, g, out.detach(), lse)
    for leaf, grad in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, grad)


def fused_grads(q, k, v, mask, w, causal):
    """``flash_backward``'s ``(dq, dk, dv)`` on the CPU (its plain
    version) for the cotangent ``w``, from ``flash_forward``'s out, lse."""
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    out, lse = fa.flash_forward(tq, tk, tv, tm, causal)
    grads = fa.flash_backward(tq, tk, tv, tm, torch.from_numpy(w), out, lse, causal)
    return [x.numpy() for x in grads]


@pytest.mark.parametrize("causal", [True, False])
def test_fused_backward_matches_the_reference(causal):
    """The fused backward's CPU path against ``jax.grad`` through the
    reference's Pallas kernels (interpret mode), the same cotangent."""
    q, k, v, mask = inputs(b=2, t=40, pads=(0, 6), seed=4)
    w = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    for got, want, name in zip(fused_grads(q, k, v, mask, w, causal),
                               jax_grads(q, k, v, mask, w, causal), "qkv"):
        np.testing.assert_allclose(got, want, atol=5e-5, err_msg=f"d{name}")


def test_fused_backward_matches_the_reference_across_tiles():
    q, k, v, _ = inputs(b=1, t=256, h=1, seed=6)
    w = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    for got, want, name in zip(fused_grads(q, k, v, None, w, True),
                               jax_grads(q, k, v, None, w, True), "qkv"):
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_fused_backward_gives_dead_rows_and_masked_keys_zero(causal):
    """Batch row 1 masks every key; row 0 its first 5: those queries (with
    causal masking) and those keys get exactly 0 gradient, no NaN."""
    q, k, v, mask = inputs(b=2, t=20, pads=(5, 20), seed=8)
    w = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    dq, dk, dv = fused_grads(q, k, v, mask, w, causal)
    for g in (dq, dk, dv):
        assert np.isfinite(g).all()
        assert not g[1].any()
    assert not dk[0, :5].any() and not dv[0, :5].any()
    if causal:
        assert not dq[0, :5].any()
    assert dq[0, 5:].any() and dk[0, 5:].any() and dv[0, 5:].any()


def test_fused_backward_checks_its_operands():
    q, k, v, mask = inputs(t=10, pads=(0, 3))
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    out, lse = fa.flash_forward(tq, tk, tv, tm)
    do = torch.ones_like(out)
    fa.flash_backward(tq, tk, tv, tm, do, out, lse)
    for bad in ({"do": do.double()}, {"do": do[:, :9]}, {"out": out.double()},
                {"out": out[..., :4]}, {"lse": lse.double()}, {"lse": lse[:, :1]}):
        args = {"do": do, "out": out, "lse": lse, **bad}
        with pytest.raises(ValueError, match=r"(dO|out|lse) must be f32"):
            fa.flash_backward(tq, tk, tv, tm, args["do"], args["out"], args["lse"])


def test_checks_and_scale():
    q, k, v, _ = inputs(t=10)
    (tq, tk, tv), _ = torch_args(q, k, v, None)
    out, _ = fa.flash_forward(tq, tk, tv, None, False, sm_scale=0.5)
    want = plain_attention(tq, tk, tv, causal=False, sm_scale=0.5)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    with pytest.raises(TypeError):
        fa.flash_forward(tq.double(), tk.double(), tv.double())
    with pytest.raises(ValueError, match="mask"):
        fa.flash_forward(tq, tk, tv, torch.ones(2, 9, dtype=torch.bool))
    with pytest.raises(ValueError, match="one"):
        fa.flash_forward(tq, tk[:, :5], tv)


@pytest.mark.parametrize("d", [12, 24, 128, 136, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_head_dim_matches_the_reference(d, causal):
    """The head-dim padding the CUDA wrappers use for a D the kernels are
    not built for: the plain forward and backward at the next built D
    (zero columns, the caller's 1/sqrt(D) scale, sliced back) against the
    reference's ``flash_attention`` and its ``jax.vjp`` at the unpadded D,
    Pallas in interpret mode, within 2e-5."""
    q, k, v, mask = inputs(b=2, t=40, h=2, d=d, pads=(0, 6), seed=d)
    w = np.random.default_rng(d + 1).normal(size=q.shape).astype(np.float32)
    m = jnp.asarray(mask)
    want_out, vjp = jax.vjp(
        lambda q, k, v: jax_flash_attention(q, k, v, m, causal=causal, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(w))
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    assert fa.built_head_dim(d) == {12: 16, 24: 32, 128: 128, 136: 192, 256: 256}[d]
    out, lse = fa.padded_forward(fa.flash_forward_plain, tq, tk, tv, tm, causal)
    assert out.shape == q.shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-5)
    grads = fa.padded_backward(fa.flash_backward_plain, tq, tk, tv, tm, torch.from_numpy(w),
                               out, lse, causal)
    for got, want, name in zip(grads, want_grads, "qkv"):
        assert got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, err_msg=f"d{name}")


def test_padding_keeps_lse_and_zero_columns():
    """Padding changes no score: lse equals the unpadded plain lse, and
    the padded forward's own pad columns of out are exactly 0 (V's zero
    columns), so slicing them off drops nothing."""
    q, k, v, mask = inputs(t=30, d=20, pads=(0, 4), seed=11)
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    want_out, want_lse = fa.flash_forward_plain(tq, tk, tv, tm)
    seen = {}

    def forward(*args):
        seen["out"], lse = fa.flash_forward_plain(*args)
        return seen["out"], lse

    out, lse = fa.padded_forward(forward, tq, tk, tv, tm)
    assert seen["out"].shape[-1] == 32 and not seen["out"][..., 20:].any()
    torch.testing.assert_close(out, want_out, atol=2e-6, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=2e-6, rtol=0)


def test_head_dims_past_the_largest_built_raise():
    """No head dim raises any more: up to 128 the next of the built
    ``HEAD_DIMS``, past it the next multiple of 64 (the chunked
    instance), and the padding takes a D past 128 like any other."""
    assert [fa.built_head_dim(d) for d in (1, 8, 9, 33, 64, 65, 128)] == [
        8, 8, 16, 64, 64, 128, 128]
    assert [fa.built_head_dim(d) for d in (129, 136, 192, 193, 256, 300, 320, 512)] == [
        192, 192, 192, 256, 256, 320, 320, 512]
    q, k, v, _ = inputs(t=4, d=136)
    (tq, tk, tv), _ = torch_args(q, k, v, None)
    seen = {}

    def forward(*args):
        seen["d"] = args[0].shape[-1]
        return fa.flash_forward_plain(*args)

    out, lse = fa.padded_forward(forward, tq, tk, tv)
    want_out, want_lse = fa.flash_forward_plain(tq, tk, tv)
    assert seen["d"] == 192 and out.shape == tq.shape
    torch.testing.assert_close(out, want_out, atol=2e-6, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=2e-6, rtol=0)


# --------------------------------------------------------------------------
# kernel B4 and the fused backward against their plain versions (need a
# card); head dims 24, 12 and 136 go through the padding, 136, 256 and 512
# through the chunked instances
# --------------------------------------------------------------------------


CARD_CASES = [(64, 16), (1, 8), (65, 32), (200, 64), (1024, 16), (64, 128), (1024, 128),
              (64, 24), (200, 24), (65, 12), (64, 136), (200, 256), (200, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", CARD_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain_on_card(t, d, causal):
    """B4 against its plain version on the card, with a fully-masked batch
    row and left padding (head dims 24 and 12 through the padding, one
    launch each); elementwise within 1e-5 of each output's scale (3xTF32
    products, f32 sums of at most T terms in other orders). A row with no
    valid key is exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, mask = inputs(b=3, t=t, h=2, d=d, pads=(0, t // 3, t))
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    args = [x.cuda() for x in (tq, tk, tv)] + [tm.cuda()]
    before = fa.flash_forward.launches
    out, lse = fa.flash_forward(*args, causal)
    torch.cuda.synchronize()
    assert fa.flash_forward.launches == before + 1
    for got, ref in zip((out, lse), fa.flash_forward_plain(*args, causal)):
        assert got.shape == ref.shape and bool(torch.isfinite(got).all())
        scale = ref[ref > -1e29].abs().max().clamp_min(1.0)
        assert float((got - ref).abs().max()) <= 1e-5 * float(scale)
    assert not out[2].any() and bool((lse[2] <= -1e29).all())
    if causal:
        assert not out[1, : t // 3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", CARD_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_fused_backward_matches_plain_on_card(t, d, causal):
    """The fused backward against ``flash_backward_plain`` on the card,
    with a fully-masked batch row and left padding (head dims 24 and 12
    through the padding); elementwise within 1e-5 of each output's scale (f32 sums in other orders; past one 64-key
    tile dq is summed with atomics in an order that varies). Dead rows
    and masked keys exactly 0; one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, mask = inputs(b=3, t=t, h=2, d=d, pads=(0, t // 3, t))
    do = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    args = [x.cuda() for x in (tq, tk, tv)] + [tm.cuda()]
    gd = torch.from_numpy(do).cuda()
    out, lse = fa.flash_forward_plain(*args, causal)
    before = fa.flash_backward.launches
    got = fa.flash_backward(*args, gd, out, lse, causal)
    torch.cuda.synchronize()
    assert fa.flash_backward.launches == before + 1
    for g, ref in zip(got, fa.flash_backward_plain(*args, gd, out, lse, causal)):
        assert bool(torch.isfinite(g).all())
        scale = ref.abs().max().clamp_min(1.0)
        assert float((g - ref).abs().max()) <= 1e-5 * float(scale)
    dq, dk, dv = got
    assert not dq[2].any() and not dk[2].any() and not dv[2].any()
    assert not dk[1, : t // 3].any() and not dv[1, : t // 3].any()
    if causal:
        assert not dq[1, : t // 3].any()
