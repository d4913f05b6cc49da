"""The port's flash attention against the JAX package's, on the CPU.

The reference runs its Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` does; the port runs the plain versions
that its CUDA kernels B4-B6 are held to. Tolerances are the reference
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
    """The autograd Function calls B4 forward and B5, B6 backward through
    the module's wrappers, with delta = rowsum(dO o O)."""
    calls = []
    for name in ("flash_forward", "flash_dq", "flash_dkv"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    q, k, v, mask = inputs(t=12, pads=(0, 2))
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = fa.flash_attention(*leaves, tm)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(g)
    assert calls == ["flash_forward", "flash_dq", "flash_dkv"]
    _, lse = fa.flash_forward_plain(tq, tk, tv, tm)
    delta = torch.einsum("bthd,bthd->bht", g, out.detach())
    torch.testing.assert_close(leaves[0].grad, fa.flash_dq_plain(tq, tk, tv, tm, g, lse, delta))


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


# --------------------------------------------------------------------------
# kernels B4-B6 against their plain versions (need a card)
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(64, 16), (1, 8), (65, 32), (200, 64), (1024, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain_on_card(t, d, causal):
    """B4, B5 and B6 against their plain versions on the card, with a
    fully-masked batch row and left padding; elementwise within 1e-5 of
    each output's scale (f32 sums of at most T terms in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v, mask = inputs(b=3, t=t, h=2, d=d, pads=(0, t // 3, t))
    do = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    (tq, tk, tv), tm = torch_args(q, k, v, mask)
    args = [x.cuda() for x in (tq, tk, tv)] + [tm.cuda()]
    gd = torch.from_numpy(do).cuda()
    before = (fa.flash_forward.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    out, lse = fa.flash_forward(*args, causal)
    p_out, p_lse = fa.flash_forward_plain(*args, causal)
    delta = torch.einsum("bthd,bthd->bht", gd, p_out)
    dq = fa.flash_dq(*args, gd, p_lse, delta, causal)
    dk, dv = fa.flash_dkv(*args, gd, p_lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_dq.launches, fa.flash_dkv.launches) == tuple(
        n + 1 for n in before)
    want = [p_out, p_lse, fa.flash_dq_plain(*args, gd, p_lse, delta, causal),
            *fa.flash_dkv_plain(*args, gd, p_lse, delta, causal)]
    for got, ref in zip((out, lse, dq, dk, dv), want):
        assert bool(torch.isfinite(got).all())
        scale = ref[ref > -1e29].abs().max().clamp_min(1.0)
        assert float((got - ref).abs().max()) <= 1e-5 * float(scale)
    assert not out[2].any() and not dq[2].any() and not dk[2].any() and not dv[2].any()
