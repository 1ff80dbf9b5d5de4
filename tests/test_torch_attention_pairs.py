"""The port's `mha_pairs` and `mha_packed_trainable` (their plain versions,
on the CPU) against the JAX package's Pallas `mha_pairs` and custom-VJP
`mha_packed_trainable` in interpret mode, on the same seeded inputs.

Tolerances: `mha_pairs` f32 atol 2e-5, as tests/test_pallas_attention_packed
.py holds the Pallas kernel to the XLA reference; bf16 atol 2e-2 (both sides
round p and the O(1) outputs to bf16, 2^-8 relative). `mha_packed_trainable`
as tests/test_pallas_vjp.py holds the JAX one: loss within 1e-3, gradients
atol 2e-4, rtol 1e-3.

Also the launch geometry of `mha_pairs` (and `mha`: both are `mha_packed`'s
walk on the same memory) and what its wrapper refuses, checked without a
card."""

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.ops import attention as JA
from zenker_audio_detection_tpu_torch.ops import attention as A

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX custom VJP's forward in interpret mode, as
    tests/test_pallas_vjp.py runs it on the CPU."""
    orig = JA.mha_packed
    monkeypatch.setattr(JA, "mha_packed", lambda q, k, v, **kw: orig(
        q, k, v, **{**kw, "interpret": True}))


# tests/test_pallas_attention_packed.py:23-50, and the AST's heads at its
# short-sequence length
@pytest.mark.parametrize("B,S,NH,D,bq,dtype", [
    (2, 64, 4, 32, 64, "float32"),
    (2, 300, 4, 32, 128, "float32"),
    (1, 64, 3, 32, 64, "float32"),        # odd heads: mha_packed
    (1, 146, 12, 64, 128, "bfloat16"),
])
def test_mha_pairs_matches_jax(B, S, NH, D, bq, dtype):
    import jax.numpy as jnp

    qkv = _inputs(S * 3 + NH, (B, S, NH * D))
    want = np.asarray(JA.mha_pairs(
        *(jnp.asarray(x, dtype) for x in qkv), num_heads=NH, block_q=bq,
        interpret=True)).astype(np.float32)
    tdtype = getattr(torch, dtype)
    before = (A.mha_pairs.launches, A.mha_packed.launches)
    got = A.mha_pairs(*(torch.from_numpy(x).to(tdtype) for x in qkv),
                      num_heads=NH, block_q=bq)
    assert (A.mha_pairs.launches, A.mha_packed.launches) == before
    assert got.dtype == tdtype and got.shape == (B, S, NH * D)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


@pytest.mark.parametrize("bq", [1, 64, 128, 256, 10**6])
def test_mha_pairs_block_q_does_not_change_the_output(bq):
    qkv = [torch.from_numpy(x) for x in _inputs(5, (1, 70, 128))]
    torch.testing.assert_close(A.mha_pairs(*qkv, num_heads=4, block_q=bq),
                               A.mha_packed_reference(*qkv, 4),
                               atol=0, rtol=0)


@pytest.mark.parametrize("NH,calls", [(3, 1), (1, 1), (4, 0), (12, 0)])
def test_mha_pairs_odd_heads_call_mha_packed(monkeypatch, NH, calls):
    """An odd head count is `mha_packed` with the same block_q, as the JAX
    function is; an even one never reaches it."""
    seen = []
    orig = A.mha_packed

    def spy(q, k, v, *, num_heads, block_q=256):
        seen.append((num_heads, block_q))
        return orig(q, k, v, num_heads=num_heads, block_q=block_q)

    monkeypatch.setattr(A, "mha_packed", spy)
    qkv = [torch.from_numpy(x) for x in _inputs(NH, (1, 40, NH * 32))]
    got = A.mha_pairs(*qkv, num_heads=NH, block_q=96)
    assert seen == [(NH, 96)] * calls
    torch.testing.assert_close(got, A.mha_packed_reference(*qkv, NH),
                               atol=0, rtol=0)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("kind", ["mha_pairs", "mha"])
def test_pairs_and_mha_take_the_packed_geometry(kind, itemsize, D, sms):
    """`mha_pairs` and `mha` launch `mha_packed`'s kernel on the same memory,
    so their launch is `mha_packed`'s for every (B, S, NH, D), dtype and SM
    count: the persistent walk (bf16 csrc/attention_ws.cu, f32
    csrc/attention_pipelined.cu), no head-pair or per-head grid."""
    for B, S, NH in ((128, 1214, 12), (1, 146, 2), (3, 300, 28)):
        geo = A.launch_geometry(kind, B, S, NH, D, itemsize, sms=sms)
        assert geo == A.launch_geometry("mha_packed", B, S, NH, D, itemsize,
                                        sms=sms)
        assert geo.grid[1:] == (1, 1) and geo.grid[0] <= sms * geo.ctas_per_sm
    assert A.kernel_of(kind, itemsize) == A.kernel_of("mha_packed", itemsize)


@pytest.mark.parametrize("S", [64, 300, 146, 1214])
def test_pairs_geometry_covers_every_query_row(S):
    """Every (batch, head, row block) item of the walk is taken once, by CTA
    x = i mod gridDim.x, and the blocks cover every query row of every
    head."""
    B, NH, D = 3, 12, 64
    geo = A.launch_geometry("mha_pairs", B, S, NH, D, 2, sms=7)
    nqb = A.cdiv(S, geo.rows)
    items = [(i // (NH * nqb), i // nqb % NH, i % nqb * geo.rows)
             for x in range(geo.grid[0])
             for i in range(x, B * NH * nqb, geo.grid[0])]
    assert len(items) == len(set(items)) == B * NH * nqb
    rows = {(b, h, r) for b, h, q0 in items
            for r in range(q0, min(q0 + geo.rows, S))}
    assert rows == {(b, h, r) for b in range(B) for h in range(NH)
                    for r in range(S)}
    assert max(q0 for _, _, q0 in items) < S


@pytest.mark.parametrize("args,match", [
    ((2**25, 1214, 16, 32, 2), "32-bit"),  # past a 32-bit item count
    ((1, 64, 3, 32, 2), "even"),          # odd heads go to mha_packed
    ((1, 64, 1, 64, 4), "even"),
])
def test_pairs_geometry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        A.launch_geometry("mha_pairs", *args)


def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("args,kw,err", [
    ((_t(2, 8), _t(2, 8), _t(2, 8)), {"num_heads": 2}, ValueError),
    ((_t(1, 8, 64), _t(1, 9, 64), _t(1, 8, 64)), {"num_heads": 2}, ValueError),
    ((_t(1, 8, 64),) * 3, {"num_heads": 3}, ValueError),
    ((_t(1, 8, 64),) * 3, {"num_heads": 0}, ValueError),
    ((_t(1, 0, 64),) * 3, {"num_heads": 2}, ValueError),
    ((_t(1, 8, 64, dtype=torch.float16),) * 3, {"num_heads": 2}, TypeError),
    ((_t(1, 8, 64), _t(1, 8, 64, dtype=torch.bfloat16), _t(1, 8, 64)),
     {"num_heads": 2}, TypeError),
    ((_t(1, 8, 64),) * 3, {"num_heads": 2, "block_q": 0}, ValueError),
    ((_t(1, 8, 64, device="meta"),) * 3, {"num_heads": 2}, ValueError),
])
def test_mha_pairs_rejects_bad_inputs(args, kw, err):
    with pytest.raises(err):
        A.mha_pairs(*args, **kw)


def test_mha_packed_trainable_matches_jax(pallas_interpret):
    """tests/test_pallas_vjp.py:9-41 on both sides: loss sum(out * t)."""
    import jax
    import jax.numpy as jnp

    B, S, NH, D = 2, 70, 4, 16
    q, k, v, t = _inputs(11, (B, S, NH * D), n=4)

    def jax_loss(q, k, v):
        return jnp.sum(JA.mha_packed_trainable(q, k, v, NH) * t)

    want, want_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = (A.mha_packed_trainable(*xs, NH) * torch.from_numpy(t)).sum()
    got.backward()
    assert abs(float(got.detach()) - float(want)) < 1e-3
    for x, w in zip(xs, want_g):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-3)


# bf16: the two backwards round at different places (autograd through the
# plain forward passes bf16 gradients between the casts; the JAX-form
# backward rounds p_b and ds once each). On these inputs the O(1.5)
# gradients differed by at most 0.0078, two bf16 ulps; the bound is the
# port's usual bf16 2e-2. f32: the backward takes p from the row
# log-sum-exp and sum_j p dp from the output, autograd from the softmax;
# the same sums in another order, equal here to 1e-6.
GRAD_TOL = {"float32": (1e-6, 0.0), "bfloat16": (2e-2, 0.0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,NH,D", [(2, 70, 4, 16), (1, 146, 12, 64)])
def test_mha_packed_trainable_matches_autograd(dtype, B, S, NH, D):
    """The hand-written backward against autograd through the plain
    forward, on the same inputs."""
    tdtype = getattr(torch, dtype)
    q, k, v, t = (torch.from_numpy(x).to(tdtype)
                  for x in _inputs(B + S, (B, S, NH * D), n=4))

    def grads(fn):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*xs)
        (out.float() * t.float()).sum().backward()
        return out.detach(), [x.grad for x in xs]

    out, got = grads(lambda q, k, v: A.mha_packed_trainable(q, k, v, NH))
    ref, want = grads(lambda q, k, v: A.mha_packed_reference(q, k, v, NH))
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    atol, rtol = GRAD_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == tdtype and g.shape == q.shape
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)


def test_mha_packed_trainable_keeps_no_score_residuals():
    """q, k, v, the output and the (B, NH, S) row log-sum-exp are saved
    for the backward, nothing of (S, S) size; p is recomputed."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(3, (1, 40, 64)))
    out = A.mha_packed_trainable(q, k, v, 2)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    assert [tuple(s.shape) for s in saved] == [tuple(q.shape)] * 4 + [
        (1, 2, 40)]
    assert all(s.numel() < 40 * 40 * 2 for s in saved[4:])
    torch.testing.assert_close(saved[3], out.detach(), atol=0, rtol=0)
