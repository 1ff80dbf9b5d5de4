"""The plain versions of `mha_packed_trainable`'s kernels, on the CPU:
`mha_packed_lse` (the forward that keeps each row's log-sum-exp) and the
flash backward `mha_packed_bwd_dq` / `mha_packed_bwd_dkdv`, against the JAX
custom VJP `mha_packed_trainable` (its forward in interpret mode) and the
port's JAX-form plain backward `_mha_packed_bwd`, on the same seeded inputs.

Tolerances: f32 atol 2e-4, rtol 1e-3, as tests/test_pallas_vjp.py:41 holds
the JAX gradients; bf16 atol 2e-2, rtol 0 (the two backwards round p and ds
to bf16 at the same places but from p's computed differently, exp2 from
the lse here and a softmax there, and delta comes from the bf16 output o
here, so they agree to a few bf16 ulps of the O(1) gradients).

Also the launch geometry of the three kernels, the no-grad forward, and
what the wrappers refuse, checked without a card."""

import math

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.ops import attention as JA
from zenker_audio_detection_tpu_torch.ops import attention as A

from test_torch_attention_pairs import _inputs, pallas_interpret  # noqa: F401
from test_torch_attention_variants import _walk

GRAD_TOL = {"float32": (2e-4, 1e-3), "bfloat16": (2e-2, 0.0)}
SHAPES = [(2, 70, 4, 16), (2, 300, 4, 32), (1, 146, 12, 64)]
KINDS = ("mha_packed_lse", "mha_packed_bwd_dq", "mha_packed_bwd_dkdv")


def _qkvg(seed, B, S, NH, D, dtype):
    tdtype = getattr(torch, dtype)
    return [torch.from_numpy(x).to(tdtype)
            for x in _inputs(seed, (B, S, NH * D), n=4)]


def _port_grads(q, k, v, g, NH):
    o, lse = A.mha_packed_lse_reference(q, k, v, NH)
    return A.mha_packed_bwd_reference(q, k, v, o, lse, g, NH)


def _assert_grads(got, want, dtype):
    atol, rtol = GRAD_TOL[dtype]
    for a, w in zip(got, want):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,NH,D", SHAPES)
def test_bwd_reference_matches_jax_vjp(pallas_interpret, dtype, B, S, NH, D):
    import jax
    import jax.numpy as jnp

    q, k, v, g = _qkvg(B + S + D, B, S, NH, D, dtype)
    jx = [jnp.asarray(x.float().numpy(), dtype) for x in (q, k, v, g)]
    _, vjp = jax.vjp(lambda q, k, v: JA.mha_packed_trainable(q, k, v, NH),
                     *jx[:3])
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jx[3])]
    _assert_grads(_port_grads(q, k, v, g, NH), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,NH,D", SHAPES)
def test_bwd_reference_matches_jax_form_plain(dtype, B, S, NH, D):
    q, k, v, g = _qkvg(2 * S + NH, B, S, NH, D, dtype)
    want = [w.float().numpy() for w in A._mha_packed_bwd(q, k, v, g, NH)]
    _assert_grads(_port_grads(q, k, v, g, NH), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,NH,D", SHAPES)
def test_lse_reference(dtype, B, S, NH, D):
    """o is `mha_packed_reference`'s output bit for bit; lse is the natural
    log-sum-exp of the scaled f32 scores times log2(e), to 1e-5 (f32 sums
    of S exponentials in two orders, values near 5)."""
    q, k, v, _ = _qkvg(S + 7, B, S, NH, D, dtype)
    o, lse = A.mha_packed_lse_reference(q, k, v, NH)
    torch.testing.assert_close(o, A.mha_packed_reference(q, k, v, NH),
                               atol=0, rtol=0)
    heads = [x.float().reshape(B, S, NH, D).transpose(1, 2) for x in (q, k)]
    scores = heads[0] @ heads[1].transpose(-1, -2) / math.sqrt(D)
    want = torch.logsumexp(scores, dim=-1) * math.log2(math.e)
    assert lse.dtype == torch.float32 and lse.shape == (B, NH, S)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=0)


def test_bwd_parts_compose():
    """`mha_packed_bwd_reference` is the dq part then the dk/dv part, and
    delta is sum_d g o per row and head."""
    q, k, v, g = _qkvg(3, 1, 50, 2, 32, "float32")
    o, lse = A.mha_packed_lse_reference(q, k, v, 2)
    dq, delta = A.mha_packed_bwd_dq_reference(q, k, v, o, lse, g, 2)
    dk, dv = A.mha_packed_bwd_dkdv_reference(q, k, v, g, lse, delta, 2)
    want = (g.reshape(1, 50, 2, 32) * o.reshape(1, 50, 2, 32)).sum(-1)
    torch.testing.assert_close(delta, want.transpose(1, 2), atol=1e-6,
                               rtol=0)
    for a, b in zip((dq, dk, dv),
                    A.mha_packed_bwd_reference(q, k, v, o, lse, g, 2)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_cpu_wrappers_take_the_plain_versions():
    q, k, v, g = _qkvg(4, 2, 70, 2, 64, "float32")
    before = {kind: getattr(A, kind).launches for kind in KINDS}
    o, lse = A.mha_packed_lse(q, k, v, num_heads=2)
    dq, delta = A.mha_packed_bwd_dq(q, k, v, o, lse, g, num_heads=2)
    dk, dv = A.mha_packed_bwd_dkdv(q, k, v, g, lse, delta, num_heads=2)
    assert {kind: getattr(A, kind).launches for kind in KINDS} == before
    want_o, want_lse = A.mha_packed_lse_reference(q, k, v, 2)
    torch.testing.assert_close(o, want_o, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    for a, b in zip((dq, dk, dv),
                    A.mha_packed_bwd(q, k, v, o, lse, g, num_heads=2)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 146, 1214])
def test_lse_forward_walks_every_row_once(S):
    """The lse forward runs mha_packed's persistent walk: every (batch
    element, head, row block) item once, so each (batch, head, row) lse
    entry is written by exactly one warpgroup row."""
    B, NH, D = 3, 12, 64
    geo = A.launch_geometry("mha_packed_lse", B, S, NH, D, 2)
    consumers = A.ws_tile()[1]
    assert geo.rows == 64 * consumers and geo.ctas_per_sm == 1
    assert geo.threads == 128 * (consumers + 1)
    items = [it for cta in _walk(geo, B, S, NH) for it in cta]
    rows = [(b, h, r) for b, h, q0 in items
            for r in range(q0, min(q0 + geo.rows, S))]
    assert sorted(rows) == [(b, h, r) for b in range(B) for h in range(NH)
                            for r in range(S)]


@pytest.mark.parametrize("kind", ["mha_packed_bwd_dq", "mha_packed_bwd_dkdv"])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 146, 1214])
def test_bwd_geometry_covers_every_row(kind, S):
    """bf16: the persistent walk of csrc/attention_bwd.cu, one CTA per SM
    (at most one per item) of a producer and 64-row consumer warpgroups,
    whose items cover every (batch element, head, row) once, rows being
    query rows (bwd_dq) or keys (bwd_dkdv); its dynamic shared memory holds
    the aligned ring of (64, D) tile pairs (bwd_dkdv's stages also their 64
    lse and delta values) and two mbarriers a stage. f32: 64-row tiles, one
    4-warp block per (tile, head, batch element), static shared memory
    only."""
    B, NH, D = 3, 12, 64
    consumers, stages = A.bwd_tile(kind)
    geo = A.launch_geometry(kind, B, S, NH, D, 2, sms=132)
    assert geo.rows == 64 * consumers and geo.ctas_per_sm == 1
    assert geo.threads == 128 * (consumers + 1)
    stats = 2 * 64 * 4 if kind == "mha_packed_bwd_dkdv" else 0
    assert geo.smem == 1024 + stages * (2 * 64 * D * 2 + stats) + 16 * stages
    assert geo.smem <= A.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="no occupancy symbol"):
        A.occupancy(kind, 4, D)  # the f32 grid assumes no CTAs per SM
    items = B * NH * A.cdiv(S, geo.rows)
    assert geo.grid == (min(items, 132), 1, 1)
    rows = [(b, h, r) for cta in _walk(geo, B, S, NH) for b, h, r0 in cta
            for r in range(r0, min(r0 + geo.rows, S))]
    assert sorted(rows) == [(b, h, r) for b in range(B) for h in range(NH)
                            for r in range(S)]
    geo = A.launch_geometry(kind, B, S, NH, D, 4)
    assert geo.grid[1:] == (NH, B)
    assert geo.rows == 64 and geo.threads == 128 and geo.smem == 0
    covered = [r for x in range(geo.grid[0])
               for r in range(x * geo.rows, min((x + 1) * geo.rows, S))]
    assert covered == list(range(S))
    assert (geo.grid[0] - 1) * geo.rows < S


@pytest.mark.parametrize("context", ["no_grad", "inference_mode",
                                     "no_input_requires_grad"])
def test_forward_without_grad_calls_mha_packed(monkeypatch, context):
    """Without a gradient to take, `mha_packed_trainable` is `mha_packed`
    (the engine's path): the lse forward is not called and nothing is
    saved."""
    seen = []
    orig = A.mha_packed

    def spy(q, k, v, *, num_heads):
        seen.append(num_heads)
        return orig(q, k, v, num_heads=num_heads)

    def refuse(*args, **kw):
        raise AssertionError("mha_packed_lse called without a gradient")

    monkeypatch.setattr(A, "mha_packed", spy)
    monkeypatch.setattr(A, "mha_packed_lse", refuse)
    q, k, v, _ = _qkvg(5, 1, 40, 2, 32, "float32")
    if context != "no_input_requires_grad":
        q.requires_grad_()
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no_input_requires_grad": torch.enable_grad}[context]
    with ctx():
        out = A.mha_packed_trainable(q, k, v, 2)
    assert seen == [2] and out.grad_fn is None
    torch.testing.assert_close(out, A.mha_packed_reference(q, k, v, 2),
                               atol=0, rtol=0)


def test_forward_with_grad_calls_the_lse_forward(monkeypatch):
    seen = []
    orig = A.mha_packed_lse

    def spy(q, k, v, *, num_heads):
        seen.append(num_heads)
        return orig(q, k, v, num_heads=num_heads)

    def refuse(*args, **kw):
        raise AssertionError("mha_packed called with a gradient to take")

    monkeypatch.setattr(A, "mha_packed_lse", spy)
    monkeypatch.setattr(A, "mha_packed", refuse)
    q, k, v, g = _qkvg(6, 1, 40, 2, 32, "float32")
    k.requires_grad_()
    A.mha_packed_trainable(q, k, v, 2).backward(g)
    assert seen == [2] and k.grad is not None and q.grad is None


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("bad,err", [
    ({"q": _t(1, 8, 64, dtype=torch.float16)}, TypeError),
    ({"o": _t(1, 8, 64, dtype=torch.bfloat16)}, ValueError),
    ({"g": _t(1, 9, 64)}, ValueError),
    ({"lse": _t(1, 2, 8, dtype=torch.bfloat16)}, ValueError),
    ({"lse": _t(1, 8, 2)}, ValueError),
    ({"delta": _t(2, 2, 8)}, ValueError),
    ({"num_heads": 3}, ValueError),
])
def test_bwd_wrappers_refuse(bad, err):
    x = {"q": _t(1, 8, 64), "k": _t(1, 8, 64), "v": _t(1, 8, 64),
         "o": _t(1, 8, 64), "g": _t(1, 8, 64), "lse": _t(1, 2, 8),
         "delta": _t(1, 2, 8), "num_heads": 2, **bad}
    with pytest.raises(err):
        if "delta" in bad:
            A.mha_packed_bwd_dkdv(x["q"], x["k"], x["v"], x["g"], x["lse"],
                                  x["delta"], num_heads=x["num_heads"])
        else:
            A.mha_packed_bwd_dq(x["q"], x["k"], x["v"], x["o"], x["lse"],
                                x["g"], num_heads=x["num_heads"])


def test_lse_wrapper_refuses():
    with pytest.raises(TypeError):
        A.mha_packed_lse(*[_t(1, 8, 64, dtype=torch.float16)] * 3,
                         num_heads=2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        q = torch.zeros(1, 8, 64, device="meta")
        A.mha_packed_lse(q, q, q, num_heads=2)


def test_bwd_kernel_checks_head_width_and_layout():
    """What the backward kernels refuse on the card, checked without one:
    D outside KERNEL_HEAD_DIMS, non-contiguous operands, an activation not
    16-byte aligned."""
    q, lse = _t(1, 8, 192), _t(1, 4, 8)
    with pytest.raises(ValueError, match="head widths"):
        A._check_bwd_kernel(q, q, q, 4, {"o": q, "g": q}, {"lse": lse})
    q64 = _t(1, 8, 128)
    strided = torch.zeros(1, 128, 8).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        A._check_bwd_kernel(q64, q64, q64, 2, {"o": strided, "g": q64},
                            {"lse": _t(1, 2, 8)})
    with pytest.raises(ValueError, match="contiguous"):
        A._check_bwd_kernel(q64, q64, q64, 2, {"g": q64},
                            {"lse": _t(1, 8, 2).transpose(1, 2)})
    shifted = torch.zeros(1 + 8 * 128)[1:].view(1, 8, 128)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        A._check_bwd_kernel(q64, q64, q64, 2, {"g": shifted},
                            {"lse": _t(1, 2, 8)})
    A._check_bwd_kernel(q64, q64, q64, 2, {"o": q64, "g": q64},
                        {"lse": _t(1, 2, 8), "delta": _t(1, 2, 8)})


@pytest.mark.parametrize("ptr,shape,strides,match", [
    (8, (1, 8, 128), (1024, 128, 1), "16-byte aligned for TMA"),
    (0, (1, 8, 36), (288, 36, 1), "pitches that are multiples"),
    (0, (2, 8, 128), (1 << 39, 128, 1), "below 2"),
    (0, (1, (1 << 32) + 1, 64), (((1 << 32) + 1) * 64, 64, 1),
     "dimensions of at most"),
])
def test_bwd_kernel_refuses_what_tma_cannot_map(ptr, shape, strides, match):
    """The bf16 backward kernels read q, k, v and g through TMA tensor maps
    over (B, S, H): a base address off 16 bytes, a row or batch pitch that
    is not a multiple of 16 bytes or reaches 2^40 bytes, or a dimension
    beyond 2^32 raise before any launch; the tensors the kernels take
    pass."""
    with pytest.raises(ValueError, match=match):
        A._check_tma("k", ptr, shape, strides, 2)
    A._check_tma("k", 0, (16, 1214, 768), (1214 * 768, 768, 1), 2)
    x = torch.zeros(2, 70, 128, dtype=torch.bfloat16)
    A._check_bwd_kernel(x, x, x, 2, {"o": x, "g": x},
                        {"lse": _t(2, 2, 70)})
    shifted = torch.zeros(8 + 2 * 70 * 128, dtype=torch.bfloat16)[8:]
    shifted = shifted.view(2, 70, 128)  # 16 bytes on
    A._check_bwd_kernel(x, x, x, 2, {"g": shifted}, {"lse": _t(2, 2, 70)})
