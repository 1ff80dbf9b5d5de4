"""The port's four (B, S, NH, D) attention entry points (`mha`,
`mha_batched_heads`, `mha_qblock`, `mha_fused`; their plain version on the
CPU) against the JAX package's Pallas kernels in interpret mode, on the
same seeded inputs and on every shape of tests/test_pallas_attention.py.

Tolerances: f32 atol 2e-5, as tests/test_pallas_attention.py holds the
Pallas kernels to the XLA reference (the two sum in different orders); bf16
atol 2e-2: both sides round p and the output to bf16 (2^-8 relative), and
at these input scales the outputs are O(1).

Also the launch geometry the kernels are given, and what the wrappers
refuse, checked without a card."""

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.ops import attention as JA
from zenker_audio_detection_tpu_torch.ops import attention as A

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ENTRIES = ("mha", "mha_batched_heads", "mha_qblock", "mha_fused")
BLOCKED = ("mha_qblock", "mha_fused")
# (S, block_q) of tests/test_pallas_attention.py:74-80; (1280, 96) and
# (200, 96) are where a floor-divided grid once skipped the last rows
QBLOCK_CASES = [(64, 64), (300, 128), (100, 256), (1280, 96), (200, 96)]

PARITY_CASES = (
    [("mha", 2, s, 4, 32, "float32", None) for s in (64, 100, 128)]
    + [("mha", 1, 70, 2, 64, "bfloat16", None)]
    + [("mha_batched_heads", 2, s, 4, 32, "float32", None) for s in (64, 100)]
    + [(name, 2, s, 4, 32, "float32", bq)
       for name in BLOCKED for s, bq in QBLOCK_CASES]
    # the AST's heads at its short-sequence length
    + [(name, 1, 146, 12, 64, "bfloat16", None) for name in ENTRIES])


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("name,B,S,NH,D,dtype,bq", PARITY_CASES)
def test_entry_point_matches_jax(name, B, S, NH, D, dtype, bq):
    import jax.numpy as jnp

    qkv = _inputs(S * 7 + NH, (B, S, NH, D))
    kw = {} if bq is None else {"block_q": bq}
    want = np.asarray(getattr(JA, name)(
        *(jnp.asarray(x, dtype) for x in qkv), interpret=True, **kw)
    ).astype(np.float32)
    tdtype = getattr(torch, dtype)
    fn = getattr(A, name)
    before = fn.launches
    got = fn(*(torch.from_numpy(x).to(tdtype) for x in qkv), **kw)
    assert fn.launches == before  # CPU tensors run the plain version
    assert got.dtype == tdtype and got.shape == (B, S, NH, D)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,NH,D", [(2, 100, 4, 32), (1, 146, 12, 64)])
def test_reference_mha_matches_jax(dtype, B, S, NH, D):
    import jax.numpy as jnp

    qkv = _inputs(S + D, (B, S, NH, D))
    want = np.asarray(JA.reference_mha(
        *(jnp.asarray(x, dtype) for x in qkv))).astype(np.float32)
    got = A.reference_mha(*(torch.from_numpy(x).to(getattr(torch, dtype))
                            for x in qkv))
    assert got.shape == (B, S, NH, D)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


def _tile_starts(kind, geo, S):
    """The first query row of every tile the kernel computes, as
    csrc/attention.cu:attn_kernel walks them."""
    if kind in ("mha", "mha_batched_heads"):
        return range(0, S, geo.rows)  # each block loops over its tiles
    return [x * geo.rows for x in range(geo.grid[0])]


@pytest.mark.parametrize("S,bq", QBLOCK_CASES)
@pytest.mark.parametrize("kind", ("mha_packed",) + ENTRIES)
def test_launch_geometry_covers_every_query_row(kind, S, bq):
    B, NH, D = 2, 4, 32
    geo = A.launch_geometry(kind, B, S, NH, D, 4, block_q=bq)
    assert geo.rows % 16 == 0 and geo.threads == 2 * geo.rows
    starts = list(_tile_starts(kind, geo, S))
    covered = set()
    for s0 in starts:
        covered.update(range(s0, min(s0 + geo.rows, S)))
    assert covered == set(range(S))
    assert max(starts) < S  # no block is launched past the last row
    # the other grid axes: one block per (batch, head) or per batch element
    heads = {"mha_packed": B * NH, "mha": B * NH, "mha_batched_heads": B,
             "mha_qblock": B * NH, "mha_fused": B}[kind]
    q_blocks = 1 if kind in ("mha", "mha_batched_heads") else len(starts)
    assert np.prod(geo.grid) == q_blocks * heads


@pytest.mark.parametrize("bq,rows", [(1, 64), (64, 64), (65, 128), (96, 128),
                                     (128, 128), (256, 128), (10**6, 128)])
def test_qblock_rows(bq, rows):
    assert A.qblock_rows(bq) == rows
    fused = A.launch_geometry("mha_fused", 1, 1214, 12, 64, 2, block_q=bq)
    assert fused.rows == 64


@pytest.mark.parametrize("itemsize", [2, 4])
def test_fused_staging_fits_the_ast_width(itemsize):
    geo = A.launch_geometry("mha_fused", 128, 1214, 12, 64, itemsize)
    assert geo.grid == (19, 128, 1)
    assert geo.smem + A._static_smem(64, itemsize) <= A.MAX_SHARED_BYTES


@pytest.mark.parametrize("kind,args,match", [
    ("mha_fused", (1, 64, 16, 64, 4), "shared memory"),   # f32, H = 1024
    ("mha_fused", (1, 64, 28, 64, 2), "shared memory"),   # bf16, H = 1792
    ("mha_qblock", (1, 64, 70000, 32, 2), "grid"),        # B * NH > 65535
    ("mha_packed", (70000, 64, 1, 32, 2), "grid"),        # B > 65535
    ("mha_triples", (1, 64, 3, 32, 2), "no attention kernel"),
])
def test_launch_geometry_refuses(kind, args, match):
    with pytest.raises(ValueError, match=match):
        A.launch_geometry(kind, *args)


def test_launch_geometry_refuses_block_q_below_one():
    with pytest.raises(ValueError, match="block_q"):
        A.launch_geometry("mha_qblock", 1, 64, 2, 32, 2, block_q=0)


@pytest.mark.parametrize("D,ok", [(16, False), (32, True), (48, False),
                                  (64, True), (128, False)])
def test_kernel_checks_head_width_4d(D, ok):
    q = torch.zeros(1, 8, 2, D)
    if ok:
        A._check_kernel(q, q, q, num_heads=2)
    else:
        with pytest.raises(ValueError, match="head widths"):
            A._check_kernel(q, q, q, num_heads=2)


def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


BAD_INPUTS = [
    ((_t(1, 8, 64),) * 3, ValueError),                            # not 4-D
    ((_t(1, 8, 2, 32, 1),) * 3, ValueError),                      # 5-D
    ((_t(1, 8, 2, 32), _t(1, 9, 2, 32), _t(1, 8, 2, 32)), ValueError),
    ((_t(1, 8, 2, 32), _t(1, 8, 2, 32), _t(1, 8, 4, 32)), ValueError),
    ((_t(1, 0, 2, 32),) * 3, ValueError),                         # no token
    ((_t(1, 8, 2, 32, dtype=torch.float16),) * 3, TypeError),
    ((_t(1, 8, 2, 32, dtype=torch.float64),) * 3, TypeError),
    ((_t(1, 8, 2, 32, dtype=torch.int32),) * 3, TypeError),
    ((_t(1, 8, 2, 32), _t(1, 8, 2, 32, dtype=torch.bfloat16),
      _t(1, 8, 2, 32)), TypeError),
    ((_t(1, 8, 2, 32, device="meta"),) * 3, ValueError),          # device
]


@pytest.mark.parametrize("args,err", BAD_INPUTS)
@pytest.mark.parametrize("name", ENTRIES)
def test_entry_point_rejects_bad_inputs(name, args, err):
    with pytest.raises(err):
        getattr(A, name)(*args)


@pytest.mark.parametrize("bq", [0, -64])
@pytest.mark.parametrize("name", BLOCKED)
def test_blocked_entry_points_reject_block_q_below_one(name, bq):
    q = _t(1, 8, 2, 32)
    with pytest.raises(ValueError, match="block_q"):
        getattr(A, name)(q, q, q, block_q=bq)


def test_meta_device_names_the_devices():
    q = _t(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        A.mha(q, q, q)
