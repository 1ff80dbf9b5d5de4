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
# the kernels of the persistent walk (csrc/attention_pipelined.cu, and in
# bf16 csrc/attention_ws.cu for mha_packed's function on the same memory),
# and with mha_fused every kernel of those sources
WS = ("mha_packed", "mha_packed_lse", "mha", "mha_pairs", "mha_qblock")
PERSISTENT = ("mha_batched_heads", *WS)
PIPELINED = (*PERSISTENT, "mha_fused")
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


def _walk(geo, B, S, NH):
    """(b, h, first query row) of every work item of the persistent walk
    (`mha_batched_heads` and the kinds of `WS`), CTA by CTA, as
    the kernels of csrc/attention_pipelined.cu and csrc/attention_ws.cu walk
    them: CTA x takes items i = x + j * gridDim.x, numbered batch-major,
    then head, then query block."""
    nqb = A.cdiv(S, geo.rows)
    items = B * NH * nqb
    return [[(i // (NH * nqb), i // nqb % NH, i % nqb * geo.rows)
             for i in range(x, items, geo.grid[0])]
            for x in range(geo.grid[0])]


def _tile_starts(kind, geo, B, S, NH):
    """The first query row of every tile the kernel computes, as the
    persistent walks and mha_fused's grid give them."""
    if kind in PERSISTENT:
        return sorted({s0 for cta in _walk(geo, B, S, NH)
                       for _, _, s0 in cta})
    return [x * geo.rows for x in range(geo.grid[0])]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("S,bq", QBLOCK_CASES)
@pytest.mark.parametrize("kind", ("mha_packed", "mha_packed_lse") + ENTRIES)
def test_launch_geometry_covers_every_query_row(kind, S, bq, itemsize):
    B, NH, D = 2, 4, 32
    geo = A.launch_geometry(kind, B, S, NH, D, itemsize, block_q=bq)
    # two threads per query row and head; bf16 mha_fused takes a head pair;
    # the bf16 kinds of the warp-specialised walk add a producer warpgroup
    # to their consumers
    pair = 2 if (kind, itemsize) == ("mha_fused", 2) else 1
    producer = 128 if (kind in WS and itemsize == 2) else 0
    assert geo.rows % 16 == 0
    assert geo.threads == 2 * geo.rows * pair + producer
    starts = list(_tile_starts(kind, geo, B, S, NH))
    covered = set()
    for s0 in starts:
        covered.update(range(s0, min(s0 + geo.rows, S)))
    assert covered == set(range(S))
    assert max(starts) < S  # no block is launched past the last row
    # the other grid axes: one block per (batch, head) or per batch element;
    # the persistent grid is capped at sms x ctas_per_sm
    heads = B if kind == "mha_fused" else B * NH
    blocks = len(starts) * heads
    if kind in PERSISTENT:
        blocks = min(blocks, A.H100_SMS * geo.ctas_per_sm)
    assert np.prod(geo.grid) == blocks


@pytest.mark.parametrize("S", [1, 64, 146, 1214])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("kind", PERSISTENT)
def test_persistent_walk_covers_every_item_once(kind, B, sms, S):
    NH = 12
    geo = A.launch_geometry(kind, B, S, NH, 64, 2, sms=sms)
    walk = _walk(geo, B, S, NH)
    seen = [it for cta in walk for it in cta]
    # 128-row items, or 64 rows per consumer warpgroup of the
    # warp-specialised bf16 packed kinds
    rows = 64 * A.ws_tile()[1] if kind in WS else 128
    assert geo.rows == rows
    want = {(b, h, q0) for b in range(B) for h in range(NH)
            for q0 in range(0, S, rows)}
    assert len(seen) == len(set(seen)) and set(seen) == want
    # every CTA has work, and as many run as fit: sms x ctas_per_sm (2, or 1
    # for the warp-specialised bf16 packed kinds), or one per item
    ctas = 1 if kind in WS else 2
    assert geo.ctas_per_sm == ctas
    assert all(walk) and geo.grid[0] == min(len(want), ctas * sms)
    # the CTAs that run at one time work on neighbouring batch elements
    first_wave = [cta[0][0] for cta in walk]
    assert max(first_wave) - min(first_wave) <= -(-ctas * sms
                                                   // (NH * A.cdiv(S, rows)))


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("kind", PIPELINED)
def test_pipelined_shared_memory_fits_its_ctas_per_sm(kind, itemsize, D):
    """An SM has 228 KB of shared memory, of which each CTA also takes 1 KB
    the system reserves, 65536 registers and 2048 threads: ctas_per_sm CTAs
    fit with 128 registers a thread (the kernels' launch bounds) and at most
    113 KB of shared memory each; the bf16 packed kinds' one CTA of a
    producer and the consumer warpgroups with all 65536 (setmaxnreg then
    moves them to the consumers) and up to 227 KB."""
    geo = A.launch_geometry(kind, 128, 1214, 12, D, itemsize)
    assert geo.ctas_per_sm * (geo.smem + 1024) <= 228 * 1024
    assert geo.threads * geo.ctas_per_sm <= 2048
    if kind in WS and itemsize == 2:
        # a ring of `stages` stages of K and V tiles, then 2 mbarriers a stage
        keys, consumers, stages = A.ws_tile()
        assert geo.ctas_per_sm == 1 and geo.threads == 128 * (consumers + 1)
        assert geo.smem == 1024 + stages * 2 * keys * D * 2 + 2 * stages * 8
        assert geo.smem <= A.MAX_SHARED_BYTES
        # the launch bounds' registers, a multiple of 8 (setmaxnreg's unit)
        assert 65536 // geo.threads % 8 == 0
        return
    assert geo.smem <= 113 * 1024
    assert 65536 // (geo.threads * geo.ctas_per_sm) == 128
    assert geo.ctas_per_sm >= 2
    if itemsize == 2:  # the ring: 3 stages of K and V, one head or a pair
        heads = 2 if kind == "mha_fused" else 1
        assert geo.smem == 3 * 2 * heads * 64 * D * 2 + 1024


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("kind", WS)
def test_packed_kinds_take_the_persistent_walk(kind, itemsize, D, sms):
    """mha_packed, its lse forward, mha, mha_pairs and mha_qblock walk
    mha_batched_heads' items: in f32 with its geometry (grid, threads,
    rows, tiles, CTAs per SM), in bf16 with one CTA of a producer and the
    consumer warpgroups per SM (csrc/attention_ws.cu); the same for every
    block_q."""
    walk = A.launch_geometry("mha_batched_heads", 128, 1214, 12, D,
                             itemsize, sms=sms)
    for bq in (1, 256):
        geo = A.launch_geometry(kind, 128, 1214, 12, D, itemsize,
                                block_q=bq, sms=sms)
        if itemsize == 4:
            assert geo == walk
        else:
            consumers = A.ws_tile()[1]
            assert geo.rows == 64 * consumers
            assert geo.grid == (sms, 1, 1) and geo.ctas_per_sm == 1
            assert geo.threads == 128 * (consumers + 1)


@pytest.mark.parametrize("bq", [1, 64, 65, 96, 128, 256, 10**6])
def test_qblock_takes_the_packed_geometry(bq):
    """mha_qblock launches mha_packed's instances on the same memory: its
    geometry is mha_packed's for every block_q, in both dtypes and at both
    head widths (the JAX grid of block_q-row query blocks is not carried
    over); mha_fused's rows are 64 for every block_q."""
    for itemsize in (2, 4):
        for S, D in ((1214, 64), (300, 32)):
            geo = A.launch_geometry("mha_qblock", 3, S, 12, D, itemsize,
                                    block_q=bq)
            assert geo == A.launch_geometry("mha_packed", 3, S, 12, D,
                                            itemsize)
    fused = A.launch_geometry("mha_fused", 1, 1214, 12, 64, 2, block_q=bq)
    assert fused.rows == 64


def test_ws_tile_is_read_from_the_source():
    """The warp-specialised walk's tile shape is written once, in
    csrc/attention_ws.cu; launch_geometry reads it from there."""
    from zenker_audio_detection_tpu_torch.ops import _cuda

    text = (_cuda.CSRC / "attention_ws.cu").read_text()
    keys, consumers, stages = A.ws_tile()
    assert (keys, consumers, stages) == A.parse_ws_tile(text)
    assert keys in (64, 128) and consumers >= 1 and stages >= 2
    geo = A.launch_geometry("mha_packed", 16, 1214, 12, 64, 2)
    assert (geo.rows, geo.threads) == (64 * consumers, 128 * (consumers + 1))


@pytest.mark.parametrize("tile", [(128, 2, 2), (64, 3, 4), (64, 2, 3)])
def test_launch_geometry_takes_a_variant_tile(tile):
    """A variant of csrc/attention_ws.cu (tools/packed_ws.py) gets its own
    geometry: rows, threads, the ring and its mbarriers."""
    keys, consumers, stages = tile
    geo = A.launch_geometry("mha_packed_lse", 3, 300, 12, 32, 2, sms=7,
                            tile=tile)
    assert geo.rows == 64 * consumers
    assert geo.threads == 128 * (consumers + 1) and geo.ctas_per_sm == 1
    assert geo.smem == 1024 + stages * 2 * keys * 32 * 2 + 2 * stages * 8
    assert geo.grid == (7, 1, 1)
    # the f32 walk does not depend on it
    assert (A.launch_geometry("mha_packed", 3, 300, 12, 32, 4, tile=tile)
            == A.launch_geometry("mha_packed", 3, 300, 12, 32, 4))


@pytest.mark.parametrize("text", ["", "constexpr int kKeys = 64;\n",
                                  "constexpr int kKeys = 64;\n"
                                  "constexpr int kConsumers = 2;\n"
                                  "// constexpr int kStages = 2;\n"])
def test_parse_ws_tile_needs_all_three_constexprs(text):
    with pytest.raises(ValueError, match="constexprs"):
        A.parse_ws_tile(text)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_fused_staging_fits_the_ast_width(itemsize):
    geo = A.launch_geometry("mha_fused", 128, 1214, 12, 64, itemsize)
    assert geo.grid == (19, 128, 1)
    assert geo.smem <= A.MAX_SHARED_BYTES
    # no (rows, NH * D) output tile is staged: the shared memory does not
    # grow with the heads, so 28 heads (NH * D = 1792) fit too
    wide = A.launch_geometry("mha_fused", 128, 1214, 28, 64, itemsize)
    assert wide.smem == geo.smem and wide.grid == geo.grid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_fused_matches_jax_at_1792_lanes(dtype):
    """NH * D = 1792, which the JAX mha_fused computes and a kernel staging
    a (64, NH * D) output tile could not hold in shared memory; the port's
    CPU path against the Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    B, S, NH, D = 1, 70, 28, 64
    qkv = _inputs(1792, (B, S, NH, D))
    want = np.asarray(JA.mha_fused(*(jnp.asarray(x, dtype) for x in qkv),
                                   interpret=True)).astype(np.float32)
    got = A.mha_fused(*(torch.from_numpy(x).to(getattr(torch, dtype))
                        for x in qkv))
    assert got.shape == (B, S, NH, D)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


@pytest.mark.parametrize("kind,args,match", [
    ("mha_fused", (70000, 64, 28, 64, 2), "grid"),        # B > 65535
    ("mha_fused", (1, 64, 16, 48, 4), "head width"),      # D = 48
    ("mha_batched_heads", (1, 64, 2, 32, 2, 256, 0), "sms"),
    ("mha_batched_heads", (1, 64, 2, 128, 2), "head width"),
    ("mha_qblock", (2**25, 1214, 16, 32, 2), "32-bit"),
    ("mha_packed_bwd_dq", (70000, 64, 1, 32, 2), "grid"), # B > 65535
    # 2^25 x 16 heads x at least 7 row blocks (of 192 rows or fewer): past
    # a 32-bit item count
    ("mha_packed", (2**25, 1214, 16, 32, 2), "32-bit"),
    ("mha_packed_lse", (2**25, 1214, 16, 32, 2), "32-bit"),
    ("mha_triples", (1, 64, 3, 32, 2), "no attention kernel"),
])
def test_launch_geometry_refuses(kind, args, match):
    with pytest.raises(ValueError, match=match):
        A.launch_geometry(kind, *args)


def test_pipelined_occupancy_names_a_pipelined_kernel():
    with pytest.raises(ValueError, match="no pipelined"):
        A.pipelined_occupancy("mha_packed_bwd_dq", 2, 64)


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
