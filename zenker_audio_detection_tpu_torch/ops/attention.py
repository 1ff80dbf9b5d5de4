"""Fused multi-head attention: softmax(q k^T / sqrt(D)) v per head.

The port of the JAX package's `ops/attention.py`. Six entry points compute
the same function with the work cut six ways, each the counterpart of one
Pallas kernel there:

- `mha_packed` and `mha_pairs` on packed (B, S, H = NH * D) projections
  (`_attn_kernel_packed`, `_attn_kernel_pairs`);
- `mha`, `mha_batched_heads`, `mha_qblock` and `mha_fused` on (B, S, NH, D)
  (`_attn_kernel`, `_attn_kernel_batched`, `_attn_kernel_qblock`,
  `_attn_kernel_fused`).

`mha_packed_trainable` is `mha_packed` under autograd, the counterpart of
the JAX custom VJP of that name: the forward is `mha_packed`, the backward
recomputes the probabilities in plain PyTorch, as the JAX backward does in
XLA.

On CUDA tensors each launches its hand-written Hopper kernel in
`csrc/attention.cu`; on CPU tensors each runs the plain PyTorch version
(`reference_mha`, `mha_packed_reference`). There is no fallback from a
kernel to the plain version on the card: a CUDA tensor the kernels do not
take raises. A contiguous (B, S, NH, D) tensor is the same memory as packed
(B, S, NH * D), so the kernels read a head's D lanes through strides and
need none of the TPU wrappers' transposes or padding: keys past S are masked
inside the kernel and query rows past S are not stored.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import _cuda

LANE = 128  # the TPU's lane width, to which the JAX wrappers pad S


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


KERNEL_HEAD_DIMS = (32, 64)  # head widths the kernels are compiled for
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_MAX_GRID_X = 2**31 - 1
_MAX_GRID_YZ = 65535
# shared memory one block may use on sm_90 (227 KB)
MAX_SHARED_BYTES = 232_448
_TILE_ROWS = 64  # query rows of a 4-warp tile (16 per warp, mma.m16n8k16)
_TILE_KEYS = 64  # keys per shared-memory tile
_QBLOCK_MAX_ROWS = 128  # mha_qblock's 8-warp tile
_PAIR_HEADS = 2  # heads of one mha_pairs block


def reference_mha(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Plain version on (B, S, NH, D): the JAX package's `reference_mha`.

    Scores accumulate in f32 and the softmax is f32; p is cast to the input
    dtype before the PV product, which accumulates in f32; the output is the
    input dtype. bf16 operands are widened to f32 before each product:
    bf16 x bf16 is exact in f32, so this is the f32-accumulated product of
    the bf16 values."""
    D = q.shape[-1]

    def heads(x):
        return x.transpose(1, 2).float()  # (B, NH, S, D)

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(D)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    ctx = torch.matmul(probs.float(), heads(v)).to(q.dtype)
    return ctx.transpose(1, 2)


def mha_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """Plain version of `mha_packed`: `reference_mha` per head on packed
    (B, S, H) tensors, (B, S, H) out."""
    B, S, H = q.shape
    D = H // num_heads
    split = [x.reshape(B, S, num_heads, D) for x in (q, k, v)]
    return reference_mha(*split).reshape(B, S, H)


@dataclass(frozen=True)
class Launch:
    """How one kernel call is cut: the CUDA grid, the threads of a block
    (two per query row and head), the query rows of a block's tile and the
    bytes of dynamic shared memory."""
    grid: tuple[int, int, int]
    threads: int
    rows: int
    smem: int


def qblock_rows(block_q: int) -> int:
    """The query rows of one `mha_qblock` block for the JAX `block_q`:
    rounded up to a multiple of 64 (a 4-warp tile of 16 rows per warp) and
    capped at 128 (8 warps). Each row's result does not depend on how rows
    are grouped into blocks, so every `block_q` gives the same output."""
    if block_q < 1:
        raise ValueError(f"block_q must be at least 1, got {block_q}")
    return min(_round_up(block_q, _TILE_ROWS), _QBLOCK_MAX_ROWS)


def _static_smem(D: int, itemsize: int, heads: int = 1) -> int:
    """The K/V tiles of `csrc/attention.cu:Tiles` for `heads` heads side by
    side (their heads * D contiguous lanes), in bytes."""
    lanes = heads * D
    if itemsize == 2:
        return itemsize * (_TILE_KEYS * (lanes + 8) + lanes * (_TILE_KEYS + 8))
    return itemsize * 2 * _TILE_KEYS * lanes


def launch_geometry(kind: str, B: int, S: int, NH: int, D: int,
                    itemsize: int, block_q: int = 256) -> Launch:
    """The launch of entry point `kind` at (B, S, NH, D). Query blocks are
    counted with `cdiv`, so the last, ragged one is launched too."""
    rows, smem, heads = _TILE_ROWS, 0, 1
    if kind == "mha_packed":
        grid = (cdiv(S, rows), NH, B)
    elif kind == "mha_pairs":
        # one block per (q tile, head pair, batch element); its K/V tiles
        # hold both heads' lanes and live in dynamic shared memory (the f32
        # pair is 64 KB, over the 48 KB a static array may take)
        if NH % _PAIR_HEADS:
            raise ValueError(f"mha_pairs takes an even number of heads, "
                             f"got {NH}")
        heads = _PAIR_HEADS
        grid = (cdiv(S, rows), NH // heads, B)
        smem = _static_smem(D, itemsize, heads)
    elif kind == "mha":
        grid = (B * NH, 1, 1)
    elif kind == "mha_batched_heads":
        grid = (B, 1, 1)
    elif kind == "mha_qblock":
        rows = qblock_rows(block_q)
        grid = (cdiv(S, rows), B * NH, 1)
    elif kind == "mha_fused":
        qblock_rows(block_q)  # validates; the staged tile caps rows at 64
        grid = (cdiv(S, rows), B, 1)
        smem = rows * (NH * D + 16 // itemsize) * itemsize
        if smem + _static_smem(D, itemsize) > MAX_SHARED_BYTES:
            raise ValueError(
                f"mha_fused stages a ({rows}, {NH * D}) output tile in "
                f"shared memory: {smem + _static_smem(D, itemsize)} bytes "
                f"with the K/V tiles, more than the {MAX_SHARED_BYTES} a "
                f"block may use")
    else:
        raise ValueError(f"no attention kernel named {kind!r}")
    if grid[0] > _MAX_GRID_X or max(grid[1:]) > _MAX_GRID_YZ:
        raise ValueError(f"{kind} at (B, S, NH) = {(B, S, NH)} needs the "
                         f"grid {grid}, beyond CUDA's limits")
    return Launch(grid, 2 * rows * heads, rows, smem)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str,
           ndim: int) -> None:
    if q.dim() != ndim or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{what} takes three {ndim}-D tensors of one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} takes bf16 or f32 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.shape[1] < 1:
        raise ValueError(f"{what} needs at least one token")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got "
                         f"{q.device}")


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int) -> None:
    """What the CUDA kernels take: D in KERNEL_HEAD_DIMS, contiguous and
    16-byte aligned tensors. q is (B, S, H) or (B, S, num_heads, D)."""
    D = math.prod(q.shape[2:]) // num_heads
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head widths "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            B: int, S: int, NH: int, D: int,
            block_q: int = 256) -> torch.Tensor:
    _check_kernel(q, k, v, NH)
    geo = launch_geometry(kind, B, S, NH, D, q.element_size(), block_q)
    out = torch.empty_like(q)
    suffix = "bf16" if q.dtype == torch.bfloat16 else "f32"
    fn = getattr(_cuda.load("attention"), f"{kind}_{suffix}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 S, NH, D, *geo.grid, geo.threads, geo.smem, stream)
    if err:
        raise RuntimeError(f"{kind} kernel launch failed: cudaError_t {err}")
    return out


def mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               num_heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v per head on packed (B, S, H) tensors.

    CUDA tensors (bf16 or f32, contiguous, D = H / num_heads in
    KERNEL_HEAD_DIMS) go to the Hopper kernel, one block per 64-row query
    tile, head and batch element; CPU tensors go to `mha_packed_reference`.
    Each kernel launch adds one to `mha_packed.launches`."""
    _check(q, k, v, "mha_packed", 3)
    if num_heads < 1 or q.shape[2] % num_heads:
        raise ValueError(f"H={q.shape[2]} does not split into "
                         f"num_heads={num_heads} heads")
    if q.device.type == "cpu":
        return mha_packed_reference(q, k, v, num_heads)
    B, S, H = q.shape
    out = _launch("mha_packed", q, k, v, B, S, num_heads, H // num_heads)
    mha_packed.launches += 1
    return out


def mha_pairs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              num_heads: int, block_q: int = 256) -> torch.Tensor:
    """The same function as `mha_packed`, one block per (64-row query tile,
    head pair, batch element), the TPU kernel's two heads per program.

    The block stages each 64-key K/V tile once for both heads (the pair's
    2 * D contiguous lanes) and runs one online softmax per head against
    it: warps 0-3 take head 2p, warps 4-7 head 2p + 1. The TPU kernel's
    block-diagonal zero padding, which fills its 128-wide matrix unit, is
    not carried over: it would double the products here. With an odd
    `num_heads` it is `mha_packed`, as the JAX function is (that launch
    counts in `mha_packed.launches`). `block_q` >= 1 is accepted and does
    not change the output. CPU tensors run `mha_packed_reference`. Each
    kernel launch adds one to `mha_pairs.launches`."""
    _check(q, k, v, "mha_pairs", 3)
    if block_q < 1:
        raise ValueError(f"block_q must be at least 1, got {block_q}")
    if num_heads < 1 or q.shape[2] % num_heads:
        raise ValueError(f"H={q.shape[2]} does not split into "
                         f"num_heads={num_heads} heads")
    if num_heads % _PAIR_HEADS:
        return mha_packed(q, k, v, num_heads=num_heads)
    if q.device.type == "cpu":
        return mha_packed_reference(q, k, v, num_heads)
    B, S, H = q.shape
    out = _launch("mha_pairs", q, k, v, B, S, num_heads, H // num_heads)
    mha_pairs.launches += 1
    return out


def _mha_packed_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, num_heads: int):
    """The JAX package's `_mha_packed_bwd`, step by step and with its casts:
    p is recomputed in f32 from q and k (no score residuals are kept), each
    product accumulates in f32 and each gradient is cast to the input
    dtype. bf16 operands are widened to f32 before a product, as in
    `reference_mha`: exact products, f32 sums."""
    B, S, H = q.shape
    D = H // num_heads
    scale = 1.0 / math.sqrt(D)

    def heads(x):  # (B, S, H) -> (B, NH, S, D) in f32
        return x.reshape(B, S, num_heads, D).transpose(1, 2).float()

    qh, kh, vh, gh = heads(q), heads(k), heads(v), heads(g)
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    p_b = p.to(q.dtype).float()
    dv = torch.matmul(p_b.transpose(-1, -2), gh).to(q.dtype)
    del p_b
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    del p, dp
    ds = (ds * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kh).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qh).to(q.dtype)

    def packed(x):  # (B, NH, S, D) -> (B, S, H)
        return x.transpose(1, 2).reshape(B, S, H)

    return packed(dq), packed(dk), packed(dv)


class _MhaPackedTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        return mha_packed(q, k, v, num_heads=num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_mha_packed_bwd(q, k, v, g, ctx.num_heads), None)


def mha_packed_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """`mha_packed` with a gradient, the JAX custom VJP of the same name.

    The forward is `mha_packed` (its Hopper kernel on the card, counted in
    `mha_packed.launches`; the plain version on the CPU) and saves q, k and
    v only. The backward is plain PyTorch on (B, NH, S, S), as the JAX
    backward is XLA: it recomputes p and forms dv, dp, ds = p (dp - sum p
    dp), dq and dk (`_mha_packed_bwd`). At the AST's training shape (16,
    1214, 768) each (B, NH, S, S) f32 tensor it makes is 1.13 GB."""
    return _MhaPackedTrainable.apply(q, k, v, num_heads)


def _attend(entry, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            block_q: int = 256) -> torch.Tensor:
    """Runs one (B, S, NH, D) entry point: `reference_mha` on the CPU, the
    entry's kernel on the card, counted in `entry.launches`."""
    kind = entry.__name__
    _check(q, k, v, kind, 4)
    if block_q < 1:
        raise ValueError(f"block_q must be at least 1, got {block_q}")
    if q.device.type == "cpu":
        return reference_mha(q, k, v)
    out = _launch(kind, q, k, v, *q.shape, block_q)
    entry.launches += 1
    return out


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention, (B, S, NH, D) -> (B, S, NH, D), bf16 or f32.

    The kernel runs one block per (batch element, head), which walks all
    cdiv(S, 64) query tiles of its head, as the TPU kernel runs one grid
    step per (batch * head). CPU tensors run `reference_mha`. Each kernel
    launch adds one to `mha.launches`."""
    return _attend(mha, q, k, v)


def mha_batched_heads(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Same contract as `mha`, one block per batch element, which walks the
    NH heads and their query tiles in turn (the TPU kernel's `fori_loop`
    over heads). Launches count in `mha_batched_heads.launches`."""
    return _attend(mha_batched_heads, q, k, v)


def mha_qblock(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               block_q: int = 256) -> torch.Tensor:
    """Same contract as `mha`, one block per (query block, batch * head).

    A block's query rows are `qblock_rows(block_q)`: `block_q` rounded up to
    a multiple of 64 and capped at 128 (one warp per 16 rows,
    mma.m16n8k16), so the JAX test values 64, 96, 128 and 256 give 64, 128,
    128 and 128 rows; every `block_q` >= 1 gives the same output. The
    number of blocks is cdiv(S, rows). Launches count in
    `mha_qblock.launches`."""
    return _attend(mha_qblock, q, k, v, block_q)


def mha_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              block_q: int = 256) -> torch.Tensor:
    """Same contract as `mha`, one block per (query block, batch element)
    covering all NH heads: the block stages its (rows, NH * D) output tile
    in shared memory and writes whole rows with 16-byte stores, the TPU
    kernel's single (BQ, NH, D) store.

    Rows are `qblock_rows(block_q)` capped at 64, which every `block_q` >= 1
    reaches: 64-row blocks and the same output for all. The staged tile
    must fit the block's shared memory with the K/V tiles: NH * D up to
    1664 in bf16 and 776 in f32 at D = 64 (the AST's 768 fits both); wider
    raises. Launches count in `mha_fused.launches`."""
    return _attend(mha_fused, q, k, v, block_q)


for _entry in (mha_packed, mha_pairs, mha, mha_batched_heads, mha_qblock,
               mha_fused):
    _entry.launches = 0
del _entry
