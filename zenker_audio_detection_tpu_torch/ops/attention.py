"""Fused multi-head attention: softmax(q k^T / sqrt(D)) v per head.

The port of the JAX package's `ops/attention.py`. Six entry points compute
the same function with the work cut six ways, each the counterpart of one
Pallas kernel there:

- `mha_packed` and `mha_pairs` on packed (B, S, H = NH * D) projections
  (`_attn_kernel_packed`, `_attn_kernel_pairs`);
- `mha`, `mha_batched_heads`, `mha_qblock` and `mha_fused` on (B, S, NH, D)
  (`_attn_kernel`, `_attn_kernel_batched`, `_attn_kernel_qblock`,
  `_attn_kernel_fused`).

`mha_packed_relpos` is `mha_packed` with BEATs's gated relative-position
bias added to the scores (`models/beats.py`); no Pallas kernel has its
function, and the bf16 walk of `csrc/attention_ws.cu` computes it without
writing the (S, S) bias.

`mha_packed_trainable` is `mha_packed` under autograd, the counterpart of
the JAX custom VJP of that name (whose backward is XLA): the forward is
`mha_packed_lse` (`mha_packed`'s kernel that also keeps each row's
log-sum-exp), the backward two flash kernels, `mha_packed_bwd_dq` and
`mha_packed_bwd_dkdv` (`csrc/attention_bwd.cu`), that recompute the
probabilities tile by tile.

On CUDA tensors each launches a hand-written Hopper kernel, the one
`KERNEL_OF` gives it, through that kernel's C symbol:
`csrc/attention_ws.cu`'s warp-specialised walk (a persistent CTA per SM,
a TMA producer warpgroup and consumer warpgroups of 64 rows, `ws_tile`)
for bf16 `mha_packed`, `mha`, `mha_pairs` and `mha_qblock`
(`mha_packed_bf16`), `mha_packed_lse` (`mha_packed_lse_bf16`) and
`mha_packed_relpos` (`mha_packed_relpos_bf16`);
`csrc/attention_pipelined.cu`'s cp.async ring and wgmma, under
decompositions that fill the card, for `mha_batched_heads` and, in f32,
`mha_packed`, `mha`, `mha_pairs` and `mha_qblock`
(`mha_batched_heads_bf16`, `mha_batched_heads_f32`), the f32
`mha_packed_lse` (`mha_packed_lse_f32`) and `mha_fused` (`mha_fused_bf16`,
`mha_fused_f32`); `csrc/attention_bwd.cu` for the backward
(`mha_packed_bwd_dq_*`, `mha_packed_bwd_dkdv_*`). On CPU tensors each
runs the plain PyTorch version (`reference_mha`, `mha_packed_reference`,
`mha_packed_lse_reference`, `mha_packed_bwd_reference`). There is no
fallback from a kernel to the plain version on the card: a CUDA tensor the
kernels do not take raises. A contiguous (B, S, NH, D) tensor is the same memory as packed
(B, S, NH * D), so the kernels read a head's D lanes through strides and
need none of the TPU wrappers' transposes or padding: keys past S are masked
inside the kernel and query rows past S are not stored.
"""

from __future__ import annotations

import functools
import math
import re
from dataclasses import dataclass

import torch

from . import _cuda

LANE = 128  # the TPU's lane width, to which the JAX wrappers pad S


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


KERNEL_HEAD_DIMS = (32, 64)  # head widths the kernels are compiled for
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_DTYPES = ("bf16", "f32")  # their names in the C symbols
_MAX_GRID_X = 2**31 - 1
_MAX_GRID_YZ = 65535
# shared memory one block may use on sm_90 (227 KB)
MAX_SHARED_BYTES = 232_448
_TILE_ROWS = 64  # query rows of a 4-warp tile (16 per warp, mma.m16n8k16)
_TILE_KEYS = 64  # keys per shared-memory tile
# the heads of one mha_fused CTA; mha_pairs takes whole pairs of heads
_PAIR_HEADS = 2
_RING_STAGES = 3  # bf16 K/V tiles in flight (kStages)
_RING_ALIGN = 1024  # slack to align the ring for the 128-byte swizzle
# TMA's limits on a tensor map's global memory (cuTensorMapEncodeTiled):
# a 16-byte aligned base, pitches that are multiples of 16 bytes and below
# 2^40, and dimensions of at most 2^32
_TMA_ALIGN = 16
_TMA_MAX_PITCH = 1 << 40
_TMA_MAX_DIM = 1 << 32
H100_SMS = 132  # SMs of an H100 SXM, the default of launch_geometry's sms


@dataclass(frozen=True)
class Kernel:
    """One compiled attention kernel: its source `csrc/<source>.cu`, its C
    launch symbol, its C occupancy symbol (None for the f32 backward, whose
    grid assumes no CTAs per SM) and the family of its launch geometry:
    "ws" the warp-specialised walk of `csrc/attention_ws.cu` (a producer
    warpgroup and consumer warpgroups of 64 rows, `ws_tile`), "batched" the
    persistent (batch element, head, 128-row block) walk of
    `csrc/attention_pipelined.cu`, "fused" `mha_fused`'s grid there, "bwd"
    the backward's of `csrc/attention_bwd.cu` (`bwd_tile`)."""
    source: str
    launch: str
    occupancy: str | None
    geometry: str


def _kernel(source: str, name: str, dtype: str, geometry: str) -> Kernel:
    """The kernel of C symbols `{name}_{dtype}` and
    `{name}_occupancy_{dtype}` (the f32 backward has no occupancy
    symbol)."""
    occupancy = (None if geometry == "bwd" and dtype == "f32"
                 else f"{name}_occupancy_{dtype}")
    return Kernel(source, f"{name}_{dtype}", occupancy, geometry)


# (entry point, dtype) -> the compiled kernel it launches; the one place
# that choice is written. mha, mha_pairs and mha_qblock compute
# mha_packed's function on the same memory (a contiguous (B, S, NH, D)
# tensor is packed (B, S, NH * D)), so they launch its kernel: in bf16 the
# warp-specialised walk, in f32 mha_batched_heads' own.
# mha_packed_relpos has no f32 kernel.
KERNEL_OF = {
    **{(entry, "bf16"): _kernel("attention_ws", "mha_packed", "bf16", "ws")
       for entry in ("mha_packed", "mha", "mha_pairs", "mha_qblock")},
    **{(entry, "f32"): _kernel("attention_pipelined", "mha_batched_heads",
                               "f32", "batched")
       for entry in ("mha_packed", "mha", "mha_pairs", "mha_qblock",
                     "mha_batched_heads")},
    ("mha_packed_lse", "bf16"): _kernel("attention_ws", "mha_packed_lse",
                                        "bf16", "ws"),
    ("mha_packed_lse", "f32"): _kernel("attention_pipelined",
                                       "mha_packed_lse", "f32", "batched"),
    ("mha_packed_relpos", "bf16"): _kernel("attention_ws",
                                           "mha_packed_relpos", "bf16", "ws"),
    ("mha_batched_heads", "bf16"): _kernel(
        "attention_pipelined", "mha_batched_heads", "bf16", "batched"),
    **{("mha_fused", dtype): _kernel("attention_pipelined", "mha_fused",
                                     dtype, "fused") for dtype in _DTYPES},
    **{(f"mha_packed_bwd_{part}", dtype): _kernel(
        "attention_bwd", f"mha_packed_bwd_{part}", dtype, "bwd")
       for part in ("dq", "dkdv") for dtype in _DTYPES},
}


def _dtype(itemsize: int) -> str:
    return "bf16" if itemsize == 2 else "f32"


def kernel_of(kind: str, itemsize: int) -> Kernel:
    """`KERNEL_OF`'s kernel of entry point `kind` for the dtype of
    `itemsize` bytes; raises for a kind or dtype no kernel is compiled
    for."""
    dtype = _dtype(itemsize)
    if (kind, dtype) in KERNEL_OF:
        return KERNEL_OF[kind, dtype]
    compiled = [d for k, d in KERNEL_OF if k == kind]
    if compiled:
        raise ValueError(f"{kind} is compiled for {' and '.join(compiled)} "
                         f"only")
    raise ValueError(f"no attention kernel named {kind!r}")


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
    (two per query row and head, and a producer warpgroup in
    `csrc/attention_ws.cu` and the bf16 `csrc/attention_bwd.cu`), the query
    rows (keys in bwd_dkdv) of a block's tile (of a work item for the
    persistent walks), the bytes of dynamic shared memory and, for the
    kernels of `csrc/attention_pipelined.cu`, `csrc/attention_ws.cu` and
    the bf16 `csrc/attention_bwd.cu`, the CTAs per SM the design assumes
    (`occupancy` reads what the card makes of it)."""
    grid: tuple[int, int, int]
    threads: int
    rows: int
    smem: int
    ctas_per_sm: int | None = None


def _check_block_q(block_q: int) -> None:
    """`block_q` is the JAX functions' query block, at least 1. Each row's
    result does not depend on how rows are grouped into blocks, so the
    kernels' grids do not read it and every value gives the same output."""
    if block_q < 1:
        raise ValueError(f"block_q must be at least 1, got {block_q}")


@functools.lru_cache(maxsize=None)
def _constexprs(source: str, names: tuple[str, ...]) -> tuple[int, ...]:
    """The values of the int constexprs `names` of `csrc/<source>.cu`, read
    once: the source is the one place they are written."""
    pattern = rf"^constexpr int ({'|'.join(names)}) = (\d+);"
    found = dict(re.findall(pattern, (_cuda.CSRC / f"{source}.cu").read_text(),
                            re.MULTILINE))
    if sorted(found) != sorted(names):
        raise ValueError(f"no {', '.join(names)} constexprs in "
                         f"csrc/{source}.cu")
    return tuple(int(found[name]) for name in names)


def ws_tile() -> tuple[int, int, int]:
    """(keys per K/V tile, consumer warpgroups, ring stages) of the
    warp-specialised walk: the kKeys, kConsumers and kStages constexprs of
    `csrc/attention_ws.cu`."""
    return _constexprs("attention_ws", ("kKeys", "kConsumers", "kStages"))


def bwd_tile(kind: str) -> tuple[int, int]:
    """(consumer warpgroups, ring stages) of the bf16 backward kernel `kind`
    (`mha_packed_bwd_dq` or `mha_packed_bwd_dkdv`): the kDqConsumers or
    kDkdvConsumers, and kStages, constexprs of `csrc/attention_bwd.cu`."""
    dq, dkdv, stages = _constexprs(
        "attention_bwd", ("kDqConsumers", "kDkdvConsumers", "kStages"))
    return (dkdv if kind == "mha_packed_bwd_dkdv" else dq), stages


def _static_smem(D: int, itemsize: int) -> int:
    """The f32 K/V tiles of `csrc/flash_common.cuh:Tiles` for one head, in
    bytes."""
    return itemsize * 2 * _TILE_KEYS * D


def _persistent(kind: str, B: int, S: int, NH: int, rows: int, ctas: int,
                sms: int) -> tuple[int, int, int]:
    """The grid of a persistent walk: sms x ctas CTAs, at most one per
    item, walk the (batch element, head, row block) items,
    i = blockIdx.x + j * gridDim.x."""
    items = B * NH * cdiv(S, rows)
    if items > _MAX_GRID_X:
        raise ValueError(f"{kind} at (B, S, NH) = {(B, S, NH)} has "
                         f"{items} work items, beyond a 32-bit count")
    return min(items, sms * ctas), 1, 1


def _geometry(kind: str, kernel: Kernel, B: int, S: int, NH: int, D: int,
              itemsize: int, sms: int):
    """(grid, rows, threads, smem, ctas_per_sm) of `kernel`'s geometry.

    "ws": one CTA per SM of a producer and `ws_tile()`'s 64-row consumer
    warpgroups; its dynamic shared memory is the alignment slack, the ring
    of K and V tiles, then a full and an empty mbarrier per stage.
    "batched": two warpgroups (256 threads) on 128-row items, 2 CTAs per
    SM, and a ring of `_RING_STAGES` stages of 64-key K and V tiles for one
    head, or in f32 the FMA tile's K/V tiles. "fused": one CTA per (64-row
    query block, batch element), all heads; bf16 a head pair's ring, 2 CTAs
    per SM, f32 4 warps and 4 CTAs per SM. "bwd": bf16 the walk of
    `bwd_tile(kind)`, rows being query rows (bwd_dq) or keys (bwd_dkdv), its
    stages of two (64, D) tiles (and in bwd_dkdv each stage's 64 lse and
    delta values) and their mbarriers; f32 one 4-warp block per (64-row
    tile, head, batch element), static shared memory only."""
    bf16 = itemsize == 2
    if kernel.geometry == "ws":
        keys, consumers, stages = ws_tile()
        rows = _TILE_ROWS * consumers
        smem = (_RING_ALIGN + stages * 2 * keys * D * itemsize
                + 2 * stages * 8)
        return (_persistent(kind, B, S, NH, rows, 1, sms), rows,
                128 * (consumers + 1), smem, 1)
    if kernel.geometry == "batched":
        rows = 2 * _TILE_ROWS
        smem = (_RING_STAGES * 2 * _TILE_KEYS * D * itemsize + _RING_ALIGN
                if bf16 else _static_smem(D, itemsize))
        return (_persistent(kind, B, S, NH, rows, 2, sms), rows, 2 * rows,
                smem, 2)
    if kernel.geometry == "fused":
        smem = (_RING_STAGES * 2 * _PAIR_HEADS * _TILE_KEYS * D * itemsize
                + _RING_ALIGN) if bf16 else _static_smem(D, itemsize)
        threads = 2 * _TILE_ROWS * (_PAIR_HEADS if bf16 else 1)
        return ((cdiv(S, _TILE_ROWS), B, 1), _TILE_ROWS, threads, smem,
                2 if bf16 else 4)
    if not bf16:
        return (cdiv(S, _TILE_ROWS), NH, B), _TILE_ROWS, 128, 0, None
    consumers, stages = bwd_tile(kind)
    rows = _TILE_ROWS * consumers
    stats = 2 * _TILE_ROWS * 4 if kind == "mha_packed_bwd_dkdv" else 0
    smem = (_RING_ALIGN + stages * (2 * _TILE_ROWS * D * itemsize + stats)
            + 2 * stages * 8)
    return (_persistent(kind, B, S, NH, rows, 1, sms), rows,
            128 * (consumers + 1), smem, 1)


def launch_geometry(kind: str, B: int, S: int, NH: int, D: int,
                    itemsize: int, block_q: int = 256,
                    sms: int = H100_SMS) -> Launch:
    """The launch of entry point `kind` at (B, S, NH, D) in the dtype of
    `itemsize` bytes: the geometry of the kernel `KERNEL_OF` gives it
    (`_geometry`). `sms` is the card's SM count, which sizes the persistent
    walks' grids. Query blocks are counted with `cdiv`, so the last, ragged
    one is launched too. `mha_pairs` takes an even NH: the JAX function
    sends an odd one to `mha_packed`."""
    if kind == "mha_pairs" and NH % _PAIR_HEADS:
        raise ValueError(f"mha_pairs takes an even number of heads, got {NH}")
    kernel = kernel_of(kind, itemsize)
    _check_block_q(block_q)
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kind} is compiled for head widths "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if sms < 1:
        raise ValueError(f"sms must be at least 1, got {sms}")
    grid, rows, threads, smem, ctas = _geometry(kind, kernel, B, S, NH, D,
                                                itemsize, sms)
    if grid[0] > _MAX_GRID_X or max(grid[1:]) > _MAX_GRID_YZ:
        raise ValueError(f"{kind} at (B, S, NH) = {(B, S, NH)} needs the "
                         f"grid {grid}, beyond CUDA's limits")
    return Launch(grid, threads, rows, smem, ctas)


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


def _check_layout(align: int, **tensors: torch.Tensor) -> None:
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int) -> None:
    """What the CUDA kernels take: D in KERNEL_HEAD_DIMS, contiguous and
    16-byte aligned tensors. q is (B, S, H) or (B, S, num_heads, D)."""
    D = math.prod(q.shape[2:]) // num_heads
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head widths "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    _check_layout(16, q=q, k=k, v=v)


def _check_heads(q: torch.Tensor, num_heads: int) -> None:
    if num_heads < 1 or q.shape[2] % num_heads:
        raise ValueError(f"H={q.shape[2]} does not split into "
                         f"num_heads={num_heads} heads")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of CUDA `device`, read once per device; they size the
    persistent grid."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _run(kind: str, tensors, B: int, S: int, NH: int, D: int,
         block_q: int = 256) -> None:
    """Launches the kernel `KERNEL_OF` gives entry point `kind` for the
    dtype of q = tensors[0] on `tensors` (device pointers, in the C
    symbol's order), at `launch_geometry`'s grid, threads and shared
    memory."""
    q = tensors[0]
    kernel = kernel_of(kind, q.element_size())
    geo = launch_geometry(kind, B, S, NH, D, q.element_size(), block_q,
                          sm_count(q.device))
    _cuda.run(kernel.source, kernel.launch, tensors,
              (B, S, NH, D, *geo.grid, geo.threads, geo.smem), q.device)


def _launch(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            B: int, S: int, NH: int, D: int, block_q: int = 256,
            lse: torch.Tensor | None = None) -> torch.Tensor:
    """Launches `kind`'s kernel on q, k, v ((B, S, NH * D) memory) and
    returns its output; `lse`, the (B, NH, S) f32 buffer of the lse
    forward, is written too where given."""
    _check_kernel(q, k, v, NH)
    out = torch.empty_like(q)
    _run(kind, (q, k, v, out) if lse is None else (q, k, v, out, lse),
         B, S, NH, D, block_q)
    return out


def occupancy(kind: str, itemsize: int, D: int) -> int:
    """The CTAs of the kernel `KERNEL_OF` gives entry point `kind` in the
    dtype of `itemsize` bytes, at head width D, that fit on one SM of the
    current card at `launch_geometry`'s threads and shared memory, as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them. Builds the
    kernels if needed; raises on a CUDA error, and for a kernel without an
    occupancy symbol (the f32 backward's)."""
    kernel = kernel_of(kind, itemsize)
    if kernel.occupancy is None:
        raise ValueError(f"{kernel.launch} has no occupancy symbol: its "
                         f"grid assumes no CTAs per SM")
    geo = launch_geometry(kind, 1, _TILE_KEYS, _PAIR_HEADS, D, itemsize)
    fn = getattr(_cuda.load(kernel.source), kernel.occupancy)
    blocks = fn(D, geo.threads, geo.smem)
    if blocks < 0:
        raise RuntimeError(f"{kernel.occupancy}: cudaError_t {-blocks}")
    return blocks


def mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               num_heads: int, block_q: int = 256) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v per head on packed (B, S, H) tensors.

    CUDA tensors (bf16 or f32, contiguous, D = H / num_heads in
    KERNEL_HEAD_DIMS) go to a persistent walk over (batch element, head,
    query row block) items: a contiguous (B, S, H) tensor is the
    (B, S, NH, D) memory `mha_batched_heads` walks. bf16 runs the
    warp-specialised walk of `csrc/attention_ws.cu` (one CTA per SM, K/V
    tiles by TMA), f32 `mha_batched_heads`' own kernel
    (`csrc/attention_pipelined.cu`). CPU tensors go to
    `mha_packed_reference`. `block_q` >= 1 is the JAX function's
    query block; each row's result does not depend on it, so every value
    gives the same output. Each kernel launch adds one to
    `mha_packed.launches`."""
    _check(q, k, v, "mha_packed", 3)
    _check_block_q(block_q)
    _check_heads(q, num_heads)
    if q.device.type == "cpu":
        return mha_packed_reference(q, k, v, num_heads)
    B, S, H = q.shape
    out = _launch("mha_packed", q, k, v, B, S, num_heads, H // num_heads,
                  block_q)
    mha_packed.launches += 1
    return out


def mha_pairs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              num_heads: int, block_q: int = 256) -> torch.Tensor:
    """The same function as `mha_packed`, whose TPU kernel takes two heads
    per program (block-diagonal (2S, 128) K/V that fill its 128-wide
    matrix unit).

    With an even `num_heads`, CUDA tensors launch `mha_packed`'s kernel on
    the same memory, the persistent walk over (batch element, head, row
    block) items (bf16 `csrc/attention_ws.cu`, f32
    `csrc/attention_pipelined.cu`), so the output is `mha_packed`'s bit for
    bit; the pair stays in the contract, not in the grid (the two heads'
    products cannot share a tensor-core instruction, and a head-pair item
    on the walk would stage three times the K/V per row or spill,
    `csrc/attention_ws.cu`). The launch counts
    in `mha_pairs.launches` alone. With an odd `num_heads` it is
    `mha_packed` with the same `block_q`, as the JAX function is (that
    launch counts in `mha_packed.launches`). `block_q` >= 1 is accepted and
    does not change the output. CPU tensors run `mha_packed_reference`."""
    _check(q, k, v, "mha_pairs", 3)
    _check_block_q(block_q)
    _check_heads(q, num_heads)
    if num_heads % _PAIR_HEADS:
        return mha_packed(q, k, v, num_heads=num_heads, block_q=block_q)
    if q.device.type == "cpu":
        return mha_packed_reference(q, k, v, num_heads)
    B, S, H = q.shape
    out = _launch("mha_pairs", q, k, v, B, S, num_heads, H // num_heads)
    mha_pairs.launches += 1
    return out


def relpos_bias(gate: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """The (B, NH, S, S) f32 bias gate[b, h, i] * rel[h, j - i + S - 1] of
    query i and key j that `mha_packed_relpos` adds to the scores."""
    S = gate.shape[-1]
    pos = torch.arange(S, device=rel.device)
    index = pos[None, :] - pos[:, None] + (S - 1)
    return gate.float()[..., None] * rel.float()[:, index][None]


def mha_packed_relpos_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, gate: torch.Tensor,
                                rel: torch.Tensor,
                                num_heads: int) -> torch.Tensor:
    """Plain version of `mha_packed_relpos`: `mha_packed_reference` with
    `relpos_bias(gate, rel)` added to the f32 scores q k^T / sqrt(D) before
    the f32 softmax; p is cast to the input dtype before the PV product,
    which accumulates in f32. It holds the (B, NH, S, S) bias and scores."""
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    scores += relpos_bias(gate, rel)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    return _packed(torch.matmul(probs.float(), vh)).to(q.dtype)


def _check_relpos(q: torch.Tensor, gate: torch.Tensor, rel: torch.Tensor,
                  num_heads: int) -> None:
    B, S, _ = q.shape
    for name, x, shape in (("gate", gate, (B, num_heads, S)),
                           ("rel", rel, (num_heads, 2 * S - 1))):
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != q.device):
            raise ValueError(f"mha_packed_relpos: {name} must be {shape} "
                             f"float32 on {q.device}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")


def mha_packed_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      gate: torch.Tensor, rel: torch.Tensor, *,
                      num_heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + gate[b, h, i] rel[h, j - i + S - 1]) v per
    head on packed (B, S, H) tensors: BEATs's attention with its gated
    relative-position bias (`models/beats.py`). gate is (B, NH, S) f32, one
    value per query row and head; rel (NH, 2S - 1) f32, the bias of head h
    at offset j - i in rel[h, j - i + S - 1].

    CUDA tensors (bf16, contiguous, D in KERNEL_HEAD_DIMS) go to
    `ws_relpos_kernel` in `csrc/attention_ws.cu`, `mha_packed`'s walk that
    adds the bias to each f32 score tile in registers; f32 CUDA tensors are
    refused. CPU tensors go to `mha_packed_relpos_reference`. Each kernel
    launch adds one to `mha_packed_relpos.launches`."""
    _check(q, k, v, "mha_packed_relpos", 3)
    _check_heads(q, num_heads)
    _check_relpos(q, gate, rel, num_heads)
    if q.device.type == "cpu":
        return mha_packed_relpos_reference(q, k, v, gate, rel, num_heads)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"mha_packed_relpos's kernel takes bf16 q, k, v, "
                        f"got {q.dtype}")
    B, S, H = q.shape
    D = H // num_heads
    _check_kernel(q, k, v, num_heads)
    _check_layout(4, gate=gate, rel=rel)
    out = torch.empty_like(q)
    _run("mha_packed_relpos", (q, k, v, out, gate, rel), B, S, num_heads, D)
    mha_packed_relpos.launches += 1
    return out


def _mha_packed_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, num_heads: int):
    """The JAX package's `_mha_packed_bwd`, step by step and with its casts:
    p is recomputed in f32 from q and k (no score residuals are kept), each
    product accumulates in f32 and each gradient is cast to the input
    dtype. bf16 operands are widened to f32 before a product, as in
    `reference_mha`: exact products, f32 sums."""
    qh, kh, vh, gh = (_heads(x, num_heads) for x in (q, k, v, g))
    scale = 1.0 / math.sqrt(qh.shape[-1])
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
    return _packed(dq), _packed(dk), _packed(dv)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H) -> (B, NH, S, D) in f32."""
    B, S, H = x.shape
    return x.reshape(B, S, num_heads, H // num_heads).transpose(1, 2).float()


def _packed(x: torch.Tensor) -> torch.Tensor:
    """(B, NH, S, D) -> (B, S, NH * D)."""
    B, NH, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, NH * D)


def _scale_log2(D: int) -> float:
    """log2(e) / sqrt(D): scores times this are in the log2 domain, where
    the kernels keep the softmax's maximum and log-sum-exp."""
    return math.log2(math.e) / math.sqrt(D)


def mha_packed_lse_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, num_heads: int):
    """Plain version of `mha_packed_lse`: (`mha_packed_reference`'s output,
    lse), lse the (B, NH, S) f32 log-sum-exp of each query row's scores in
    the log2 domain, log2 sum_j 2^(s_ij log2(e) / sqrt(D)) with s = q k^T,
    which is the natural log-sum-exp of s / sqrt(D) times log2(e)."""
    qh, kh = _heads(q, num_heads), _heads(k, num_heads)
    x = torch.matmul(qh, kh.transpose(-1, -2)) * _scale_log2(qh.shape[-1])
    m = x.amax(dim=-1, keepdim=True)
    lse = m + torch.log2(torch.exp2(x - m).sum(dim=-1, keepdim=True))
    return mha_packed_reference(q, k, v, num_heads), lse.squeeze(-1)


def _delta_reference(o: torch.Tensor, g: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """delta = sum_d g o per query row and head, (B, NH, S) f32: the
    sum_j p dp of the softmax backward, from the forward's output."""
    return (_heads(g, num_heads) * _heads(o, num_heads)).sum(dim=-1)


def _probs_and_ds(qh, kh, vh, gh, lse, delta, dtype):
    """The backward kernels' p = 2^(s log2(e) / sqrt(D) - lse) in f32, from
    the forward's lse, and ds_b = (p (g v^T - delta) / sqrt(D)) rounded to
    the input dtype, on (B, NH, S, D) f32 heads."""
    D = qh.shape[-1]
    p = torch.exp2(torch.matmul(qh, kh.transpose(-1, -2)) * _scale_log2(D)
                   - lse.unsqueeze(-1))
    ds = p * (torch.matmul(gh, vh.transpose(-1, -2)) - delta.unsqueeze(-1))
    return p, (ds * (1.0 / math.sqrt(D))).to(dtype).float()


def mha_packed_bwd_dq_reference(q, k, v, o, lse, g, num_heads: int):
    """Plain version of `mha_packed_bwd_dq`: (dq, delta), delta =
    `_delta_reference(o, g)`, dq = ds_b k accumulated in f32 and cast to
    the input dtype."""
    qh, kh, vh, gh = (_heads(x, num_heads) for x in (q, k, v, g))
    delta = _delta_reference(o, g, num_heads)
    _, ds = _probs_and_ds(qh, kh, vh, gh, lse, delta, q.dtype)
    return _packed(torch.matmul(ds, kh)).to(q.dtype), delta


def mha_packed_bwd_dkdv_reference(q, k, v, g, lse, delta, num_heads: int):
    """Plain version of `mha_packed_bwd_dkdv`: (dk, dv), dv = bf16(p)^T g
    (p rounded to the input dtype) and dk = ds_b^T q, each accumulated in
    f32 and cast to the input dtype."""
    qh, kh, vh, gh = (_heads(x, num_heads) for x in (q, k, v, g))
    p, ds = _probs_and_ds(qh, kh, vh, gh, lse, delta, q.dtype)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), gh)
    del p
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return _packed(dk).to(q.dtype), _packed(dv).to(q.dtype)


def mha_packed_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, g: torch.Tensor,
                             num_heads: int):
    """Plain version of the two backward kernels in turn: their algorithm
    with the JAX casts (p from the forward's lse, delta from its output o,
    `_probs_and_ds`). Returns (dq, dk, dv), packed (B, S, H)."""
    dq, delta = mha_packed_bwd_dq_reference(q, k, v, o, lse, g, num_heads)
    return (dq, *mha_packed_bwd_dkdv_reference(q, k, v, g, lse, delta,
                                               num_heads))


def mha_packed_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   num_heads: int):
    """`mha_packed` that also keeps each query row's log-sum-exp for the
    backward: returns (o, lse), lse (B, NH, S) f32 as
    `mha_packed_lse_reference` defines it.

    CUDA tensors go to `mha_packed`'s kernel with an lse epilogue
    (`csrc/attention_ws.cu` in bf16, `csrc/attention_pipelined.cu` in f32):
    the same code in the same order, so o is `mha_packed`'s output bit for
    bit. CPU tensors go to
    `mha_packed_lse_reference`. Each kernel launch adds one to
    `mha_packed_lse.launches`."""
    _check(q, k, v, "mha_packed_lse", 3)
    _check_heads(q, num_heads)
    if q.device.type == "cpu":
        return mha_packed_lse_reference(q, k, v, num_heads)
    B, S, H = q.shape
    lse = torch.empty(B, num_heads, S, dtype=torch.float32, device=q.device)
    o = _launch("mha_packed_lse", q, k, v, B, S, num_heads, H // num_heads,
                lse=lse)
    mha_packed_lse.launches += 1
    return o, lse


def _check_bwd(what: str, q, k, v, num_heads: int, acts: dict,
               stats: dict) -> None:
    """The backward's operands: q, k, v as `mha_packed` takes them; `acts`
    (o, g) of q's shape, dtype and device; `stats` (lse, delta) (B, NH, S)
    f32 on q's device."""
    _check(q, k, v, what, 3)
    _check_heads(q, num_heads)
    B, S, _ = q.shape
    for name, x in acts.items():
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{what}: {name} must match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    for name, x in stats.items():
        if (x.shape != (B, num_heads, S) or x.dtype != torch.float32
                or x.device != q.device):
            raise ValueError(f"{what}: {name} must be ({B}, {num_heads}, "
                             f"{S}) float32 on {q.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if q.device.type == "cuda":
        _check_bwd_kernel(q, k, v, num_heads, acts, stats)


def _check_tma(name: str, ptr: int, shape, strides, itemsize: int) -> None:
    """What a TMA tensor map over a (B, S, H) tensor takes (hopper.cuh's
    tensor_map: dimensions (H, S, B), pitches of a row and of a batch
    element): a 16-byte aligned base address, pitches that are multiples of
    16 bytes and below 2^40 bytes, dimensions of at most 2^32."""
    if ptr % _TMA_ALIGN:
        raise ValueError(f"{name} must be {_TMA_ALIGN}-byte aligned for "
                         f"TMA, its address is {ptr:#x}")
    for pitch in (strides[1] * itemsize, strides[0] * itemsize):
        if pitch % _TMA_ALIGN or pitch >= _TMA_MAX_PITCH:
            raise ValueError(f"{name}: TMA takes pitches that are multiples "
                             f"of {_TMA_ALIGN} bytes below 2^40, got "
                             f"{pitch} bytes")
    if max(shape) > _TMA_MAX_DIM:
        raise ValueError(f"{name}: TMA takes dimensions of at most 2^32, "
                         f"got {tuple(shape)}")


def _check_bwd_kernel(q, k, v, num_heads: int, acts: dict,
                      stats: dict) -> None:
    """What the backward kernels take beyond `_check_bwd`: D in
    KERNEL_HEAD_DIMS, contiguous tensors, 16-byte aligned activations and
    4-byte aligned lse and delta; in bf16, what TMA takes of the tensors
    its maps read (`_check_tma`: q, k, v and g)."""
    _check_kernel(q, k, v, num_heads)
    _check_layout(16, **acts)
    _check_layout(4, **stats)
    if q.dtype == torch.bfloat16:
        for name, x in {"q": q, "k": k, "v": v, **acts}.items():
            _check_tma(name, x.data_ptr(), x.shape, x.stride(),
                       x.element_size())


def mha_packed_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                      num_heads: int):
    """The first backward kernel: returns (dq, delta), delta the (B, NH, S)
    f32 row sums sum_d g o that `mha_packed_bwd_dkdv` reads. o and lse are
    `mha_packed_lse`'s, g the output's gradient (all packed (B, S, H)).

    CUDA tensors go to `csrc/attention_bwd.cu`: bf16 `dq_ws_kernel`, the
    persistent walk whose producer warpgroup streams K and V tiles by TMA
    to consumer warpgroups of 64 query rows (wgmma); f32 `dq_kernel_f32`,
    one block per 64-row query tile, head and batch element. CPU tensors
    go to the plain version. Each kernel launch adds one to
    `mha_packed_bwd_dq.launches`."""
    _check_bwd("mha_packed_bwd_dq", q, k, v, num_heads, {"o": o, "g": g},
               {"lse": lse})
    if q.device.type == "cpu":
        return mha_packed_bwd_dq_reference(q, k, v, o, lse, g, num_heads)
    B, S, H = q.shape
    D = H // num_heads
    dq = torch.empty_like(q)
    delta = torch.empty(B, num_heads, S, dtype=torch.float32,
                        device=q.device)
    _run("mha_packed_bwd_dq", (q, k, v, o, lse, g, dq, delta), B, S,
         num_heads, D)
    mha_packed_bwd_dq.launches += 1
    return dq, delta


def mha_packed_bwd_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, *, num_heads: int):
    """The second backward kernel: returns (dk, dv) from the forward's lse
    and `mha_packed_bwd_dq`'s delta.

    CUDA tensors go to `csrc/attention_bwd.cu`: bf16 `dkdv_ws_kernel`, the
    persistent walk whose producer streams Q and g tiles by TMA (and their
    lse and delta) to consumer warpgroups of 64 keys (wgmma); f32
    `dkdv_kernel_f32`, one block per 64-key tile, head and batch element.
    CPU tensors go to the plain version. Each kernel launch adds one to
    `mha_packed_bwd_dkdv.launches`."""
    _check_bwd("mha_packed_bwd_dkdv", q, k, v, num_heads, {"g": g},
               {"lse": lse, "delta": delta})
    if q.device.type == "cpu":
        return mha_packed_bwd_dkdv_reference(q, k, v, g, lse, delta,
                                             num_heads)
    B, S, H = q.shape
    D = H // num_heads
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _run("mha_packed_bwd_dkdv", (q, k, v, g, lse, delta, dk, dv), B, S,
         num_heads, D)
    mha_packed_bwd_dkdv.launches += 1
    return dk, dv


def mha_packed_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                   num_heads: int):
    """(dq, dk, dv) of `mha_packed` at output gradient g: on the card
    `mha_packed_bwd_dq`, then `mha_packed_bwd_dkdv`, on the current stream;
    on the CPU `mha_packed_bwd_reference`."""
    if q.device.type == "cpu":
        _check_bwd("mha_packed_bwd", q, k, v, num_heads, {"o": o, "g": g},
                   {"lse": lse})
        return mha_packed_bwd_reference(q, k, v, o, lse, g, num_heads)
    dq, delta = mha_packed_bwd_dq(q, k, v, o, lse, g, num_heads=num_heads)
    return (dq, *mha_packed_bwd_dkdv(q, k, v, g, lse, delta,
                                     num_heads=num_heads))


class _MhaPackedTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        o, lse = mha_packed_lse(q, k, v, num_heads=num_heads)
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        return (*mha_packed_bwd(q, k, v, o, lse, g.contiguous(),
                                num_heads=ctx.num_heads), None)


def mha_packed_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """`mha_packed` with a gradient, the JAX custom VJP of the same name.

    When a gradient is needed (grad mode on and q, k or v requiring one),
    the forward is `mha_packed_lse` and saves q, k, v, its output o and the
    row log-sum-exp: nothing of (S, S) size. The backward is
    `mha_packed_bwd`: on the card the two flash kernels of
    `csrc/attention_bwd.cu`, which recompute p tile by tile from the lse, on
    the CPU their plain version. Otherwise (no grad, inference mode) it is
    `mha_packed` and saves nothing. The JAX-form plain backward
    `_mha_packed_bwd` is the yardstick the tests hold it to."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _MhaPackedTrainable.apply(q, k, v, num_heads)
    return mha_packed(q, k, v, num_heads=num_heads)


def _attend(entry, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            block_q: int = 256) -> torch.Tensor:
    """Runs one (B, S, NH, D) entry point: `reference_mha` on the CPU, the
    entry's kernel on the card, counted in `entry.launches`."""
    kind = entry.__name__
    _check(q, k, v, kind, 4)
    _check_block_q(block_q)
    if q.device.type == "cpu":
        return reference_mha(q, k, v)
    out = _launch(kind, q, k, v, *q.shape, block_q)
    entry.launches += 1
    return out


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention, (B, S, NH, D) -> (B, S, NH, D), bf16 or f32.

    The TPU kernel runs one grid step per (batch * head), holding the
    head's whole S on chip. A contiguous (B, S, NH, D) tensor is packed
    (B, S, NH * D) memory, so CUDA tensors launch `mha_packed`'s kernel as
    it is: the persistent walk over (batch element, head, row block) items
    (bf16 `csrc/attention_ws.cu`, f32 `csrc/attention_pipelined.cu`), and
    the output is `mha_packed`'s on that memory bit for bit. CPU tensors run
    `reference_mha`. Each kernel launch adds one to `mha.launches`."""
    return _attend(mha, q, k, v)


def mha_batched_heads(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Same contract as `mha`. The TPU kernel runs all heads of one batch
    element per program (a `fori_loop` over heads) to amortise its DMA
    latency; here a persistent grid of (SMs x 2) CTAs walks the work items
    (batch element, head, 128-row query block), batch-major, so the CTAs
    running at one time share a batch element's K/V in L2. Two warpgroups
    take an item's two 64-row halves on one staged K/V tile
    (`csrc/attention_pipelined.cu`). Launches count in
    `mha_batched_heads.launches`."""
    return _attend(mha_batched_heads, q, k, v)


def mha_qblock(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               block_q: int = 256) -> torch.Tensor:
    """Same contract as `mha`. The TPU kernel's grid is (batch * head,
    query block of `block_q` rows): it keeps the score tile small in VMEM
    and reuses a head's K/V across its query blocks. Each row's result does
    not depend on `block_q`, and a contiguous (B, S, NH, D) tensor is packed
    (B, S, NH * D) memory, so CUDA tensors launch `mha_packed`'s kernel as
    it is, as `mha` does: the persistent walk over (batch element, head,
    row block) items that streams K/V tiles (bf16 `csrc/attention_ws.cu`,
    f32 `csrc/attention_pipelined.cu`), and the output is `mha_packed`'s on
    that memory bit for bit. `block_q` >= 1 is checked and does not change
    the output. CPU tensors run `reference_mha`. Launches count in
    `mha_qblock.launches`."""
    return _attend(mha_qblock, q, k, v, block_q)


def mha_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              block_q: int = 256) -> torch.Tensor:
    """Same contract as `mha`, one CTA per (64-row query block, batch
    element) covering all NH heads, as the TPU kernel's program does. Its
    two warpgroups take heads 2p and 2p + 1 on one staged 64-key x 2D-lane
    K/V tile and write their rows straight from registers: the TPU kernel's
    single (BQ, NH, D) store is a Mosaic workaround, and no (rows, NH * D)
    tile is staged, so every NH * D the JAX function takes runs (an odd NH
    leaves the last pair one head). f32 walks the heads one at a time.

    Rows are 64 for every `block_q` >= 1, and so is the output. Launches
    count in `mha_fused.launches`."""
    return _attend(mha_fused, q, k, v, block_q)


for _entry in (mha_packed, mha_pairs, mha, mha_batched_heads, mha_qblock,
               mha_fused, mha_packed_lse, mha_packed_bwd_dq,
               mha_packed_bwd_dkdv, mha_packed_relpos):
    _entry.launches = 0
del _entry
