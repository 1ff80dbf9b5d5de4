"""Fused multi-head attention on packed (B, S, H) projections.

`mha_packed` is the port of the JAX package's `ops/attention.py:mha_packed`
(the Pallas kernel `_attn_kernel_packed`). On a CUDA tensor it launches the
hand-written Hopper kernel in `csrc/mha_packed.cu`; on a CPU tensor it runs
`mha_packed_reference`, the plain PyTorch version of the same contract.
There is no fallback from the kernel to the plain version on the card.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

KERNEL_HEAD_DIM = 64  # the AST's head width, the only one the kernel takes
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_MAX_GRID_DIM = 65535


def mha_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """Plain version: softmax(q k^T / sqrt(D)) v per head, (B, S, H) in and out.

    Scores accumulate in f32 and the softmax is f32; p is cast to the input
    dtype before the PV product, which accumulates in f32; the output is the
    input dtype (the JAX package's `reference_mha`). bf16 operands are
    widened to f32 before each product: bf16 x bf16 is exact in f32, so this
    is the f32-accumulated product of the bf16 values."""
    B, S, H = q.shape
    D = H // num_heads

    def heads(x):
        return x.reshape(B, S, num_heads, D).transpose(1, 2).float()

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(D)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    ctx = torch.matmul(probs.float(), heads(v)).to(q.dtype)
    return ctx.transpose(1, 2).reshape(B, S, H)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           num_heads: int) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"mha_packed takes three (B, S, H) tensors of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"mha_packed takes bf16 or f32 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if num_heads < 1 or q.shape[2] % num_heads:
        raise ValueError(f"H={q.shape[2]} does not split into "
                         f"num_heads={num_heads} heads")
    if q.shape[1] < 1:
        raise ValueError("mha_packed needs at least one token")


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int) -> None:
    B, S, H = q.shape
    if H // num_heads != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head width "
                         f"{KERNEL_HEAD_DIM}, got {H // num_heads}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if B > _MAX_GRID_DIM or num_heads > _MAX_GRID_DIM:
        raise ValueError(f"B={B} or num_heads={num_heads} exceeds the grid "
                         f"limit {_MAX_GRID_DIM}")


def mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               num_heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v per head on packed (B, S, H) tensors.

    CUDA tensors (bf16 or f32, contiguous, D = 64) go to the Hopper kernel;
    CPU tensors go to `mha_packed_reference`. Each kernel launch adds one
    to `mha_packed.launches`."""
    _check(q, k, v, num_heads)
    if q.device.type == "cpu":
        return mha_packed_reference(q, k, v, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"mha_packed runs on CPU or CUDA tensors, got "
                         f"{q.device}")
    _check_kernel(q, k, v, num_heads)
    B, S, _ = q.shape
    out = torch.empty_like(q)
    fn = (_cuda.load("mha_packed").mha_packed_bf16
          if q.dtype == torch.bfloat16
          else _cuda.load("mha_packed").mha_packed_f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, num_heads, stream)
    if err:
        raise RuntimeError(f"mha_packed kernel launch failed: cudaError_t "
                           f"{err}")
    mha_packed.launches += 1
    return out


mha_packed.launches = 0
