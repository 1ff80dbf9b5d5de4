"""The AST and BEATs trunks' elementwise epilogues: the work between a
block's GEMMs.

A pre-LN AST block (`models/ast.py:_block`) rounds each dense layer's
f32-accumulated product to the compute dtype and adds the bias after it
(`_dense`, the JAX order), adds the residual, and runs LayerNorm and GELU
in f32 (`_layer_norm`, the GELU line). As PyTorch operations each of those
is a pass over a GEMM's output, and LayerNorm and GELU three (a cast to
f32, the operation, the cast back). Three functions do that work with one
read and one write each, in the composition's rounding order:

- `qkv_bias`: q, k, v = bf16(P + b) for the q, k and v products;
- `residual_layer_norm`: t = bf16(P + b), x' = bf16(x + t),
  h = bf16(LN_f32(x')), for attn_out's product before ln2 and fc2's before
  the next block's ln1 (or the final LayerNorm); without P and b, h =
  bf16(LN_f32(x)), the first block's ln1;
- `bias_gelu`: bf16(gelu_erf_f32(bf16(P + b))) on fc1's product.

A post-LN BEATs block (`models/beats.py:_block`) takes its dense layers'
bias inside the product (`F.linear`) and keeps two more chains, each one
read of its inputs and one write here:

- `post_residual_layer_norm`: s = bf16(P + alpha x) as `torch.add(P, x,
  alpha=alpha)` rounds it (f32 opmath, `P + alpha * x` one fma on the
  card), h = bf16(LN_f32(s)), after attn_out's product (ln1) and fc2's
  (ln2); only h is written, the block keeps nothing else;
- `relpos_gates`: each layer's (B, NH, S) f32 gates from its bf16 q,
  `models/beats.py:relpos_gates`' product with `grep_linear`, the sums of
  its two groups of four, their sigmoid and a (b grep_a - 1) + 2, each an
  f32 step; the kernel sums the product in another order, so its gates are
  the composition's within f32 rounding (GATE_TOL).

On CUDA tensors each launches its kernel of `csrc/trunk_epilogue.cu` (bf16
or f32; in f32 every rounding to the compute dtype is an identity); on CPU
tensors each runs its plain version (`qkv_bias_reference`,
`residual_layer_norm_reference`, `bias_gelu_reference`,
`post_residual_layer_norm_reference`, `relpos_gates_reference`), the
composition line for line. There is no fallback from a kernel to the
plain version on the card: a CUDA tensor the kernels do not take raises.
The bias and residual adds, BEATs's scaled residual sum included, are the
composition's bit for bit on either device; the kernels' LayerNorm and
GELU may differ from ATen's by one bf16 ulp (the order of the f32
reduction, FMA contraction). Each kernel launch adds one to the
function's `.launches`; the plain version counts nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from . import _cuda

SOURCE = "trunk_epilogue"
MAX_NORM_WIDTH = 1024  # csrc/trunk_epilogue.cu: kMaxRow
_VECTOR_BYTES = 16  # the kernels' loads and stores
_DTYPES = (torch.bfloat16, torch.float32)
GATE_HEAD = 64  # csrc/trunk_epilogue.cu: kGateHead, the gates' head width
GATE_OUT = 8  # grep_linear's outputs: two groups of four
# the gates' kernel against their plain version: |kernel - plain| at most
# GATE_TOL of max(|plain|, 1); both sum a head's 64 f32 products of about
# unit size, in different orders
GATE_TOL = 2e-5


def qkv_bias_reference(q, k, v, bq, bk, bv):
    """Plain version of `qkv_bias`: `_dense`'s bias add on each product."""
    return q + bq, k + bk, v + bv


def residual_layer_norm_reference(x, scale, shift, eps: float, p=None,
                                  b=None):
    """Plain version of `residual_layer_norm`: the residual add of a dense
    output (`_dense`'s bias add first) and `_layer_norm`."""
    if p is not None:
        x = x + (p + b)
    h = nnf.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                       shift.float(), eps)
    return x, h.to(x.dtype)


def bias_gelu_reference(p, b):
    """Plain version of `bias_gelu`: `_dense`'s bias add and `_block`'s
    GELU line."""
    h = p + b
    return nnf.gelu(h.float(), approximate="none").to(h.dtype)


def post_residual_layer_norm_reference(p, x, scale, shift, eps: float,
                                       alpha: float):
    """Plain version of `post_residual_layer_norm`: `models/beats.py:
    _block`'s scaled residual add and `_layer_norm`."""
    s = torch.add(p, x, alpha=alpha)
    h = nnf.layer_norm(s.float(), (s.shape[-1],), scale.float(),
                       shift.float(), eps)
    return h.to(s.dtype)


def relpos_gates_reference(q, w, b, grep_a, num_heads: int):
    """Plain version of `relpos_gates`: `models/beats.py:relpos_gates`'
    composition."""
    B, S, H = q.shape
    z = torch.matmul(q.float().view(B, S, num_heads, H // num_heads),
                     w.float()) + b.float()
    ab = torch.sigmoid(z.view(B, S, num_heads, 2, GATE_OUT // 2).sum(-1))
    g = ab[..., 0] * (ab[..., 1] * grep_a.float() - 1.0) + 2.0
    return g.transpose(1, 2).contiguous()


def _check(what: str, acts: tuple, biases: tuple, norms: tuple = (),
           max_width: int | None = None, everywhere: bool = False) -> None:
    """What every call takes: activations of one shape (..., width) in
    bf16 or f32, biases of shape (width,) in their dtype, LayerNorm
    parameters (width,) in f32, all contiguous and on one CPU or CUDA
    device. On CUDA, or on either device where `everywhere`, what the
    kernels take besides: widths of whole 16-byte vectors, at most
    `max_width` elements, and 16-byte aligned tensors."""
    x = acts[0]
    shape, dtype, device = x.shape, x.dtype, x.device
    if dtype not in _DTYPES:
        raise TypeError(f"{what} takes bf16 or f32 activations, got {dtype}")
    cuda = device.type == "cuda"
    if not cuda and device.type != "cpu":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {device}")
    kernel = cuda or everywhere
    width = shape[-1]
    for group, want_shape, want_dtype, kind in (
            (acts, shape, dtype, "activation"),
            (biases, (width,), dtype, "bias"),
            (norms, (width,), torch.float32, "LayerNorm parameter")):
        for t in group:
            if t.shape != want_shape or t.dtype != want_dtype:
                raise ValueError(f"{what}: each {kind} must be {want_dtype} "
                                 f"of shape {tuple(want_shape)}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.device != device:
                raise ValueError(f"{what}: a {kind} is on {t.device}, not "
                                 f"{device}")
            if not t.is_contiguous():
                raise ValueError(f"{what}: each {kind} must be contiguous")
            if kernel and t.data_ptr() % _VECTOR_BYTES:
                raise ValueError(f"{what}: each {kind} must be 16-byte "
                                 f"aligned")
    if not kernel:
        return
    if width * x.element_size() % _VECTOR_BYTES:
        raise ValueError(f"{what}'s kernel takes widths of whole 16-byte "
                         f"vectors, got {width} {dtype} elements")
    if max_width is not None and width > max_width:
        raise ValueError(f"{what}'s kernel takes rows of at most {max_width} "
                         f"elements, got {width}")


def _suffix(x: torch.Tensor) -> str:
    return "bf16" if x.dtype == torch.bfloat16 else "f32"


def qkv_bias(q, k, v, bq, bk, bv):
    """q, k, v = bf16(q + bq), bf16(k + bk), bf16(v + bv), written over the
    products q, k, v (each (..., width), biases (width,)) and returned. On
    the card one launch does all three (`qkv_bias_elementwise_kernel`)."""
    _check("qkv_bias", (q, k, v), (bq, bk, bv))
    if q.device.type == "cpu":
        for t, s in zip((q, k, v), qkv_bias_reference(q, k, v, bq, bk, bv)):
            t.copy_(s)
        return q, k, v
    width = q.shape[-1]
    _cuda.run(SOURCE, f"qkv_bias_{_suffix(q)}", (q, k, v, bq, bk, bv),
              (q.numel() // width, width), q.device)
    qkv_bias.launches += 1
    return q, k, v


def residual_layer_norm(x, scale, shift, eps: float, p=None, b=None):
    """(x', h): x' = bf16(x + bf16(p + b)) and h = bf16(LN_f32(x')) with
    f32 `scale` and `shift` and `eps`, over the last axis; without p and b,
    x' is x and h = bf16(LN_f32(x)). x' and h are new tensors. On the card
    one warp normalises a row in registers (`residual_ln_elementwise_kernel`,
    rows of at most MAX_NORM_WIDTH elements); a launch with or without p
    counts here."""
    if (p is None) != (b is None):
        raise ValueError("residual_layer_norm takes p and b together")
    _check("residual_layer_norm", (x,) if p is None else (x, p),
           () if b is None else (b,), (scale, shift), MAX_NORM_WIDTH)
    if x.device.type == "cpu":
        return residual_layer_norm_reference(x, scale, shift, eps, p, b)
    width = x.shape[-1]
    h = torch.empty_like(x)
    ints = (x.numel() // width, width, eps)
    if p is None:
        _cuda.run(SOURCE, f"layer_norm_{_suffix(x)}", (x, scale, shift, h),
                  ints, x.device)
        out = x
    else:
        out = torch.empty_like(x)
        _cuda.run(SOURCE, f"residual_layer_norm_{_suffix(x)}",
                  (p, b, x, scale, shift, out, h), ints, x.device)
    residual_layer_norm.launches += 1
    return out, h


def bias_gelu(p, b):
    """bf16(gelu(bf16(p + b))) with the exact-erf GELU in f32, written over
    fc1's product p ((..., width), b (width,)) and returned. On the card
    one pass (`bias_gelu_elementwise_kernel`)."""
    _check("bias_gelu", (p,), (b,))
    if p.device.type == "cpu":
        return p.copy_(bias_gelu_reference(p, b))
    width = p.shape[-1]
    _cuda.run(SOURCE, f"bias_gelu_{_suffix(p)}", (p, b),
              (p.numel() // width, width), p.device)
    bias_gelu.launches += 1
    return p


def post_residual_layer_norm(p, x, scale, shift, eps: float, alpha: float):
    """h = bf16(LN_f32(bf16(p + alpha x))) with f32 `scale` and `shift` and
    `eps`, over the last axis, as a new tensor: BEATs's post-LN step, p the
    product with its bias inside, x the block's input or ln1's output.
    The sum is `torch.add(p, x, alpha=alpha)`'s bit for bit on either
    device; `alpha` is read at each call. On the card one warp normalises
    a row in registers (`post_residual_ln_elementwise_kernel`, rows of at
    most MAX_NORM_WIDTH elements, LayerNorm's body `residual_layer_norm`'s);
    the kernel's contract (whole 16-byte vectors a row, at most
    MAX_NORM_WIDTH, 16-byte aligned tensors) holds on the CPU too."""
    _check("post_residual_layer_norm", (p, x), (), (scale, shift),
           MAX_NORM_WIDTH, everywhere=True)
    if x.device.type == "cpu":
        return post_residual_layer_norm_reference(p, x, scale, shift, eps,
                                                  alpha)
    width = x.shape[-1]
    h = torch.empty_like(x)
    _cuda.run(SOURCE, f"post_residual_layer_norm_{_suffix(x)}",
              (p, x, scale, shift, h),
              (x.numel() // width, width, alpha, eps), x.device)
    post_residual_layer_norm.launches += 1
    return h


def relpos_gates(q, w, b, grep_a, num_heads: int):
    """(B, NH, S) f32 gates of one BEATs layer from its projected q (B, S,
    H) in bf16 or f32 (bias included, unscaled): z = q_h w + b (w (H / NH,
    8), b (8,), grep_a (NH,), all f32), (a, b) = sigmoid of the sums of
    z's two groups of four, g = a (b grep_a_h - 1) + 2. On the card one
    pass reads q once (`relpos_gate_elementwise_kernel`, heads of
    GATE_HEAD, H at most MAX_NORM_WIDTH), within GATE_TOL of the plain
    version; q's width and alignment are held to the kernel's contract on
    the CPU too, its head width only on the card."""
    what = "relpos_gates"
    if q.dim() != 3:
        raise ValueError(f"{what} takes q of shape (B, S, H), got "
                         f"{tuple(q.shape)}")
    _check(what, (q,), (), (), MAX_NORM_WIDTH, everywhere=True)
    B, S, H = q.shape
    if num_heads <= 0 or H % num_heads:
        raise ValueError(f"{what}: {H} lanes do not split into {num_heads} "
                         f"heads")
    for name, t, shape in (("w", w, (H // num_heads, GATE_OUT)),
                           ("b", b, (GATE_OUT,)),
                           ("grep_a", grep_a, (num_heads,))):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{q.device}")
    if q.device.type == "cpu":
        return relpos_gates_reference(q, w, b, grep_a, num_heads)
    if H != num_heads * GATE_HEAD:
        raise ValueError(f"{what}'s kernel takes heads of {GATE_HEAD}, got "
                         f"{H // num_heads}")
    gates = torch.empty(B, num_heads, S, dtype=torch.float32,
                        device=q.device)
    _cuda.run(SOURCE, f"relpos_gates_{_suffix(q)}", (q, w, b, grep_a, gates),
              (B, S, H, num_heads), q.device)
    relpos_gates.launches += 1
    return gates


for _entry in (qkv_bias, residual_layer_norm, bias_gelu,
               post_residual_layer_norm, relpos_gates):
    _entry.launches = 0
del _entry
