"""Audio Spectrogram Transformer (AST) as plain functions on tensors.

Port of the JAX package's `models/ast.py`, the architecture the reference
fine-tunes through HuggingFace `ASTForAudioClassification`:

  input (B, 1024, 128) -> Conv2d(1->H, k=16x16, strides (10,10)) over the
  (mel=128, time=1024) plane -> 12x101 = 1212 patches -> [CLS, DIST] + patches
  + learned position embeddings (1214 tokens) -> 12 pre-LN ViT blocks
  (exact-erf GELU, LN eps 1e-12) -> final LN -> pooled = (CLS + DIST)/2 ->
  head = LN + Linear(H -> num_labels).

Parameters are a nested dict of tensors with the JAX package's layout (the
per-layer tensors stacked on a leading axis, dense kernels (in, out)),
except that the patch-embedding kernel is OIHW, PyTorch's conv layout.
`models.convert.params_from_jax` carries a JAX pytree across.

Numerics follow the JAX package:
  * LayerNorm statistics in f32 (eps 1e-12) whatever the compute dtype;
  * GELU is exact-erf and computed in f32;
  * a dense layer rounds the f32-accumulated product to the compute dtype
    and then adds the bias in that dtype (`_dense`), as the JAX package does.
    `F.linear` would add the bias inside the GEMM, before the rounding: one
    bf16 rounding apart per layer. The port keeps the JAX order, at the cost
    of one extra elementwise pass over each dense output;
  * logits are f32;
  * the forward runs inside `full_f32()`, so f32 matmuls and the f32 patch
    convolution never use TF32. The backward runs after that context has
    exited: a caller that differentiates an f32 forward runs the backward
    inside `full_f32()` too, as `train.steps` does, or cuDNN computes the
    patch convolution's weight gradient in TF32.
Attention is `ops.attention.mha_packed_trainable` ("kernel", the
counterpart of the JAX "pallas" route: Hopper kernels forward and
backward, `mha_packed` when no gradient is taken) or the plain version
("torch", the counterpart of "xla"). Under a profiler each attention call
is an `ast.attention` span (`utils.profiling.span`).

int8 inference is the JAX package's: `quantize_params` turns the encoder's
six dense kernels into per-output-channel int8 leaves, and `_dense`
dispatches such a leaf to `_dense_int8` (per-token activation quantization
and an int8 product, `torch._int_mm`).

For training, `remat` recomputes each block's forward in the backward
(`torch.utils.checkpoint`), as the JAX package's `jax.checkpoint` does, and
`reinit_head` and `adapt_max_length` are the JAX functions of those names.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as nnf

from ..ops import attention as attn_ops
from ..ops import fbank as F
from ..utils import prng
from ..utils.precision import full_f32
from ..utils.profiling import span

Params = dict[str, Any]
ATTENTION_IMPLS = ("kernel", "torch")
FRONT_END = F.FrontEnd()  # ASTFeatureExtractor
REMAT_POLICIES = ("full", "dots_no_batch")
# the encoder dense layers `quantize_params` turns into int8
INT8_DENSE = ("q", "k", "v", "attn_out", "fc1", "fc2")


@dataclasses.dataclass(frozen=True)
class ASTConfig:
    """Mirrors `transformers.ASTConfig` fields the forward pass depends on."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    patch_size: int = 16
    frequency_stride: int = 10
    time_stride: int = 10
    max_length: int = 1024
    num_mel_bins: int = 128
    num_labels: int = 2
    initializer_range: float = 0.02
    qkv_bias: bool = True

    @property
    def frequency_out_dimension(self) -> int:
        return (self.num_mel_bins - self.patch_size) // self.frequency_stride + 1

    @property
    def time_out_dimension(self) -> int:
        return (self.max_length - self.patch_size) // self.time_stride + 1

    @property
    def num_patches(self) -> int:
        return self.frequency_out_dimension * self.time_out_dimension

    @property
    def seq_length(self) -> int:
        return self.num_patches + 2  # CLS + distillation tokens

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


Rng = np.random.Generator | np.ndarray  # a Generator or a utils.prng key


def _trunc_normal(rng: Rng, shape, std: float,
                  jit: bool = False) -> np.ndarray:
    """torch `nn.init.trunc_normal_(std=std)` in distribution, f32.

    torch's default bounds a=-2, b=2 are absolute values, i.e. ±(2/std)
    sigmas: ≥100σ at the AST initializer_range 0.02, so the draw is an
    effectively untruncated normal(0, std). With a numpy `Generator`,
    out-of-bound draws are redrawn. With a `utils.prng` key, the draw is
    the JAX package's `_trunc_normal` bit for bit: `std * normal` where
    the bounds lie beyond 10σ, else `std * truncated_normal`; `jit` says
    that the JAX function ran inside a jitted one (`init_params`), where
    XLA folds the constants: std into normal's factor, the bounds' erf."""
    bound = 2.0 / std
    if prng.is_key(rng):
        if bound < 10.0:
            return np.float32(std) * prng.truncated_normal(
                rng, -bound, bound, shape, jit=jit)
        if jit:
            return prng.normal(rng, shape, std)
        return np.float32(std) * prng.normal(rng, shape)
    x = rng.standard_normal(shape)
    if bound < 10.0:
        bad = np.abs(x) > bound
        while bad.any():
            x[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(x) > bound
    return (std * x).astype(np.float32)


def init_params(rng: Rng, config: ASTConfig) -> Params:
    """Random f32 init on the CPU matching HF's scheme: trunc-normal(0.02)
    dense and conv kernels, zero biases, unit LayerNorm scales, and zero
    CLS, DIST and position embeddings (ASTPreTrainedModel._init_weights).

    `rng` is a numpy `Generator` (draws in HF's distribution, not the JAX
    package's) or a `utils.prng` key: then the JAX package's
    `init_params(key)` bit for bit, `split(key, 8)` giving one key per
    tensor in its order (patch kernel, q, k, v, attn_out, fc1, fc2, head),
    the patch kernel drawn in JAX's (p, p, 1, h) layout and laid out
    (h, 1, p, p)."""
    h, i = config.hidden_size, config.intermediate_size
    L = config.num_hidden_layers
    std = config.initializer_range
    keys = iter(prng.split(rng, 8) if prng.is_key(rng) else [rng] * 8)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    def dense(fan_in, fan_out, layers=None):
        shape = (fan_in, fan_out) if layers is None else (layers, fan_in, fan_out)
        return {"kernel": t(_trunc_normal(next(keys), shape, std, jit=True)),
                "bias": zeros(*shape[:-2], fan_out)}

    def ln(layers=None):
        shape = (h,) if layers is None else (layers, h)
        return {"scale": torch.ones(shape, dtype=torch.float32),
                "bias": zeros(*shape)}

    p = config.patch_size
    k0 = next(keys)
    patch = (_trunc_normal(k0, (p, p, 1, h), std, jit=True).transpose(
        3, 2, 0, 1) if prng.is_key(k0) else _trunc_normal(k0, (h, 1, p, p), std))
    return {
        "patch_embed": {"kernel": t(patch), "bias": zeros(h)},
        "cls_token": zeros(1, 1, h),
        "dist_token": zeros(1, 1, h),
        "pos_embed": zeros(1, config.seq_length, h),
        "encoder": {
            "ln1": ln(L),
            "q": dense(h, h, L),
            "k": dense(h, h, L),
            "v": dense(h, h, L),
            "attn_out": dense(h, h, L),
            "ln2": ln(L),
            "fc1": dense(h, i, L),
            "fc2": dense(i, h, L),
        },
        "ln_final": ln(),
        "head": {"ln": ln(), "dense": dense(h, config.num_labels)},
    }


def reinit_head(rng: Rng, params: Params, config: ASTConfig,
                num_labels: int | None = None) -> Params:
    """Re-initialize only the classifier head, as the reference does after
    `from_pretrained(..., ignore_mismatched_sizes=True)` + `init_weights()`:
    the other parameters keep their values (and tensors), the new head has
    unit/zero LayerNorm, a zero bias and a N(0, initializer_range) kernel
    drawn from `rng`: a `utils.prng` key gives the JAX function's kernel
    for that key bit for bit, a numpy `Generator` a draw of the same
    distribution. The head lands on the device of the other parameters."""
    n = num_labels if num_labels is not None else config.num_labels
    h = config.hidden_size
    device = params["ln_final"]["scale"].device

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    new = dict(params)
    new["head"] = {
        "ln": {"scale": t(np.ones(h)), "bias": t(np.zeros(h))},
        "dense": {"kernel": t(_trunc_normal(rng, (h, n),
                                            config.initializer_range)),
                  "bias": t(np.zeros(n))},
    }
    return new


def adapt_max_length(params: Params, config: ASTConfig,
                     new_max_length: int) -> tuple[Params, ASTConfig]:
    """Adapt a model to another input length by cutting or zero-extending
    the time axis of the position embeddings, the AST authors' transfer
    trick and the JAX function of this name. pos_embed is [CLS, DIST,
    patch(f=0, t=0..T-1), patch(f=1, ...), ...]: it is reshaped to
    (F, T, H), cut or extended along T and flattened back. Every other
    parameter is length-independent and kept as it is."""
    new_config = dataclasses.replace(config, max_length=new_max_length)
    F_dim, T_old = config.frequency_out_dimension, config.time_out_dimension
    T_new = new_config.time_out_dimension
    h = config.hidden_size
    pe = params["pos_embed"]  # (1, 2 + F * T_old, H)
    special, patches = pe[:, :2], pe[:, 2:].reshape(F_dim, T_old, h)
    if T_new <= T_old:
        patches = patches[:, :T_new]
    else:
        patches = torch.cat([patches, patches.new_zeros(
            (F_dim, T_new - T_old, h))], dim=1)
    new_params = dict(params)
    new_params["pos_embed"] = torch.cat(
        [special, patches.reshape(1, F_dim * T_new, h)], dim=1)
    return new_params, new_config


def quantize_params(params: Params) -> Params:
    """int8 inference weights, the JAX function of this name.

    Per-output-channel symmetric int8 quantization of the encoder's six
    dense kernels (q, k, v, attn_out, fc1, fc2), in numpy as the JAX
    package does it: each {"kernel", "bias"} becomes {"kernel_int8",
    "scale", "bias"} with scale = max |w| over the input axis / 127
    ((L, 1, out) for the stacked (L, in, out) kernels); `_dense` dispatches
    on the key. Activations are quantized per token at run time
    (`_dense_int8`). Everything else stays as it is. Idempotent: a leaf
    that is already quantized passes through. The leaves come back as CPU
    tensors."""

    def quant(leaf_dict):
        if "kernel_int8" in leaf_dict:
            return leaf_dict
        w = _numpy(leaf_dict["kernel"])
        scale = np.max(np.abs(w), axis=-2, keepdims=True) / 127.0
        scale = np.maximum(scale, 1e-12)
        w_q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
        return {"kernel_int8": torch.from_numpy(w_q),
                "scale": torch.from_numpy(scale.astype(np.float32)),
                "bias": torch.from_numpy(_numpy(leaf_dict["bias"]))}

    new = dict(params)
    enc = dict(params["encoder"])
    for name in INT8_DENSE:
        enc[name] = quant(enc[name])
    new["encoder"] = enc
    return new


def _numpy(x) -> np.ndarray:
    """A tensor or array leaf as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def cast_params(params: Params, dtype: torch.dtype, device) -> Params:
    """Params on `device`, with every tensor the forward pass casts to the
    compute dtype cast once here; LayerNorm parameters and the head stay in
    their f32 (the forward pass reads them in f32). An int8 leaf
    ({"kernel_int8", "scale", "bias"}) keeps its int8 kernel and its f32
    scale and bias, which `_dense_int8` reads in f32; the kernel of each
    layer is laid out column-major (same shape and values): on an H100
    `torch._int_mm` takes a row-major second operand too, but runs 4-5x
    slower with it (`chip_smoke.py` phase 8 times both)."""

    def walk(tree, keep_f32):
        if "kernel_int8" in tree:
            w = torch.as_tensor(tree["kernel_int8"]).to(device=device,
                                                        dtype=torch.int8)
            return {"kernel_int8": w.transpose(-1, -2).contiguous()
                    .transpose(-1, -2),
                    **{k: torch.as_tensor(tree[k]).to(device=device,
                                                      dtype=torch.float32)
                       for k in ("scale", "bias")}}
        out = {}
        for name, leaf in tree.items():
            f32 = keep_f32 or name.startswith("ln") or name == "head"
            if isinstance(leaf, dict):
                out[name] = walk(leaf, f32)
            else:
                leaf = torch.as_tensor(leaf)
                out[name] = leaf.to(device=device,
                                    dtype=torch.float32 if f32 else dtype)
        return out

    return walk(params, False)


def _layer_norm(x, scale, bias, eps):
    # statistics in f32 regardless of the compute dtype
    y = nnf.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                       eps)
    return y.to(x.dtype)


def _dense(x, p):
    if "kernel_int8" in p:
        return _dense_int8(x, p)
    # the JAX order: round the f32-accumulated product, then add the bias
    return torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"].to(x.dtype)


def quantize_tokens(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization of activations, the JAX
    function's order: f32 max |x| over the last axis / 127 (at least
    1e-12), then round half to even of x / scale, clipped to +-127.
    Returns (scale (..., 1) f32, x_q int8). The division by 127 divides by
    a 0-d tensor on x's device: on the card PyTorch turns a division by a
    Python number into a product with its rounded reciprocal, which is an
    ulp off the quotient for some inputs, and would move the scales off
    the CPU's and JAX's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s_x = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-12)
    x_q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    return s_x, x_q


def _dense_int8(x, p):
    """Dynamic per-token activation quantization (`quantize_tokens`), an
    int8 x int8 -> int32 product and the rescale y * (s_x * scale) + bias
    in f32, cast to x's dtype, in the JAX function's order. The product is
    `torch._int_mm` (the JAX package leaves it to XLA's int8 matmul); on
    the card it takes more than 16 rows and K, N multiples of 8, and raises
    on anything else."""
    s_x, x_q = quantize_tokens(x)
    w = p["kernel_int8"]
    y = torch._int_mm(x_q.reshape(-1, x_q.shape[-1]), w).float()
    y = y.reshape(*x.shape[:-1], w.shape[-1])
    y = y * (s_x * p["scale"].float())
    return (y + p["bias"].float()).to(x.dtype)


def _attention(x, lp, config: ASTConfig, impl: str):
    nh = config.num_attention_heads
    q = _dense(x, lp["q"])
    k = _dense(x, lp["k"])
    v = _dense(x, lp["v"])
    with span("ast.attention"):
        if impl == "kernel":
            # Hopper kernels forward and backward, as the JAX "pallas" route
            # calls its custom VJP
            ctx = attn_ops.mha_packed_trainable(q, k, v, nh)
        else:
            ctx = attn_ops.mha_packed_reference(q, k, v, nh)
    return _dense(ctx, lp["attn_out"])


def _block(x, lp, config: ASTConfig, impl: str):
    """One pre-LN ViT block."""
    eps = config.layer_norm_eps
    h = _layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps)
    x = x + _attention(h, lp, config, impl)
    h = _layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps)
    h = _dense(h, lp["fc1"])
    h = nnf.gelu(h.float(), approximate="none").to(x.dtype)
    return x + _dense(h, lp["fc2"])


def patch_embed(params: Params, input_values: torch.Tensor,
                config: ASTConfig, dtype=torch.float32) -> torch.Tensor:
    """(B, max_length, 128) features -> (B, num_patches, H) embeddings.

    HF transposes to (B, 1, mel, time), convolves with strides
    (freq, time) and flattens frequency-major: patch (f, t) lands at
    f * time_out_dimension + t."""
    x = input_values.to(dtype).transpose(-1, -2).unsqueeze(1)  # (B,1,mel,time)
    with full_f32():
        out = nnf.conv2d(x, params["patch_embed"]["kernel"].to(dtype),
                         stride=(config.frequency_stride, config.time_stride))
    out = out + params["patch_embed"]["bias"].to(dtype)[None, :, None, None]
    B = out.shape[0]
    return out.permute(0, 2, 3, 1).reshape(B, config.num_patches,
                                           config.hidden_size)


def _save_weight_products(ctx, op, *args, **kwargs):
    """The "dots_no_batch" policy: keep the outputs of the products with no
    batch dimension (the dense layers' `mm`; the attention's products are
    batched `bmm`) and recompute everything else, as the JAX
    `checkpoint_dots_with_no_batch_dims` policy does."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(block, remat_policy: str):
    """`block` under `torch.utils.checkpoint`: "full" saves only the block's
    input, "dots_no_batch" also the weight products (selective activation
    checkpointing). The recomputed forward runs inside `full_f32()` like the
    first one, whenever the backward runs."""
    from torch.utils import checkpoint as ckpt

    kw = {}
    if remat_policy == "dots_no_batch":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_weight_products)

    def f32_block(x, lp):
        with full_f32():
            return block(x, lp)

    return lambda x, lp: ckpt.checkpoint(f32_block, x, lp,
                                         use_reentrant=False, **kw)


def encode(params: Params, input_values: torch.Tensor, config: ASTConfig,
           *, dtype=torch.float32, remat: bool = False,
           remat_policy: str = "full",
           attention_impl: str = "torch") -> torch.Tensor:
    """Full trunk: features -> final-LN'd hidden states (B, S, H).

    remat_policy (when remat=True and autograd records):
      "full": save each block's input only and recompute the block in the
        backward; without it the per-layer f32 score tensors are kept;
      "dots_no_batch": save the dense layers' products too and recompute
        only the attention internals and the elementwise work.
    Remat changes no number, only what is kept for the backward."""
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, "
                         f"got {attention_impl!r}")
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {remat_policy!r}")
    block = functools.partial(_block, config=config, impl=attention_impl)
    if remat and torch.is_grad_enabled():
        block = _checkpointed(block, remat_policy)
    with full_f32():
        x = embed(params, input_values, config, dtype)
        enc = params["encoder"]
        for layer in range(enc["ln1"]["scale"].shape[0]):
            lp = {name: {key: leaf[layer] for key, leaf in group.items()}
                  for name, group in enc.items()}
            x = block(x, lp)
        return final_norm(params, x, config)


def embed(params: Params, input_values: torch.Tensor, config: ASTConfig,
          dtype=torch.float32) -> torch.Tensor:
    """The tokens before the first block: patch embeddings after the CLS
    and distillation tokens, plus the position embeddings (B, S, H)."""
    x = patch_embed(params, input_values, config, dtype)
    B = x.shape[0]
    cls = params["cls_token"].to(dtype).expand(B, 1, config.hidden_size)
    dist = params["dist_token"].to(dtype).expand(B, 1, config.hidden_size)
    return torch.cat([cls, dist, x], dim=1) + params["pos_embed"].to(dtype)


def final_norm(params: Params, x: torch.Tensor,
               config: ASTConfig) -> torch.Tensor:
    """The trunk's last LayerNorm."""
    return _layer_norm(x, params["ln_final"]["scale"],
                       params["ln_final"]["bias"], config.layer_norm_eps)


def pool(hidden: torch.Tensor) -> torch.Tensor:
    """(CLS + distillation) / 2 pooling."""
    return (hidden[:, 0] + hidden[:, 1]) / 2.0


def classify(params: Params, pooled: torch.Tensor,
             config: ASTConfig) -> torch.Tensor:
    """ASTMLPHead: LayerNorm + Linear. Logits in f32."""
    h = _layer_norm(pooled, params["head"]["ln"]["scale"],
                    params["head"]["ln"]["bias"], config.layer_norm_eps)
    with full_f32():
        logits = torch.matmul(h.float(),
                              params["head"]["dense"]["kernel"].float())
    return logits + params["head"]["dense"]["bias"].float()


def forward(params: Params, input_values: torch.Tensor, config: ASTConfig,
            *, dtype=torch.float32, remat: bool = False,
            remat_policy: str = "full",
            attention_impl: str = "torch") -> torch.Tensor:
    """(B, max_length, num_mel_bins) normalized features -> (B, num_labels)
    f32 logits, equivalent to `ASTForAudioClassification.forward(...).logits`."""
    hidden = encode(params, input_values, config, dtype=dtype, remat=remat,
                    remat_policy=remat_policy, attention_impl=attention_impl)
    return classify(params, pool(hidden), config)
