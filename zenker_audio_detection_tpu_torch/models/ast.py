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
("torch", the counterpart of "xla").

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
from ..utils.precision import full_f32

Params = dict[str, Any]
ATTENTION_IMPLS = ("kernel", "torch")
REMAT_POLICIES = ("full", "dots_no_batch")


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


def _trunc_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    """torch `nn.init.trunc_normal_(std=std)` in distribution.

    torch's default bounds a=-2, b=2 are absolute values, i.e. ±(2/std)
    sigmas: ≥100σ at the AST initializer_range 0.02, so the draw is an
    effectively untruncated normal(0, std). Out-of-bound draws are redrawn."""
    x = rng.standard_normal(shape)
    bound = 2.0 / std
    if bound < 10.0:
        bad = np.abs(x) > bound
        while bad.any():
            x[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(x) > bound
    return (std * x).astype(np.float32)


def init_params(rng: np.random.Generator, config: ASTConfig) -> Params:
    """Random f32 init on the CPU matching HF's scheme in distribution (not
    bitwise, and not the JAX package's draws): trunc-normal(0.02) dense and
    conv kernels, zero biases, unit LayerNorm scales, and zero CLS, DIST and
    position embeddings (ASTPreTrainedModel._init_weights)."""
    h, i = config.hidden_size, config.intermediate_size
    L = config.num_hidden_layers
    std = config.initializer_range

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    def dense(fan_in, fan_out, layers=None):
        shape = (fan_in, fan_out) if layers is None else (layers, fan_in, fan_out)
        return {"kernel": t(_trunc_normal(rng, shape, std)),
                "bias": zeros(*shape[:-2], fan_out)}

    def ln(layers=None):
        shape = (h,) if layers is None else (layers, h)
        return {"scale": torch.ones(shape, dtype=torch.float32),
                "bias": zeros(*shape)}

    p = config.patch_size
    return {
        "patch_embed": {"kernel": t(_trunc_normal(rng, (h, 1, p, p), std)),
                        "bias": zeros(h)},
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


def reinit_head(rng: np.random.Generator, params: Params, config: ASTConfig,
                num_labels: int | None = None) -> Params:
    """Re-initialize only the classifier head, as the reference does after
    `from_pretrained(..., ignore_mismatched_sizes=True)` + `init_weights()`:
    the other parameters keep their values (and tensors), the new head has
    unit/zero LayerNorm, a zero bias and a N(0, initializer_range) kernel
    drawn from `rng` (the JAX function takes a key; the draws differ). The
    head lands on the device of the other parameters."""
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


def cast_params(params: Params, dtype: torch.dtype, device) -> Params:
    """Params on `device`, with every tensor the forward pass casts to the
    compute dtype cast once here; LayerNorm parameters and the head stay in
    their f32 (the forward pass reads them in f32)."""

    def walk(tree, keep_f32):
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


def _dense(x, kernel, bias):
    # the JAX order: round the f32-accumulated product, then add the bias
    return torch.matmul(x, kernel.to(x.dtype)) + bias.to(x.dtype)


def _attention(x, lp, config: ASTConfig, impl: str):
    B, S, H = x.shape
    nh = config.num_attention_heads
    q = _dense(x, lp["q"]["kernel"], lp["q"]["bias"])
    k = _dense(x, lp["k"]["kernel"], lp["k"]["bias"])
    v = _dense(x, lp["v"]["kernel"], lp["v"]["bias"])
    if impl == "kernel":
        # Hopper kernels forward and backward, as the JAX "pallas" route
        # calls its custom VJP
        ctx = attn_ops.mha_packed_trainable(q, k, v, nh)
    else:
        ctx = attn_ops.mha_packed_reference(q, k, v, nh)
    return _dense(ctx, lp["attn_out"]["kernel"], lp["attn_out"]["bias"])


def _block(x, lp, config: ASTConfig, impl: str):
    """One pre-LN ViT block."""
    eps = config.layer_norm_eps
    h = _layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps)
    x = x + _attention(h, lp, config, impl)
    h = _layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps)
    h = _dense(h, lp["fc1"]["kernel"], lp["fc1"]["bias"])
    h = nnf.gelu(h.float(), approximate="none").to(x.dtype)
    return x + _dense(h, lp["fc2"]["kernel"], lp["fc2"]["bias"])


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
        x = patch_embed(params, input_values, config, dtype)
        B = x.shape[0]
        cls = params["cls_token"].to(dtype).expand(B, 1, config.hidden_size)
        dist = params["dist_token"].to(dtype).expand(B, 1, config.hidden_size)
        x = torch.cat([cls, dist, x], dim=1) + params["pos_embed"].to(dtype)
        enc = params["encoder"]
        for layer in range(enc["ln1"]["scale"].shape[0]):
            lp = {name: {key: leaf[layer] for key, leaf in group.items()}
                  for name, group in enc.items()}
            x = block(x, lp)
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
