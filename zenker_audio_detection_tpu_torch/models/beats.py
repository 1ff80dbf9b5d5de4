"""BEATs (iter3+, AS2M) as plain functions on tensors: the cascade's second
architecture.

BEATs (Chen et al., "BEATs: Audio Pre-Training with Acoustic Tokenizers",
arXiv:2212.09058; `BEATs.py` and `backbone.py` of
github.com/microsoft/unilm/tree/master/beats), the configuration of the
`BEATs_iter3_plus_AS2M` checkpoint, for one window of T frames:

  features (B, T, 128), Kaldi fbank with the povey window on 2^15 times the
  audio (`FRONT_END`), normalised (x - 15.41663) /
  (2 * 6.55582) -> Conv2d(1 -> 512, k 16, stride 16, no bias) over (T, 128),
  flattened time-major to S = T/16 * 8 tokens -> LayerNorm(512) ->
  Linear(512 -> 768) -> x + GELU(Conv1d(768 -> 768, k 128, pad 64, groups
  16)(x) less its last output) -> LayerNorm -> 12 post-LN DeepNorm blocks,
  alpha = (2 * 12)^(1/4):
      x = LN(alpha x + Attn(x)),  x = LN(alpha x + FC2(GELU(FC1(x))))
  -> logits = predictor(mean over tokens of x).

Attention per head h adds to the scores q_i k_j / sqrt(64) the term
g_hi P[bucket(j - i), h]: P is layer 1's Embedding(320, 12) table, which
every layer reads ungated; bucket is the T5 bidirectional bucket (160 a
side, exact below 80, log-spaced to 800); the gate g_hi = a (b grep_a_h -
1) + 2, where (a, b) = sigmoid of the sums over groups of four of each
layer's Linear(64 -> 8) `grep_linear` of the unscaled projected q_hi
(`backbone.py`: `q * alpha / scaling`; HF's WavLM gates the layer's input
instead). BEATs's `alpha = 32` shift of the scores is an identity under the
softmax and is left out. The relative-position vector r_h[d] =
P[bucket(d), h], d in [-(S - 1), S - 1], is computed once a forward
(`relpos_vector`), each layer's gates in f32 (`relpos_gates`), and
`ops.attention.mha_packed_relpos` adds g_hi r_h[j - i] to the scores
inside the Hopper walk ("kernel") or through its plain version ("torch").

Parameters are a nested dict in the AST module's layout: dense kernels
(in, out) stacked over layers on a leading axis, the patch kernel (512, 1,
16, 16), the position convolution's kernel (768, 48, 128) with its weight
norm folded in (`models.convert.beats_params_from_state_dict` reads the
published state dict), the predictor under `head.dense`. Numerics:
LayerNorm statistics in f32 as in `models.ast`; GELU computed in f32 inside
PyTorch's kernel and rounded once to the compute dtype; dense layers with
their bias added inside the product (`F.linear`, before the rounding:
BEATs has no JAX function whose order to keep); the gates, the position
convolution and the logits in f32; the forward inside `full_f32()`. Where
autograd records nothing (`fused_trunk`: the engine, streaming, every
no-grad forward) each block's two post-LN steps run as
`ops.epilogue.post_residual_layer_norm` and each layer's gates as
`ops.epilogue.relpos_gates`: on the card one kernel each
(`csrc/trunk_epilogue.cu`), which rounds the residual sum
bf16(P + alpha x) as `torch.add` does (one f32 fma), then normalises in
f32 and rounds once (within one bf16 ulp of ATen's LayerNorm), and reads
the bf16 q once for the gates' f32 product, sums, sigmoid and a (b grep_a
- 1) + 2 (within `GATE_TOL` of the f32 composition); on the CPU their
plain versions, the composition bit for bit. A recorded forward keeps the
composition. Under a profiler the work is named by the
spans `beats.embed` (stem and position convolution), `beats.relpos` (the
bucket vector, each layer's gates) and `beats.attention` (each attention
call). Inference only: training and int8 take the AST alone.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as nnf

from ..ops import attention as attn_ops
from ..ops import epilogue as epi
from ..ops import fbank as F
from ..utils.precision import full_f32
from ..utils.profiling import span
from .ast import ATTENTION_IMPLS, Params, _layer_norm

# `BEATs.preprocess`: torchaudio's Kaldi fbank with its defaults on the
# PCM values (2^15 times the [-1, 1] audio), so the povey window and log-mel
# values that are the AST's plus ln(2^30) where the floor is not met
FRONT_END = F.FrontEnd("povey", 2.0 ** 15)
# leaves that stay f32 whatever the compute dtype: the LayerNorms, the
# position-bias table and the gates' weights (the gates are f32), the head
_F32_LEAVES = ("ln", "rel_bias", "grep", "head")


@dataclasses.dataclass(frozen=True)
class BEATsConfig:
    """The `cfg` of the published `BEATs_iter3_plus_AS2M` checkpoint (its
    names), with `num_labels` for the predictor's classes and `max_length`
    for the frames of a window. The port computes the post-LN (DeepNorm or
    not) form with the gated relative-position bias that this checkpoint
    uses; `__post_init__` refuses the other forms of the published code."""

    input_patch_size: int = 16
    embed_dim: int = 512
    conv_bias: bool = False
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    layer_norm_first: bool = False
    deep_norm: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True
    num_labels: int = 527
    num_mel_bins: int = 128
    max_length: int = 1024
    layer_norm_eps: float = 1e-5

    def __post_init__(self):
        if (self.layer_norm_first or self.conv_bias
                or not self.relative_position_embedding
                or not self.gru_rel_pos):
            raise ValueError(
                "the port computes BEATs iter3+'s form: post-LN blocks "
                "(layer_norm_first False), no patch bias (conv_bias False) "
                "and the gated relative-position bias "
                "(relative_position_embedding and gru_rel_pos True)")
        if self.max_length % self.input_patch_size or \
                self.num_mel_bins % self.input_patch_size:
            raise ValueError("max_length and num_mel_bins must be multiples "
                             "of input_patch_size")

    @property
    def seq_length(self) -> int:
        p = self.input_patch_size
        return (self.max_length // p) * (self.num_mel_bins // p)

    @property
    def head_dim(self) -> int:
        return self.encoder_embed_dim // self.encoder_attention_heads

    @property
    def deep_norm_alpha(self) -> float:
        """DeepNorm's residual factor (2 L)^(1/4); 1 without DeepNorm."""
        return (2 * self.encoder_layers) ** 0.25 if self.deep_norm else 1.0


def init_params(rng: np.random.Generator, config: BEATsConfig) -> Params:
    """Random f32 parameters on the CPU in the published init's
    distributions (`init_bert_params`: dense, patch and table N(0, 0.02),
    zero biases, unit LayerNorms; the position convolution N(0, sqrt(4 /
    (K H))); `grep_a` ones). DeepNorm's rescaled Xavier init of some
    projections is not drawn: the port holds no training of BEATs."""
    E, H = config.embed_dim, config.encoder_embed_dim
    I, L = config.encoder_ffn_embed_dim, config.encoder_layers
    NH, D, p = config.encoder_attention_heads, config.head_dim, \
        config.input_patch_size
    K, G = config.conv_pos, config.conv_pos_groups

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    def normal(shape, std=0.02):
        return t(std * rng.standard_normal(shape))

    def dense(i, o, layers=(L,)):
        return {"kernel": normal((*layers, i, o)),
                "bias": torch.zeros((*layers, o))}

    def ln(width, layers=()):
        return {"scale": torch.ones((*layers, width)),
                "bias": torch.zeros((*layers, width))}

    return {
        "patch_embed": {"kernel": normal((E, 1, p, p))},
        "ln_patch": ln(E),
        "proj": dense(E, H, ()),
        "pos_conv": {"kernel": normal((H, H // G, K), math.sqrt(4 / (K * H))),
                     "bias": torch.zeros(H)},
        "ln_pos": ln(H),
        "rel_bias": normal((config.num_buckets, NH)),
        "encoder": {
            "q": dense(H, H), "k": dense(H, H), "v": dense(H, H),
            "grep": dense(D, 8), "grep_a": torch.ones(L, NH),
            "attn_out": dense(H, H), "ln1": ln(H, (L,)),
            "fc1": dense(H, I), "fc2": dense(I, H), "ln2": ln(H, (L,)),
        },
        "head": {"dense": dense(H, config.num_labels, ())},
    }


def cast_params(params: Params, dtype: torch.dtype, device) -> Params:
    """Params on `device`; the dense, patch and convolution kernels and
    biases cast once to the compute dtype, the LayerNorms, the position-bias
    table, the gates' weights and the head kept in f32."""

    def walk(tree, keep_f32):
        out = {}
        for name, leaf in tree.items():
            f32 = keep_f32 or name.startswith(_F32_LEAVES)
            if isinstance(leaf, dict):
                out[name] = walk(leaf, f32)
            else:
                out[name] = torch.as_tensor(leaf).to(
                    device=device, dtype=torch.float32 if f32 else dtype)
        return out

    return walk(params, False)


def relative_position_bucket(relative: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """The T5 bidirectional bucket of each offset j - i, as `backbone.py`'s
    `_relative_positions_bucket` computes it: half the buckets a side
    (positive offsets in the upper half), offsets below a quarter of the
    buckets exact, the rest log-spaced up to `max_distance` and clamped to
    the side's last bucket."""
    half = num_buckets // 2
    buckets = (relative > 0).long() * half
    n = relative.abs()
    max_exact = half // 2
    large = max_exact + (torch.log(n.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (half - max_exact)).long()
    large = torch.clamp_max(large, half - 1)
    return buckets + torch.where(n < max_exact, n, large)


@functools.lru_cache(maxsize=16)
def _bucket_index(S: int, num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """The buckets of the offsets -(S - 1) .. S - 1, computed on the CPU and
    kept on `device` once: a host-to-device copy per forward would wait for
    the device's queued work."""
    d = torch.arange(-(S - 1), S)
    return relative_position_bucket(d, num_buckets, max_distance).to(device)


def relpos_vector(params: Params, config: BEATsConfig,
                  S: int) -> torch.Tensor:
    """(NH, 2S - 1) f32: r_h[d + S - 1] = P[bucket(d), h] for the offsets
    d = j - i of S tokens, the ungated bias every layer reads."""
    table = params["rel_bias"]
    index = _bucket_index(S, config.num_buckets, config.max_distance,
                          table.device)
    return table.float()[index].t().contiguous()


def fused_trunk() -> bool:
    """Whether the blocks take `ops.epilogue`'s passes (`post_residual_
    layer_norm`, `relpos_gates`: their kernels on the card, their plain
    versions on the CPU): when autograd records nothing (`torch.no_grad`,
    `torch.inference_mode`). A recorded forward keeps the composition,
    which autograd differentiates."""
    return not torch.is_grad_enabled()


def relpos_gates(q: torch.Tensor, lp: Params,
                 config: BEATsConfig) -> torch.Tensor:
    """(B, NH, S) f32 gates of one layer from its projected q (B, S, H)
    (bias included, unscaled): (a, b) = sigmoid of the sums over groups of
    four of `grep_linear(q_h)`, g = a (b grep_a_h - 1) + 2; one pass over
    q where `fused_trunk()` holds."""
    gates = (epi.relpos_gates if fused_trunk()
             else epi.relpos_gates_reference)
    return gates(q, lp["grep"]["kernel"].float(), lp["grep"]["bias"].float(),
                 lp["grep_a"].float(), config.encoder_attention_heads)


def _linear(x, p):
    """x W + b with the bias added inside the product, in x's dtype."""
    return nnf.linear(x, p["kernel"].to(x.dtype).t(), p["bias"].to(x.dtype))


def _attention(x, lp, rel, config: BEATsConfig, impl: str):
    NH = config.encoder_attention_heads
    q = _linear(x, lp["q"])
    k = _linear(x, lp["k"])
    v = _linear(x, lp["v"])
    with span("beats.relpos"):
        gate = relpos_gates(q, lp, config)
    with span("beats.attention"):
        if impl == "kernel":
            ctx = attn_ops.mha_packed_relpos(q, k, v, gate, rel, num_heads=NH)
        else:
            ctx = attn_ops.mha_packed_relpos_reference(q, k, v, gate, rel,
                                                       NH)
    return _linear(ctx, lp["attn_out"])


def _block(x, lp, rel, config: BEATsConfig, impl: str):
    """One post-LN DeepNorm block: x = LN(alpha x + f(x)) after the
    attention and after the feed-forward, the sums in the compute dtype;
    each sum and LayerNorm one pass where `fused_trunk()` holds."""
    eps, alpha = config.layer_norm_eps, config.deep_norm_alpha
    norm = (epi.post_residual_layer_norm if fused_trunk()
            else epi.post_residual_layer_norm_reference)

    def post_ln(p, x, ln):
        return norm(p, x, ln["scale"].float(), ln["bias"].float(), eps, alpha)

    x = post_ln(_attention(x, lp, rel, config, impl), x, lp["ln1"])
    h = nnf.gelu(_linear(x, lp["fc1"]), approximate="none")
    return post_ln(_linear(h, lp["fc2"]), x, lp["ln2"])


def position_conv(x: torch.Tensor, conv: Params,
                  config: BEATsConfig) -> torch.Tensor:
    """(B, S, H) tokens -> (B, S, H) f32: the grouped position convolution
    (kernel K, padding K // 2, its last output dropped: `SamePad`), as a
    product of Fourier transforms in f32. Each group's product is, at each
    frequency, a (B, C) x (C, C) complex matrix product; the transforms are
    K + S - 1 long at least, so the circular convolution is the linear one.
    On an H100 at (128, 512, 768) it takes 3.8 ms where cuDNN's grouped
    bf16 convolution took 48.5 ms."""
    B, S, H = x.shape
    G, K = config.conv_pos_groups, config.conv_pos
    C = H // G
    n = 1 << (S + K - 2).bit_length()  # a power of two >= S + K - 1
    f = n // 2 + 1
    xf = torch.fft.rfft(x.float().transpose(1, 2), n=n)  # (B, H, f)
    # correlation, as the convolution takes it, is the flipped kernel's
    # convolution
    wf = torch.fft.rfft(conv["kernel"].float().flip(-1), n=n)  # (H, C, f)
    y = torch.matmul(xf.view(B, G, C, f).permute(1, 3, 0, 2),
                     wf.view(G, C, C, f).permute(0, 3, 2, 1))  # (G, f, B, C)
    y = torch.fft.irfft(y.permute(2, 0, 3, 1).reshape(B, H, f), n=n)
    start = K - 1 - K // 2
    return y[..., start: start + S].transpose(1, 2) + conv["bias"].float()


def embed(params: Params, feats: torch.Tensor, config: BEATsConfig,
          dtype=torch.float32) -> torch.Tensor:
    """(B, max_length, mel) features -> the tokens before the first block
    (B, S, H): the patch convolution flattened time-major, its LayerNorm
    and projection, the convolutional position embedding
    (`position_conv`, in f32) and its LayerNorm."""
    eps, p = config.layer_norm_eps, config.input_patch_size
    with span("beats.embed"):
        x = feats.to(dtype).unsqueeze(1)  # (B, 1, time, mel)
        x = nnf.conv2d(x, params["patch_embed"]["kernel"].to(dtype),
                       stride=p)  # (B, E, time / p, mel / p)
        x = x.flatten(2).transpose(1, 2)  # token t * (mel / p) + f
        x = _layer_norm(x, params["ln_patch"]["scale"],
                        params["ln_patch"]["bias"], eps)
        x = _linear(x, params["proj"])
        c = position_conv(x, params["pos_conv"], config)
        x = x + nnf.gelu(c, approximate="none").to(dtype)
        return _layer_norm(x, params["ln_pos"]["scale"],
                           params["ln_pos"]["bias"], eps)


def encode(params: Params, feats: torch.Tensor, config: BEATsConfig, *,
           dtype=torch.float32, attention_impl: str = "torch") -> torch.Tensor:
    """The trunk: features -> the last block's hidden states (B, S, H)."""
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, "
                         f"got {attention_impl!r}")
    with full_f32():
        x = embed(params, feats, config, dtype)
        with span("beats.relpos"):
            rel = relpos_vector(params, config, x.shape[1])
        enc = params["encoder"]
        for layer in range(config.encoder_layers):
            lp = {name: ({key: leaf[layer] for key, leaf in group.items()}
                         if isinstance(group, dict) else group[layer])
                  for name, group in enc.items()}
            x = _block(x, lp, rel, config, attention_impl)
        return x


def pool(hidden: torch.Tensor) -> torch.Tensor:
    """The mean over tokens, in f32: the predictor is linear, so its mean
    over tokens is its value at this mean."""
    return hidden.float().mean(dim=1)


def classify(params: Params, pooled: torch.Tensor,
             config: BEATsConfig) -> torch.Tensor:
    """The predictor on the pooled tokens; logits in f32."""
    head = params["head"]["dense"]
    with full_f32():
        logits = torch.matmul(pooled.float(), head["kernel"].float())
    return logits + head["bias"].float()


def forward(params: Params, feats: torch.Tensor, config: BEATsConfig, *,
            dtype=torch.float32,
            attention_impl: str = "torch") -> torch.Tensor:
    """(B, max_length, num_mel_bins) normalised features -> (B, num_labels)
    f32 logits, the mean over tokens of BEATs's predictor."""
    hidden = encode(params, feats, config, dtype=dtype,
                    attention_impl=attention_impl)
    return classify(params, pool(hidden), config)
