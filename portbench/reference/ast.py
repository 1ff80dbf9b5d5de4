"""The Audio Spectrogram Transformer's forward, plain float32.

`ASTForAudioClassification` as published: a 16 x 16 convolution with
strides (10, 10) over the (mel, time) plane, patches laid out frequency
first, CLS and distillation tokens, learned positions, pre-LN blocks with
exact-erf GELU, a final LayerNorm, the mean of the CLS and distillation
outputs, and a LayerNorm and linear head. The weights are a nested dict:
dense kernels (in, out) stacked over layers on a leading axis, the patch
kernel (H, 1, p, p).

`quant="fp8"` rounds both operands of every product to float8 e4m3 with
one scale per tensor (largest magnitude to 448) before the float32
product: the precision below bfloat16 that a control computes in. Its
gradient passes the rounding straight through.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as nnf

FP8_MAX = 448.0


@contextlib.contextmanager
def true_f32():
    """TF32 off for products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round(x: torch.Tensor, quant: str | None) -> torch.Tensor:
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown quantisation {quant!r}")
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def _mm(a, b, quant):
    return torch.matmul(_round(a, quant), _round(b, quant))


def _ln(x, p, eps):
    return nnf.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _layer(params: dict, i: int) -> dict:
    return {name: {k: v[i] for k, v in group.items()}
            for name, group in params["encoder"].items()}


def forward(params: dict, feats: torch.Tensor, config: dict,
            quant: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, max_length, mel) normalised features -> (logits (B, labels),
    pooled (B, H)), both float32."""
    H = config["hidden_size"]
    NH = config["num_attention_heads"]
    eps = config["layer_norm_eps"]
    B = feats.shape[0]
    with true_f32():
        x = feats.float().transpose(1, 2).unsqueeze(1)  # (B, 1, mel, time)
        k = params["patch_embed"]["kernel"]
        x = nnf.conv2d(_round(x, quant), _round(k, quant),
                       params["patch_embed"]["bias"],
                       stride=(config["frequency_stride"],
                               config["time_stride"]))
        x = x.flatten(2).transpose(1, 2)  # (B, F * T, H), frequency first
        x = torch.cat([params["cls_token"].expand(B, 1, H),
                       params["dist_token"].expand(B, 1, H), x], 1)
        x = x + params["pos_embed"]
        S = x.shape[1]
        for i in range(config["num_hidden_layers"]):
            lp = _layer(params, i)

            def dense(h, name):
                return _mm(h, lp[name]["kernel"], quant) + lp[name]["bias"]

            h = _ln(x, lp["ln1"], eps)
            q, kk, v = (dense(h, n).view(B, S, NH, H // NH).transpose(1, 2)
                        for n in ("q", "k", "v"))
            scores = _mm(q, kk.transpose(-1, -2), quant) / math.sqrt(H // NH)
            ctx = _mm(torch.softmax(scores, -1), v, quant)
            del scores
            x = x + dense(ctx.transpose(1, 2).reshape(B, S, H), "attn_out")
            h = _ln(x, lp["ln2"], eps)
            h = nnf.gelu(dense(h, "fc1"))
            x = x + dense(h, "fc2")
        x = _ln(x, params["ln_final"], eps)
        pooled = (x[:, 0] + x[:, 1]) / 2
        h = _ln(pooled, params["head"]["ln"], eps)
        logits = h @ params["head"]["dense"]["kernel"] \
            + params["head"]["dense"]["bias"]
    return logits, pooled


def rows_within(config: dict, budget: int) -> int:
    """Windows a block may hold so that one layer's float32 scores take at
    most `budget` bytes."""
    S = ((config["num_mel_bins"] - config["patch_size"])
         // config["frequency_stride"] + 1) * (
        (config["max_length"] - config["patch_size"])
        // config["time_stride"] + 1) + 2
    return max(1, budget // (4 * config["num_attention_heads"] * S * S))

