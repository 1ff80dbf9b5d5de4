"""BEATs (iter3+, AS2M) forward and its front end, plain float32.

Written from the public code (`BEATs.py`, `backbone.py` of
github.com/microsoft/unilm/tree/master/beats) and arXiv:2212.09058:

- front end: `torchaudio.compliance.kaldi.fbank` with Kaldi's defaults on
  the PCM values (2^15 times [-1, 1] audio): 25 ms frames every 10 ms (snip
  edges), each frame's mean removed, pre-emphasis 0.97, the povey window
  (the symmetric Hann window to the power 0.85), the power spectrum of a
  512-point FFT, 128 triangles on Kaldi's mel scale from 20 Hz to Nyquist
  (`fbank.mel_bank`), the log above float32's epsilon; the frames padded
  with zeros to the window's length and normalised as (x - mean) /
  (2 std), pad rows included, as the study pads windows for the AST;
- trunk: a 16 x 16 convolution with stride 16 and no bias over the (time,
  mel) plane, flattened time first; LayerNorm(512) and Linear(512 -> 768);
  x + GELU of the grouped position convolution (its last output dropped);
  LayerNorm; 12 post-LN blocks x = LN(alpha x + Attn(x)),
  x = LN(alpha x + FC2(GELU(FC1(x)))), alpha = (2 L)^(1/4);
- attention: scores q k^T / sqrt(D) plus g P[bucket(j - i)], P the
  (buckets, heads) table every layer reads, bucket the T5 bidirectional
  bucket, g = a (b grep_a - 1) + 2 with (a, b) the sigmoid of the sums over
  groups of four of `grep_linear` of the unscaled projected q; the bias is
  materialised (B, NH, S, S) for a block of rows;
- head: the predictor on the mean over tokens.

The weights are a nested dict: dense kernels (in, out) stacked over layers
on a leading axis, the patch kernel (512, 1, 16, 16), the position kernel
(768, 48, 128) with its weight norm folded, the predictor under
`head.dense`. `quant="fp8"` rounds both operands of every product through
float8 e4m3 as `ast.forward` does. Every product runs with TF32 off. It
imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as nnf

from . import fbank as ref_fbank
from .ast import _round, true_f32

POVEY_POWER = 0.85


def logmel(pcm: torch.Tensor) -> torch.Tensor:
    """(..., samples) PCM values (2^15 times [-1, 1] audio) ->
    (..., frames, MEL_BINS), Kaldi's fbank with the povey window."""
    frames = pcm.unfold(-1, ref_fbank.FRAME, ref_fbank.HOP).double()
    frames = frames - frames.mean(-1, keepdim=True)
    pre = ref_fbank.PREEMPH
    frames = torch.cat([frames[..., :1] * (1 - pre),
                        frames[..., 1:] - pre * frames[..., :-1]], -1)
    n = torch.arange(ref_fbank.FRAME, dtype=torch.float64, device=pcm.device)
    hann = 0.5 - 0.5 * torch.cos(2 * np.pi * n / (ref_fbank.FRAME - 1))
    frames = frames * hann ** POVEY_POWER
    power = torch.fft.rfft(frames.float(), n=ref_fbank.FFT).abs() ** 2
    bank = torch.as_tensor(ref_fbank.mel_bank(), dtype=torch.float32,
                           device=pcm.device)
    with true_f32():
        return torch.log(torch.clamp_min(power @ bank, ref_fbank.FLOOR))


def window_features(pcm: np.ndarray, starts: np.ndarray, window: int,
                    max_length: int, mean: float, std: float,
                    device) -> torch.Tensor:
    """(len(starts), max_length, MEL_BINS) normalised features of the int16
    windows pcm[s : s + window], each featurised from its own samples."""
    idx = starts[:, None] + np.arange(window)[None, :]
    feats = logmel(torch.as_tensor(pcm[idx], device=device).float())
    feats = nnf.pad(feats, (0, 0, 0, max_length - feats.shape[-2]))
    return (feats - mean) / (2.0 * std)


def bucket(relative: torch.Tensor, num_buckets: int,
           max_distance: int) -> torch.Tensor:
    """`_relative_positions_bucket(relative, bidirectional=True)`."""
    num_buckets //= 2
    out = (relative > 0).long() * num_buckets
    relative = relative.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(relative.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = torch.minimum(large, torch.full_like(large, num_buckets - 1))
    return out + torch.where(relative < max_exact, relative, large)


def _ln(x, p, eps):
    return nnf.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _layer(params: dict, i: int) -> dict:
    return {name: ({k: v[i] for k, v in group.items()}
                   if isinstance(group, dict) else group[i])
            for name, group in params["encoder"].items()}


def alpha(config: dict) -> float:
    return (2 * config["encoder_layers"]) ** 0.25 if config["deep_norm"] \
        else 1.0


def forward(params: dict, feats: torch.Tensor, config: dict,
            quant: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, max_length, mel) normalised features -> (logits (B, labels),
    pooled (B, H)), both float32."""
    H = config["encoder_embed_dim"]
    NH = config["encoder_attention_heads"]
    D = H // NH
    eps = config["layer_norm_eps"]
    p = config["input_patch_size"]
    K = config["conv_pos"]
    a = alpha(config)
    B = feats.shape[0]

    def mm(x, w):
        return torch.matmul(_round(x, quant), _round(w, quant))

    with true_f32():
        x = feats.float().unsqueeze(1)  # (B, 1, time, mel)
        x = nnf.conv2d(_round(x, quant),
                       _round(params["patch_embed"]["kernel"], quant),
                       stride=p)
        x = x.reshape(B, x.shape[1], -1).transpose(1, 2)  # time-major
        x = _ln(x, params["ln_patch"], eps)
        x = mm(x, params["proj"]["kernel"]) + params["proj"]["bias"]
        conv = nnf.conv1d(_round(x.transpose(1, 2), quant),
                          _round(params["pos_conv"]["kernel"], quant),
                          params["pos_conv"]["bias"], padding=K // 2,
                          groups=config["conv_pos_groups"])[..., :-1]
        x = x + nnf.gelu(conv).transpose(1, 2)
        x = _ln(x, params["ln_pos"], eps)
        S = x.shape[1]
        pos = torch.arange(S, device=x.device)
        buckets = bucket(pos[None, :] - pos[:, None], config["num_buckets"],
                         config["max_distance"])
        position_bias = params["rel_bias"][buckets].permute(2, 0, 1)
        for i in range(config["encoder_layers"]):
            lp = _layer(params, i)

            def dense(h, name):
                return mm(h, lp[name]["kernel"]) + lp[name]["bias"]

            q, k, v = (dense(x, n).view(B, S, NH, D).transpose(1, 2)
                       for n in ("q", "k", "v"))
            g = torch.sigmoid((mm(q, lp["grep"]["kernel"])
                               + lp["grep"]["bias"]).view(B, NH, S, 2, 4)
                              .sum(-1))
            gate = g[..., 0] * (g[..., 1] * lp["grep_a"].view(NH, 1)
                                - 1.0) + 2.0
            scores = mm(q, k.transpose(-1, -2)) / math.sqrt(D)
            scores = scores + gate[..., None] * position_bias
            ctx = mm(torch.softmax(scores, -1), v)
            del scores
            attn = dense(ctx.transpose(1, 2).reshape(B, S, H), "attn_out")
            x = _ln(a * x + attn, lp["ln1"], eps)
            h = nnf.gelu(dense(x, "fc1"))
            x = _ln(a * x + dense(h, "fc2"), lp["ln2"], eps)
        pooled = x.mean(1)
        logits = pooled @ params["head"]["dense"]["kernel"] \
            + params["head"]["dense"]["bias"]
    return logits, pooled


def rows_within(config: dict, budget: int) -> int:
    """Windows a block may hold so that one layer's float32 scores take at
    most `budget` bytes."""
    p = config["input_patch_size"]
    S = (config["max_length"] // p) * (config["num_mel_bins"] // p)
    return max(1, budget // (4 * config["encoder_attention_heads"] * S * S))
