"""Polyphase sinc resampler, numerically matching `torchaudio.functional.resample`.

The port of the JAX package's `ops/resample.py`: the host (numpy)
`resample`, which the audio loader's Python path uses, and
`resample_torch`, the device counterpart of `resample_jax`.

The reference resamples every recording to 16 kHz through torchaudio's C++
polyphase kernel (src/test_long_audio_windows_2stage.py:57-58,
utils/analyze_ROC_PR_stage1.py:144-153). This re-implements the same filter
design (sinc_interp_hann, lowpass_filter_width=6, rolloff=0.99, float64
kernel construction) so resampled waveforms — and therefore fbank features
and logits — agree with the reference pipeline.

The compute is expressed as a polyphase gather + matmul: for reduced rates
L (up) / M (down), each output phase p ∈ [0, L) is an FIR dot product against
a fixed kernel row, so the whole resample is `frames @ kernels.T`. On the
device that product is one strided `conv1d` (torchaudio's own formulation),
which never materializes the overlapping frames.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as nnf

from ..utils.precision import full_f32

# WAV-header sanity bound (audio/io.py): no real container rate exceeds
# 1 MHz. NOT enforced on resample() itself — augmentation's pitch shift
# passes fictitious rates like 1536000->1232000 that REDUCE to tiny
# ratios (96:77); the actual kernel cost is bounded separately below.
MAX_SAMPLE_RATE = 1_000_000
# polyphase kernel table is ~ up * (2*ceil(6*down/rolloff) + down) doubles
# AFTER gcd reduction; real rate pairs reduce small (44100->16000 is
# ~0.9e6 elements) while a corrupt u32 header rate reduces huge (~2e9
# down). 16e6 elements (~128 MB f64) admits every real case and rejects
# the swap-hang class.
_MAX_KERNEL_ELEMENTS = 16_000_000


def _check_kernel_cost(up: int, down: int, lowpass_filter_width: int,
                       rolloff: float) -> None:
    width_est = math.ceil(lowpass_filter_width * down / rolloff)
    if up * (2 * width_est + down) > _MAX_KERNEL_ELEMENTS:
        raise ValueError(
            f"resample ratio {up}/{down} needs a polyphase kernel table of "
            f"~{up * (2 * width_est + down):,} doubles (> "
            f"{_MAX_KERNEL_ELEMENTS:,}); refusing — this is the corrupt-"
            f"header swap-hang class, not a real audio rate pair")


@functools.lru_cache(maxsize=32)
def _design_kernel(orig_freq: int, new_freq: int,
                   lowpass_filter_width: int = 6,
                   rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """(kernels (new_freq, kernel_width), width) in float64.

    Mirrors torchaudio `_get_sinc_resample_kernel` with
    resampling_method="sinc_interp_hann": kernel row p is the lowpass sinc
    evaluated at t = (idx - p/new_freq) * base_freq with a raised-cosine
    window, scaled by base_freq/orig_freq.
    """
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)

    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    phases = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq
    t = (phases + idx[None, :]) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t = t * np.pi
    kernels = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernels = kernels * window * (base_freq / orig_freq)
    return kernels, width


def _target_length(n: int, orig_freq: int, new_freq: int) -> int:
    return int(math.ceil(new_freq * n / orig_freq))


def resample(waveform: np.ndarray, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> np.ndarray:
    """Host resample of a (..., time) float array; returns float32.

    Identical math to `torchaudio.functional.resample` defaults.
    """
    if orig_freq < 1 or new_freq < 1:
        # e.g. an unfinalized recorder header with sample_rate=0: fail with
        # a typed error, not a ZeroDivisionError inside the kernel design
        raise ValueError(
            f"invalid resample rates {orig_freq} -> {new_freq}")
    if orig_freq == new_freq:
        return np.asarray(waveform, dtype=np.float32)
    g = math.gcd(int(orig_freq), int(new_freq))
    up, down = int(new_freq) // g, int(orig_freq) // g
    _check_kernel_cost(up, down, lowpass_filter_width, rolloff)

    kernels, width = _design_kernel(down, up, lowpass_filter_width, rolloff)
    x = np.asarray(waveform, dtype=np.float64)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    n = shape[-1]

    # pad like torchaudio: (width, width + down)
    xp = np.pad(x2, [(0, 0), (width, width + down)])
    # strided frames: output block i uses xp[:, i*down : i*down + kw]
    kw = kernels.shape[1]
    num_blocks = (xp.shape[1] - kw) // down + 1
    s = xp.strides
    frames = np.lib.stride_tricks.as_strided(
        xp, shape=(x2.shape[0], num_blocks, kw),
        strides=(s[0], s[1] * down, s[1]))
    # (B, num_blocks, kw) @ (kw, up) -> (B, num_blocks, up) -> interleave
    out = np.einsum("bnk,pk->bnp", frames, kernels)
    out = out.reshape(x2.shape[0], -1)[:, : _target_length(n, down, up)]
    return out.reshape(shape[:-1] + (out.shape[-1],)).astype(np.float32)


def resample_torch(waveform, orig_freq: int, new_freq: int,
                   lowpass_filter_width: int = 6, rolloff: float = 0.99, *,
                   device=None) -> torch.Tensor:
    """Device resample of a (..., time) array or tensor; returns float32 on
    `device` (None: the tensor's own device, CUDA for anything else).

    The same filter as `resample` (the float64 table of `_design_kernel`,
    cast to f32 on the device), the same pad and output length as the JAX
    package's `resample_jax`. The JAX function gathers (blocks, kernel
    width) frames and multiplies; here the product is one `conv1d` with
    stride `down`, whose (B, up, blocks) output interleaves to the same
    samples, and which for 600 s at 48 kHz avoids 1.6 GB of frames for a
    38 MB result. The convolution runs inside `full_f32()`: cuDNN's TF32
    default is three digits short of the golden's 2e-5."""
    if orig_freq < 1 or new_freq < 1:
        raise ValueError(
            f"invalid resample rates {orig_freq} -> {new_freq}")
    if device is None and isinstance(waveform, torch.Tensor):
        device = waveform.device
    else:
        from ..infer.cascade import resolve_device

        device = resolve_device(device)
    x = torch.as_tensor(waveform).to(device=device, dtype=torch.float32)
    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    up, down = int(new_freq) // g, int(orig_freq) // g
    _check_kernel_cost(up, down, lowpass_filter_width, rolloff)
    kernels_np, width = _design_kernel(down, up, lowpass_filter_width, rolloff)
    kernels = torch.from_numpy(kernels_np).to(device).float()

    n = x.shape[-1]
    batch_shape = x.shape[:-1]
    xp = nnf.pad(x.reshape(-1, n), (width, width + down))
    with full_f32():
        out = nnf.conv1d(xp[:, None], kernels[:, None, :], stride=down)
    out = out.transpose(1, 2).reshape(xp.shape[0], -1)
    out = out[:, : _target_length(n, down, up)]
    return out.reshape(*batch_shape, out.shape[-1])
