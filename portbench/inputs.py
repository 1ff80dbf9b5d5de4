"""What a run feeds the program and the reference alike, made from the seed.

Weights are drawn on the device by a `torch.Generator`, one draw per
model, and cut into leaves; audio is drawn on the device and brought to
the host as the int16 PCM a recording holds. A seed gives the same
inputs on every run; sub-streams are keyed by a name. A classifier head is
then calibrated on the reference (`calibrate_head`), as chip_smoke.py's
gate calibration designed it.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch


def substream(seed: int, name: str) -> int:
    """A 63-bit seed for the stream `name` of run seed `seed`."""
    ss = np.random.SeedSequence([seed % 2**64, zlib.crc32(name.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(substream(seed, name))
    return gen


def leaf_shapes(config: dict) -> dict:
    """The weights' layout, as the program and the reference read them:
    dense kernels (in, out) stacked over layers, the patch kernel
    (H, 1, p, p)."""
    H, I = config["hidden_size"], config["intermediate_size"]
    L, p, n = (config["num_hidden_layers"], config["patch_size"],
               config["num_labels"])
    F = (config["num_mel_bins"] - p) // config["frequency_stride"] + 1
    T = (config["max_length"] - p) // config["time_stride"] + 1

    def dense(i, o, layers=(L,)):
        return {"kernel": (*layers, i, o), "bias": (*layers, o)}

    def ln(layers=(L,)):
        return {"scale": (*layers, H), "bias": (*layers, H)}

    return {
        "patch_embed": {"kernel": (H, 1, p, p), "bias": (H,)},
        "cls_token": (1, 1, H),
        "dist_token": (1, 1, H),
        "pos_embed": (1, F * T + 2, H),
        "encoder": {"ln1": ln(), "q": dense(H, H), "k": dense(H, H),
                    "v": dense(H, H), "attn_out": dense(H, H), "ln2": ln(),
                    "fc1": dense(H, I), "fc2": dense(I, H)},
        "ln_final": ln(()),
        "head": {"ln": ln(()), "dense": dense(H, n, ())},
    }


def weights(config: dict, seed: int, name: str, device) -> dict:
    """Float32 weights: every leaf normal with std `initializer_range`,
    LayerNorm scales 1 plus such a draw, all from one draw on the device."""
    shapes = leaf_shapes(config)
    flat = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat.append((path + (k,), v))

    walk(shapes, ())
    sizes = [int(np.prod(s)) for _, s in flat]
    buf = torch.randn(sum(sizes), generator=generator(seed, name, device),
                      device=device)
    buf.mul_(config["initializer_range"])
    out: dict = {}
    for (path, shape), part in zip(flat, torch.split(buf, sizes)):
        leaf = part.view(shape)
        if path[-1] == "scale":
            leaf.add_(1.0)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def audio(lengths_s, mix: dict, seed: int, name: str, device,
          stds=None) -> list[np.ndarray]:
    """int16 PCM at the mix's rate, one recording per length: noise of std
    `noise_std` full scale (or the recording's entry of `stds`),
    amplitude-modulated at `am_hz`."""
    gen = generator(seed, name, device)
    rate = mix["sample_rate"]
    stds = [mix["noise_std"]] * len(lengths_s) if stds is None else stds
    out = []
    for seconds, std in zip(lengths_s, stds):
        n = int(round(seconds * rate))
        t = torch.arange(n, device=device, dtype=torch.float64) / rate
        env = 1.0 + torch.sin(2 * np.pi * mix["am_hz"] * t)
        x = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
        x = (std * 32768.0) * x * env
        out.append(x.clamp(-32768, 32767).to(torch.int16).cpu().numpy())
    return out


def calibrate_head(pooled: torch.Tensor, head_ln: dict, eps: float,
                   rate: float, band: float, spread: float) -> dict:
    """A head whose class-1 margin reads the first principal direction of
    the windows' pooled features after the head's LayerNorm, scaled to a
    standard deviation of `spread` logits, with its zero in the widest gap
    between the windows' margins among the cuts that pass rate +- band of
    them. Class 0's logit is 0, so the 0.5 threshold is the argmax's."""
    h = pooled.double()
    z = torch.nn.functional.layer_norm(h, (h.shape[1],), eps=eps)
    z = z * head_ln["scale"].double() + head_ln["bias"].double()
    v = torch.linalg.svd(z - z.mean(0), full_matrices=False)[2][0]
    proj = z @ v
    scale = spread / float(proj.std())
    desc = torch.sort(scale * proj, descending=True)[0].cpu().numpy()
    W = len(desc)
    k = max(range(max(1, math.ceil((rate - band) * W)),
                  min(W - 1, math.floor((rate + band) * W)) + 1),
            key=lambda k: desc[k - 1] - desc[k])
    kernel = torch.zeros(z.shape[1], 2, dtype=torch.float64, device=z.device)
    kernel[:, 1] = scale * v
    bias = torch.tensor([0.0, -0.5 * float(desc[k - 1] + desc[k])],
                        dtype=torch.float64, device=z.device)
    return {"kernel": kernel.float(), "bias": bias.float()}
