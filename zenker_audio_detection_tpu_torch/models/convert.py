"""HF checkpoint <-> port parameter conversion, and the JAX pytree bridge.

Port of the JAX package's `models/convert.py`. It loads the reference's HF
model directories (config.json + model.safetensors or pytorch_model.bin)
into the port's parameters and exports them back, so trained artifacts
interoperate with HF and with the JAX package in both directions.

Layout mapping (HF torch -> the JAX package's pytree):
  * `nn.Linear.weight` is (out, in) -> kernel (in, out): transpose.
  * `nn.Conv2d.weight` is (O, I, kH, kW) -> HWIO (kH, kW, I, O).
  * Per-layer tensors `encoder.layer.{i}.*` are stacked on a leading layer
    axis.
The port's parameters are that pytree with torch leaves, except the patch
kernel, which is OIHW again for `conv2d`: `params_from_jax` and
`params_to_numpy` are the one place that decision lives.

int8 model directories are the JAX package's format: `model_int8.safetensors`
holds the quantized JAX pytree (`models.ast.quantize_params`) flattened to
dotted keys, int8 kernels as I8, and `config.json` carries a
`"zenker_int8": true` marker. A directory written by either package loads
in the other.
"""

from __future__ import annotations

import json
import math
import os
import struct
import threading
from typing import Any, Mapping

import numpy as np
import torch

from ..utils.fsio import load_json_object
from .ast import ASTConfig, Params, quantize_params

_PREFIX = "audio_spectrogram_transformer."
_INT8_FILE = "model_int8.safetensors"


# --------------------------------------------------------------------------
# Minimal safetensors reader/writer (numpy-only; format is a public spec:
# 8-byte little-endian header length + JSON header + raw buffer).
# --------------------------------------------------------------------------
_STR_TO_DTYPE = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_DTYPE_TO_STR = {np.dtype(v): k for k, v in _STR_TO_DTYPE.items()}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        prefix = f.read(8)
        if len(prefix) < 8:
            raise ValueError(f"corrupt safetensors file {path!r}: "
                             f"{file_size} bytes, need >= 8 for the header length")
        header_len = struct.unpack("<Q", prefix)[0]
        # Validate BEFORE f.read(header_len): CPython preallocates the
        # requested size, so a corrupt u64 here (e.g. 2**62) would try a
        # multi-TB allocation — MemoryError at best, a swap-hang on an
        # overcommitting kernel at worst (same failure class as the WAV
        # sample-rate fuzz finding; see ops/resample._check_kernel_cost).
        if header_len > file_size - 8:
            raise ValueError(
                f"corrupt safetensors file {path!r}: declared header length "
                f"{header_len} exceeds the {file_size - 8} bytes present")
        header = json.loads(f.read(header_len))
        buf = f.read()
    if not isinstance(header, dict):
        raise ValueError(f"corrupt safetensors file {path!r}: header is "
                         f"{type(header).__name__}, expected a JSON object")
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype_str = meta["dtype"]
            shape = [int(d) for d in meta["shape"]]
            start, end = (int(o) for o in meta["data_offsets"])
        except (TypeError, KeyError, IndexError, ValueError) as e:
            raise ValueError(f"corrupt safetensors entry {name!r} in "
                             f"{path!r}: {e!r}") from e
        if any(d < 0 for d in shape):
            raise ValueError(f"corrupt safetensors entry {name!r} in "
                             f"{path!r}: negative shape {shape}")
        if not (0 <= start <= end <= len(buf)):
            raise ValueError(
                f"corrupt safetensors entry {name!r} in {path!r}: "
                f"data_offsets [{start}, {end}) outside the "
                f"{len(buf)}-byte buffer")
        if dtype_str == "BF16":
            if (end - start) % 2:
                raise ValueError(
                    f"corrupt safetensors entry {name!r} in {path!r}: "
                    f"{end - start} bytes is not a whole number of "
                    f"BF16 elements")
            raw = np.frombuffer(buf[start:end], dtype=np.uint16)
            arr = (raw.astype(np.uint32) << 16).view(np.float32).astype(np.float32)
        else:
            if dtype_str not in _STR_TO_DTYPE:
                raise ValueError(f"unsupported safetensors dtype "
                                 f"{dtype_str!r} for entry {name!r} in {path!r}")
            dtype = _STR_TO_DTYPE[dtype_str]
            if (end - start) % np.dtype(dtype).itemsize:
                raise ValueError(
                    f"corrupt safetensors entry {name!r} in {path!r}: "
                    f"{end - start} bytes is not a whole number of "
                    f"{dtype_str} elements")
            arr = np.frombuffer(buf[start:end], dtype=dtype)
        try:
            out[name] = arr.reshape(shape).copy()
        except ValueError as e:
            raise ValueError(f"corrupt safetensors entry {name!r} in "
                             f"{path!r}: {e}") from e
    return out


def write_safetensors(tensors: Mapping[str, np.ndarray], path: str) -> None:
    header: dict[str, Any] = {}
    offset = 0
    blobs = []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        blob = arr.tobytes()
        header[name] = {
            "dtype": _DTYPE_TO_STR[arr.dtype],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(blob)],
        }
        offset += len(blob)
        blobs.append(blob)
    hjson = json.dumps(header).encode()
    # Write-then-rename so a crash mid-write never leaves a truncated file
    # under the final name: checkpoints, model exports and best_params all
    # overwrite in place, and a half-written safetensors would otherwise
    # destroy the previous good version along with the current one. The
    # tmp lives in the same directory so os.replace stays a same-filesystem
    # atomic rename (process-crash consistency; power-loss durability would
    # need fsync, which the reference's writers don't do either).
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(hjson)))
            f.write(hjson)
            for blob in blobs:
                f.write(blob)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


# --------------------------------------------------------------------------
# HF config.json
# --------------------------------------------------------------------------


_INT_CONFIG_FIELDS = ("hidden_size", "num_hidden_layers",
                      "num_attention_heads", "intermediate_size",
                      "patch_size", "frequency_stride", "time_stride",
                      "max_length", "num_mel_bins", "num_labels")
_FLOAT_CONFIG_FIELDS = ("layer_norm_eps", "initializer_range")


def config_from_hf_dict(d: Mapping[str, Any]) -> ASTConfig:
    """Build the ASTConfig from an HF config.json dict.

    Values are validated with errors naming the offending field: a
    hand-edited config.json with `"hidden_size": "big"` must fail here,
    not as a reshape/TypeError deep inside the forward pass."""
    for k in _INT_CONFIG_FIELDS:
        if k in d and (isinstance(d[k], bool) or not isinstance(d[k], int)
                       or d[k] <= 0):
            raise ValueError(f"model config field {k!r} must be a positive "
                             f"integer, got {d[k]!r}")
    for k in _FLOAT_CONFIG_FIELDS:
        # finite and positive: json.load accepts the non-standard
        # NaN/Infinity tokens, and a negative/zero layer_norm_eps would
        # surface as silent NaN logits deep inside the forward pass
        if k in d and (isinstance(d[k], bool)
                       or not isinstance(d[k], (int, float))
                       or not math.isfinite(d[k]) or d[k] <= 0):
            raise ValueError(f"model config field {k!r} must be a positive "
                             f"finite number, got {d[k]!r}")
    if "qkv_bias" in d and not isinstance(d["qkv_bias"], bool):
        raise ValueError(f"model config field 'qkv_bias' must be a bool, "
                         f"got {d['qkv_bias']!r}")
    if "id2label" in d and not isinstance(d["id2label"], Mapping):
        raise ValueError(f"model config field 'id2label' must be an object, "
                         f"got {type(d['id2label']).__name__}")
    n_labels = len(d.get("id2label", {})) or d.get("num_labels", 2)
    cfg = ASTConfig(
        hidden_size=d.get("hidden_size", 768),
        num_hidden_layers=d.get("num_hidden_layers", 12),
        num_attention_heads=d.get("num_attention_heads", 12),
        intermediate_size=d.get("intermediate_size", 3072),
        layer_norm_eps=d.get("layer_norm_eps", 1e-12),
        patch_size=d.get("patch_size", 16),
        frequency_stride=d.get("frequency_stride", 10),
        time_stride=d.get("time_stride", 10),
        max_length=d.get("max_length", 1024),
        num_mel_bins=d.get("num_mel_bins", 128),
        num_labels=n_labels,
        initializer_range=d.get("initializer_range", 0.02),
        qkv_bias=d.get("qkv_bias", True),
    )
    # structural constraints the forward pass depends on — catch them here
    # with a message instead of a reshape error inside the model
    if cfg.hidden_size % cfg.num_attention_heads != 0:
        raise ValueError(
            f"model config: hidden_size ({cfg.hidden_size}) must be "
            f"divisible by num_attention_heads ({cfg.num_attention_heads})")
    if cfg.patch_size > cfg.num_mel_bins or cfg.patch_size > cfg.max_length:
        raise ValueError(
            f"model config: patch_size ({cfg.patch_size}) exceeds "
            f"num_mel_bins ({cfg.num_mel_bins}) or max_length "
            f"({cfg.max_length})")
    return cfg


def _np(x) -> np.ndarray:
    """torch tensor or ndarray -> float32 numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


# --------------------------------------------------------------------------
# State-dict conversion in the JAX package's pytree layout
# --------------------------------------------------------------------------


def _jax_tree_from_hf(sd: Mapping[str, Any], config: ASTConfig) -> dict:
    """`ASTForAudioClassification` state dict -> the JAX package's pytree
    layout (numpy leaves)."""
    sd = {k: _np(v) for k, v in sd.items()}
    p = _PREFIX if any(k.startswith(_PREFIX) for k in sd) else ""
    L = config.num_hidden_layers

    def stack_dense(fmt: str) -> dict[str, np.ndarray]:
        return {
            "kernel": np.stack([sd[fmt.format(i) + ".weight"].T for i in range(L)]),
            "bias": np.stack([sd[fmt.format(i) + ".bias"] for i in range(L)]),
        }

    def stack_ln(fmt: str) -> dict[str, np.ndarray]:
        return {
            "scale": np.stack([sd[fmt.format(i) + ".weight"] for i in range(L)]),
            "bias": np.stack([sd[fmt.format(i) + ".bias"] for i in range(L)]),
        }

    lyr = p + "encoder.layer.{}."
    return {
        "patch_embed": {
            "kernel": sd[p + "embeddings.patch_embeddings.projection.weight"]
            .transpose(2, 3, 1, 0),
            "bias": sd[p + "embeddings.patch_embeddings.projection.bias"],
        },
        "cls_token": sd[p + "embeddings.cls_token"],
        "dist_token": sd[p + "embeddings.distillation_token"],
        "pos_embed": sd[p + "embeddings.position_embeddings"],
        "encoder": {
            "ln1": stack_ln(lyr + "layernorm_before"),
            "q": stack_dense(lyr + "attention.attention.query"),
            "k": stack_dense(lyr + "attention.attention.key"),
            "v": stack_dense(lyr + "attention.attention.value"),
            "attn_out": stack_dense(lyr + "attention.output.dense"),
            "ln2": stack_ln(lyr + "layernorm_after"),
            "fc1": stack_dense(lyr + "intermediate.dense"),
            "fc2": stack_dense(lyr + "output.dense"),
        },
        "ln_final": {
            "scale": sd[p + "layernorm.weight"],
            "bias": sd[p + "layernorm.bias"],
        },
        "head": {
            "ln": {
                "scale": sd["classifier.layernorm.weight"],
                "bias": sd["classifier.layernorm.bias"],
            },
            "dense": {
                "kernel": sd["classifier.dense.weight"].T,
                "bias": sd["classifier.dense.bias"],
            },
        },
    }


def _hf_from_jax_tree(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Inverse of `_jax_tree_from_hf` (float32 numpy tensors)."""
    enc = params["encoder"]
    if "kernel_int8" in enc.get("q", {}):
        # fail with intent instead of a bare KeyError('kernel') mid-export
        raise ValueError(
            "params are int8-quantized ({kernel_int8, scale} leaves); an HF "
            "f32 state dict cannot represent them — use save_int8_model_dir "
            "(or reload the f32 source checkpoint) instead")
    L = np.asarray(enc["ln1"]["scale"]).shape[0]
    sd: dict[str, np.ndarray] = {}
    p = _PREFIX

    sd[p + "embeddings.patch_embeddings.projection.weight"] = _np(
        params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd[p + "embeddings.patch_embeddings.projection.bias"] = _np(
        params["patch_embed"]["bias"])
    sd[p + "embeddings.cls_token"] = _np(params["cls_token"])
    sd[p + "embeddings.distillation_token"] = _np(params["dist_token"])
    sd[p + "embeddings.position_embeddings"] = _np(params["pos_embed"])

    dense_map = {
        "attention.attention.query": "q",
        "attention.attention.key": "k",
        "attention.attention.value": "v",
        "attention.output.dense": "attn_out",
        "intermediate.dense": "fc1",
        "output.dense": "fc2",
    }
    ln_map = {"layernorm_before": "ln1", "layernorm_after": "ln2"}
    for i in range(L):
        base = f"{p}encoder.layer.{i}."
        for hf_name, ours in dense_map.items():
            sd[base + hf_name + ".weight"] = _np(enc[ours]["kernel"][i]).T
            sd[base + hf_name + ".bias"] = _np(enc[ours]["bias"][i])
        for hf_name, ours in ln_map.items():
            sd[base + hf_name + ".weight"] = _np(enc[ours]["scale"][i])
            sd[base + hf_name + ".bias"] = _np(enc[ours]["bias"][i])

    sd[p + "layernorm.weight"] = _np(params["ln_final"]["scale"])
    sd[p + "layernorm.bias"] = _np(params["ln_final"]["bias"])
    sd["classifier.layernorm.weight"] = _np(params["head"]["ln"]["scale"])
    sd["classifier.layernorm.bias"] = _np(params["head"]["ln"]["bias"])
    sd["classifier.dense.weight"] = _np(params["head"]["dense"]["kernel"]).T
    sd["classifier.dense.bias"] = _np(params["head"]["dense"]["bias"])
    return sd


# --------------------------------------------------------------------------
# The JAX pytree <-> port parameters
# --------------------------------------------------------------------------


def params_from_jax(tree: Mapping[str, Any]) -> Params:
    """The JAX package's parameter pytree (numpy or array leaves, f32 or
    int8-quantized) -> the port's parameters: torch tensors on the CPU,
    same nesting and dtypes, with the patch kernel moved from HWIO to
    OIHW."""

    def walk(node):
        return {k: walk(v) if isinstance(v, Mapping)
                else torch.from_numpy(np.array(v)) for k, v in node.items()}

    params = walk(tree)
    params["patch_embed"]["kernel"] = (
        params["patch_embed"]["kernel"].permute(3, 2, 0, 1).contiguous())
    return params


def params_to_numpy(params: Params) -> dict:
    """Inverse of `params_from_jax`: the port's parameters -> the JAX
    package's pytree layout with numpy leaves in their stored dtype
    (patch kernel back to HWIO)."""

    def walk(node):
        return {k: walk(v) if isinstance(v, Mapping)
                else v.detach().cpu().numpy() for k, v in node.items()}

    tree = walk(params)
    tree["patch_embed"]["kernel"] = np.ascontiguousarray(
        tree["patch_embed"]["kernel"].transpose(2, 3, 1, 0))
    return tree


def from_hf_state_dict(sd: Mapping[str, Any], config: ASTConfig) -> Params:
    """Convert an `ASTForAudioClassification` state dict to port params."""
    return params_from_jax(_jax_tree_from_hf(sd, config))


def to_hf_state_dict(params: Params) -> dict[str, np.ndarray]:
    """Inverse of `from_hf_state_dict` (float32 numpy tensors)."""
    return _hf_from_jax_tree(params_to_numpy(params))


# --------------------------------------------------------------------------
# BEATs: the public `BEATs.py` state dict
# --------------------------------------------------------------------------


def fold_weight_norm(g, v) -> np.ndarray:
    """`nn.utils.weight_norm(conv, dim=2)`'s kernel g v / ||v||, the norm
    of v taken over every axis but the kernel's position axis (axis 2)."""
    g, v = _np(g).astype(np.float64), _np(v).astype(np.float64)
    norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
    return (g * v / norm).astype(np.float32)


def beats_params_from_state_dict(sd: Mapping[str, Any],
                                 config) -> Params:
    """The published BEATs checkpoint's `model` state dict (`BEATs.py`,
    `backbone.py` names) -> `models.beats` params: `nn.Linear` weights
    transposed to (in, out) and stacked over layers, the position
    convolution's weight norm folded (`fold_weight_norm`), layer 0's
    `relative_attention_bias` as the shared table, `grep_a` (1, NH, 1, 1)
    as (NH,) per layer, the `predictor` as `head.dense`. Keys the port
    does not read (other layers' views of the shared table) are ignored;
    a missing key raises KeyError."""

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(_np(x)))

    def linear(name):
        return {"kernel": _np(sd[f"{name}.weight"]).T,
                "bias": _np(sd[f"{name}.bias"])}

    def ln(name):
        return {"scale": _np(sd[f"{name}.weight"]),
                "bias": _np(sd[f"{name}.bias"])}

    layer_keys = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
                  "v": "self_attn.v_proj", "attn_out": "self_attn.out_proj",
                  "grep": "self_attn.grep_linear",
                  "ln1": "self_attn_layer_norm", "fc1": "fc1", "fc2": "fc2",
                  "ln2": "final_layer_norm"}
    layers = []
    for i in range(config.encoder_layers):
        pre = f"encoder.layers.{i}."
        layer = {name: (ln if name.startswith("ln") else linear)(pre + key)
                 for name, key in layer_keys.items()}
        layer["grep_a"] = _np(sd[pre + "self_attn.grep_a"]).reshape(-1)
        layers.append(layer)
    encoder = {name: ({k: t(np.stack([lay[name][k] for lay in layers]))
                       for k in layers[0][name]}
                      if isinstance(layers[0][name], dict)
                      else t(np.stack([lay[name] for lay in layers])))
               for name in layers[0]}
    proj, head = linear("post_extract_proj"), linear("predictor")
    return {
        "patch_embed": {"kernel": t(sd["patch_embedding.weight"])},
        "ln_patch": {k: t(x) for k, x in ln("layer_norm").items()},
        "proj": {k: t(x) for k, x in proj.items()},
        "pos_conv": {
            "kernel": t(fold_weight_norm(sd["encoder.pos_conv.0.weight_g"],
                                         sd["encoder.pos_conv.0.weight_v"])),
            "bias": t(sd["encoder.pos_conv.0.bias"])},
        "ln_pos": {k: t(x) for k, x in ln("encoder.layer_norm").items()},
        "rel_bias": t(sd["encoder.layers.0.self_attn.relative_attention_bias"
                         ".weight"]),
        "encoder": encoder,
        "head": {"dense": {k: t(x) for k, x in head.items()}},
    }


# --------------------------------------------------------------------------
# Directory-level load/save (the reference's `fold{k}/best/` contract)
# --------------------------------------------------------------------------


def load_hf_model_dir(model_dir: str) -> tuple[Params, ASTConfig]:
    """Load an HF model directory (config.json + safetensors/bin), or an
    int8 directory (`model_int8.safetensors`, written by
    `save_int8_model_dir` of either package): its params carry the
    quantized encoder leaves that `models.ast._dense` dispatches on."""
    config_path = os.path.join(model_dir, "config.json")
    config_dict = load_json_object(config_path, "model config")
    try:
        config = config_from_hf_dict(config_dict)
    except ValueError as e:
        raise ValueError(f"{config_path}: {e}") from e

    int8_path = os.path.join(model_dir, _INT8_FILE)
    if os.path.exists(int8_path):
        tree = _unflatten_tree(read_safetensors(int8_path))
        return params_from_jax(tree), config

    st = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st):
        sd = read_safetensors(st)
    elif os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(
            f"no model.safetensors or pytorch_model.bin under {model_dir}")
    return from_hf_state_dict(sd, config), config


def _hf_config_dict(config: ASTConfig,
                    id2label: Mapping[int, str] | None) -> dict:
    """The HF config.json payload."""
    labels = id2label or {i: f"LABEL_{i}" for i in range(config.num_labels)}
    return {
        "architectures": ["ASTForAudioClassification"],
        "model_type": "audio-spectrogram-transformer",
        "hidden_size": config.hidden_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "intermediate_size": config.intermediate_size,
        "hidden_act": "gelu",
        "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0,
        "initializer_range": config.initializer_range,
        "layer_norm_eps": config.layer_norm_eps,
        "patch_size": config.patch_size,
        "frequency_stride": config.frequency_stride,
        "time_stride": config.time_stride,
        "max_length": config.max_length,
        "num_mel_bins": config.num_mel_bins,
        "qkv_bias": config.qkv_bias,
        "id2label": {str(k): v for k, v in labels.items()},
        "label2id": {v: int(k) for k, v in labels.items()},
    }


def _write_config_json(hf_config: dict, model_dir: str) -> None:
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2, sort_keys=True)


def save_hf_model_dir(params: Params, config: ASTConfig, model_dir: str,
                      id2label: Mapping[int, str] | None = None) -> None:
    """Export params as an HF-compatible model directory."""
    os.makedirs(model_dir, exist_ok=True)
    _write_config_json(_hf_config_dict(config, id2label), model_dir)
    write_safetensors(to_hf_state_dict(params),
                      os.path.join(model_dir, "model.safetensors"))


def save_int8_model_dir(params: Params, config: ASTConfig, model_dir: str,
                        id2label: Mapping[int, str] | None = None) -> None:
    """Export an int8-quantized model directory, the JAX package's format.

    Quantizes the encoder's dense kernels (`models.ast.quantize_params`,
    idempotent) and writes `model_int8.safetensors`, the JAX pytree
    flattened to dotted keys with the kernels as I8, and `config.json` in
    the HF shape plus a `"zenker_int8": true` marker. No HF
    `model.safetensors` is written: quantization is lossy, so the format
    is this system's own."""
    os.makedirs(model_dir, exist_ok=True)
    hf_config = _hf_config_dict(config, id2label)
    hf_config["zenker_int8"] = True
    _write_config_json(hf_config, model_dir)
    write_safetensors(_flatten_tree(params_to_numpy(quantize_params(params))),
                      os.path.join(model_dir, _INT8_FILE))


def _flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Nested dict -> {dotted key: leaf}, the JAX package's flattening (the
    names of its checkpoints' `params.safetensors`)."""
    out: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten_tree(v, key))
        else:
            out[key] = v
    return out


def _unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    """Inverse of `_flatten_tree`."""
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        ks = key.split(".")
        for k in ks[:-1]:
            node = node.setdefault(k, {})
        node[ks[-1]] = arr
    return tree
