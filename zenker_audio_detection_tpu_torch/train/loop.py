"""Feature-extractor config files of exported model directories.

The part of the JAX package's `train/loop.py` that inference needs: each
exported `fold{k}/best/` model directory carries a
`preprocessor_config.json` (ASTFeatureExtractor format) with the per-fold
normalization mean/std, so the weights travel with their feature stats.
Training itself is not ported yet.
"""

from __future__ import annotations

import json
import os

from ..ops import fbank as F
from ..utils import fsio

SAMPLING_RATE = 16000


def save_feature_extractor_config(path: str, mean: float, std: float,
                                  max_length: int = F.MAX_FRAMES) -> None:
    """preprocessor_config.json compatible with ASTFeatureExtractor."""
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({
            "feature_extractor_type": "ASTFeatureExtractor",
            "feature_size": 1,
            "sampling_rate": SAMPLING_RATE,
            "num_mel_bins": F.NUM_MEL_BINS,
            "max_length": max_length,
            "padding_side": "right",
            "padding_value": 0.0,
            "return_attention_mask": False,
            "do_normalize": True,
            "mean": float(mean),
            "std": float(std),
        }, f, indent=2)


def load_feature_extractor_config(model_dir: str) -> tuple[float, float]:
    p = os.path.join(model_dir, "preprocessor_config.json")
    d = fsio.load_json_object(p, "feature-extractor config")
    try:
        return float(d["mean"]), float(d["std"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"feature-extractor config {p} has missing or "
                         f"non-numeric mean/std: {e!r}") from e
