"""Work a BEATs cell asks of the card, from its configuration file alone.

Per window and stage, all multiply-adds counted as two operations: the
stem (the 16 x 16 patch convolution and the 512 -> 768 projection), the
grouped position convolution 2 S H (H / G) K, per layer the dense products
2 S (4 H^2 + 2 H I), the gates' products 2 S H 8 and attention's two
products 4 S^2 H, and the predictor. At the published sizes (S = 512):
0.54 + 4.83 + 86.97 + 0.08 + 9.66 GFLOP, 102.1 in all. Padding rows a
program adds to fill a batch bucket are not counted: they are no work the
inputs need. The peak is `work.PEAK_BF16_FLOPS`, the readers' as the AST's.
"""

from __future__ import annotations

from .work import PEAK_BF16_FLOPS  # noqa: F401  (the readers' peak)


def seq_length(config: dict) -> int:
    p = config["input_patch_size"]
    return (config["max_length"] // p) * (config["num_mel_bins"] // p)


def attention_flops(config: dict, rows: int) -> float:
    """One attention call of `rows` sequences: 4 B NH S^2 D."""
    return 4.0 * rows * seq_length(config) ** 2 * config["encoder_embed_dim"]


def stem_flops(config: dict) -> float:
    S, E = seq_length(config), config["embed_dim"]
    return 2.0 * S * E * (config["input_patch_size"] ** 2
                          + config["encoder_embed_dim"])


def pos_conv_flops(config: dict) -> float:
    H = config["encoder_embed_dim"]
    return (2.0 * seq_length(config) * H * (H // config["conv_pos_groups"])
            * config["conv_pos"])


def layer_flops(config: dict) -> float:
    """One layer of one sequence: the dense products, the gates' products
    and attention."""
    S, H = seq_length(config), config["encoder_embed_dim"]
    I = config["encoder_ffn_embed_dim"]
    return (2.0 * S * (4 * H * H + 2 * H * I) + 2.0 * S * H * 8
            + attention_flops(config, 1))


def forward_flops(config: dict) -> float:
    """Model operations of one sequence through the whole forward."""
    return (stem_flops(config) + pos_conv_flops(config)
            + config["encoder_layers"] * layer_flops(config)
            + 2.0 * config["encoder_embed_dim"] * config["num_labels"])
