"""Work a cell asks of the card, from its configuration file alone.

The peak is NVIDIA's data sheet for one H100 SXM: the dense bf16 tensor
core rate at 700 W. The counts follow the AST's published shapes: per window and stage the
patch convolution, per layer the dense products 2 S (4 H^2 + 2 H I) and
attention's two products 4 S^2 H (q k^T and p v), all multiply-adds
counted as two operations. Padding rows a program adds to fill a batch
bucket are not counted here: they are no work the inputs need.
"""

from __future__ import annotations

import dataclasses

PEAK_BF16_FLOPS = 989e12


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes of one AST configuration that the work depends on."""

    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    patch_size: int
    frequency_stride: int
    time_stride: int
    max_length: int
    num_mel_bins: int
    num_labels: int

    @classmethod
    def of(cls, config: dict) -> "Shape":
        return cls(**{f.name: int(config[f.name])
                      for f in dataclasses.fields(cls)})

    @property
    def frequency_patches(self) -> int:
        return (self.num_mel_bins - self.patch_size) // self.frequency_stride + 1

    @property
    def time_patches(self) -> int:
        return (self.max_length - self.patch_size) // self.time_stride + 1

    @property
    def num_patches(self) -> int:
        return self.frequency_patches * self.time_patches

    @property
    def seq_length(self) -> int:
        """Patches plus the CLS and distillation tokens."""
        return self.num_patches + 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def attention_flops(shape: Shape, rows: int) -> float:
    """One attention call of `rows` sequences: 4 B NH S^2 D."""
    return 4.0 * rows * shape.seq_length ** 2 * shape.hidden_size


def forward_flops(shape: Shape) -> float:
    """Model operations of one sequence through the whole forward."""
    S, H, I = shape.seq_length, shape.hidden_size, shape.intermediate_size
    patch = 2.0 * shape.num_patches * H * shape.patch_size ** 2
    dense = 2.0 * S * (4 * H * H + 2 * H * I)
    head = 2.0 * H * shape.num_labels
    return (patch + shape.num_hidden_layers * (dense + attention_flops(shape, 1))
            + head)


def train_step_flops(shape: Shape, batch: int) -> float:
    """Forward and backward of one optimizer step: three forwards' work.
    The recompute of a rematerialised forward is not useful work."""
    return 3.0 * batch * forward_flops(shape)


def buckets(n: int, batch: int, floor: int = 8) -> list[int]:
    """The rows of each chunk an engine of `batch` runs over `n` windows:
    full chunks, then the tail padded to a power of two (at least
    `floor`, at most `batch`)."""
    out = [batch] * (n // batch)
    if n % batch:
        b = floor
        while b < n % batch:
            b *= 2
        out.append(min(batch, b))
    return out
