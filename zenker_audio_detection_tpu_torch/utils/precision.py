"""Full-f32 arithmetic on the card.

cuBLAS may run f32 matmuls in TF32 when `torch.backends.cuda.matmul.
allow_tf32` is set, and cuDNN runs f32 convolutions in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True). TF32 keeps about three decimal
digits: enough to move low-power mel bins by O(0.5) after the log, and to
break f32 parity with the JAX reference. Code that needs true f32 runs
inside `full_f32()`; bf16 work is unaffected by it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and cuDNN convolutions inside the block; the
    previous settings are restored on exit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
