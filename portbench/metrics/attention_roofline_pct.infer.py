"""attention_roofline_pct.infer: the attention kernel's share of its
roofline in the traced window of a "recordings" cell.

Work: 4 B NH S^2 D operations for each launch, B the rows of the chunk
the engine ran (its bucket, padding included: the kernel computes them),
12 launches a chunk and stage. The least time is that work at the bf16
peak. Time: the device time of the program's own kernels, every kernel
whose name matches none of EXCLUDE (the libraries' and ATen's), so that a
kernel a later change writes for attention still counts. The launch
counter `mha_packed` must agree with the chunks counted, or there is
nothing to read.
"""

from portbench import work

EXCLUDE = ("at::", "at_cuda", "aten", "cublas", "cutlass", "cudnn", "xmma",
           "gemm", "gemv", "nvjet", "conv", "memcpy", "memset",
           "softmax_warp", "cub::", "splitk", "elementwise", "reduce_kernel",
           "triton")


def own(name: str) -> bool:
    low = name.lower()
    return not any(p in low for p in EXCLUDE)


def read(run):
    if run.cell.kind != "recordings":
        return None
    shape = work.Shape.of(run.cell.config)
    chunks = run.tally["chunks"]
    launches = shape.num_hidden_layers * len(chunks)
    if not chunks or run.counters.get("mha_packed") != launches:
        return None
    flops = shape.num_hidden_layers * sum(
        work.attention_flops(shape, rows) for rows in chunks)
    own_s = sum(end - start for name, start, end, _ in run.trace.kernels()
                if own(name)) / 1e6
    if own_s <= 0:
        return None
    return 100.0 * flops / work.PEAK_BF16_FLOPS / own_s
