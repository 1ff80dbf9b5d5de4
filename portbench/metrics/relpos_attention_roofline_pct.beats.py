"""relpos_attention_roofline_pct.beats: the bias-carrying attention
kernel's share of its roofline in the traced window of a
"recordings_beats" cell.

Work: 4 B NH S^2 D operations for each launch, B the rows of the chunk the
engine ran (its bucket, padding included: the kernel computes them),
`encoder_layers` launches a chunk and stage; the least time is that work
at the bf16 peak (the bias's loads and multiply-adds are not counted).
Time: the device time of the kernels whose names hold PATTERN, the
instance `mha_packed_relpos` launches. The launch counter
`mha_packed_relpos` must agree with the chunks counted, or there is
nothing to read (as on a program without that kernel).
"""

from portbench import work_beats

PATTERN = "ws_relpos_kernel"


def read(run):
    if run.cell.kind != "recordings_beats":
        return None
    config = run.cell.config
    chunks = run.tally["chunks"]
    layers = config["encoder_layers"]
    if not chunks or run.counters.get("mha_packed_relpos") != \
            layers * len(chunks):
        return None
    flops = layers * sum(work_beats.attention_flops(config, rows)
                         for rows in chunks)
    kernel_s = sum(end - start for name, start, end, _ in run.trace.kernels()
                   if PATTERN in name) / 1e6
    if kernel_s <= 0:
        return None
    return 100.0 * flops / work_beats.PEAK_BF16_FLOPS / kernel_s
