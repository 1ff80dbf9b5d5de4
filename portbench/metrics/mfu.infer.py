"""mfu.infer: the model operations the traced window's windows needed
(stage 1 on every window, stage 2 on the gated ones; padding rows not
counted) over the window's wall time at the bf16 peak."""

from portbench import work


def read(run):
    if run.cell.kind != "recordings" or not run.tally["stage_windows"]:
        return None
    flops = run.tally["stage_windows"] * work.forward_flops(
        work.Shape.of(run.cell.config))
    return 100.0 * flops / (run.trace.window_s * work.PEAK_BF16_FLOPS)
