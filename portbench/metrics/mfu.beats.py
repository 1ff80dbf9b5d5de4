"""mfu.beats: the model operations the traced window's windows needed in a
"recordings_beats" cell (stage 1 on every window, stage 2 on the gated
ones; padding rows not counted; `work_beats.forward_flops`) over the
window's wall time at the bf16 peak."""

from portbench import work_beats


def read(run):
    if run.cell.kind != "recordings_beats" or not run.tally["stage_windows"]:
        return None
    flops = run.tally["stage_windows"] * work_beats.forward_flops(
        run.cell.config)
    return 100.0 * flops / (run.trace.window_s * work_beats.PEAK_BF16_FLOPS)
