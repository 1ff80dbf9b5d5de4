"""mfu.train: three forwards' model operations a step (the recompute of a
rematerialised forward is not useful work) over the traced wall time a
step, at the bf16 peak."""

from portbench import work


def read(run):
    if run.cell.kind != "finetune" or not run.tally["steps"]:
        return None
    flops = run.tally["steps"] * work.train_step_flops(
        work.Shape.of(run.cell.config), run.cell.mix["batch"])
    return 100.0 * flops / (run.trace.window_s * work.PEAK_BF16_FLOPS)
