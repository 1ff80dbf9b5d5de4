"""launches_per_step.train: device kernels in the traced window over the
steps taken in it."""


def read(run):
    if run.cell.kind != "finetune" or not run.tally["steps"]:
        return None
    return len(run.trace.kernels()) / run.tally["steps"]
