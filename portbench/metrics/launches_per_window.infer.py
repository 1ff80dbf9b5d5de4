"""launches_per_window.infer: device kernels in the traced window over
the windows completed in it."""


def read(run):
    if run.cell.kind != "recordings" or not run.tally["windows"]:
        return None
    return len(run.trace.kernels()) / run.tally["windows"]
