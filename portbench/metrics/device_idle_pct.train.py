"""device_idle_pct.train: the share of the traced window's wall time that
no kernel, copy or fill covers, in a "finetune" cell."""


def read(run):
    if run.cell.kind != "finetune" or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
