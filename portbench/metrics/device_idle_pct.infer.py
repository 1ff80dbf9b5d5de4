"""device_idle_pct.infer: the share of the traced window's wall time that
no kernel, copy or fill covers, in a "recordings" cell."""


def read(run):
    if run.cell.kind != "recordings" or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
