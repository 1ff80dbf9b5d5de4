"""device_idle_pct.beats: the share of the traced window's wall time that
no kernel, copy or fill covers, in a "recordings_beats" cell."""


def read(run):
    if run.cell.kind != "recordings_beats" or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
