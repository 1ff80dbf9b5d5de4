"""frontend_idle_pct.infer: the share of the traced window's wall time in
which no device event runs while the host is inside the port's
`cascade.frontend` span (a recording padded and uploaded, its file-level
log-mel frames or samples buffer, the cache lookup), in a "recordings"
cell."""

from portbench import spans

NAMES = ("cascade.frontend",)


def read(run):
    if run.cell.kind != "recordings":
        return None
    return spans.idle_pct(run.trace, NAMES)
