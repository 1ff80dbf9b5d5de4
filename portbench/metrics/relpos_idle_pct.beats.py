"""relpos_idle_pct.beats: the share of the traced window's wall time in
which no device event runs while the host is inside the port's
`beats.relpos` span (the relative-position bucket vector of a forward,
each layer's gates), in a "recordings_beats" cell."""

from portbench import spans

NAMES = ("beats.relpos",)


def read(run):
    if run.cell.kind != "recordings_beats":
        return None
    return spans.idle_pct(run.trace, NAMES)
