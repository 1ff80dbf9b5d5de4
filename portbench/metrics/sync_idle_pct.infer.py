"""sync_idle_pct.infer: the share of the traced window's wall time in which
no device event runs while the host is inside the port's `cascade.fetch`
or `cascade.gate` span (a stage's probabilities fetched to the host, the
gate and the stage-2 selection), in a "recordings" cell."""

from portbench import spans

NAMES = ("cascade.fetch", "cascade.gate")


def read(run):
    if run.cell.kind != "recordings":
        return None
    return spans.idle_pct(run.trace, NAMES)
