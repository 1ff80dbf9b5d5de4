"""launch_idle_pct.infer: the share of the traced window's wall time in
which no device event runs while the host is inside the port's
`cascade.stage1` or `cascade.stage2` span (a stage's starts uploaded and
its chunks queued: the window gather and the trunk's launches), in a
"recordings" cell."""

from portbench import spans

NAMES = ("cascade.stage1", "cascade.stage2")


def read(run):
    if run.cell.kind != "recordings":
        return None
    return spans.idle_pct(run.trace, NAMES)
