"""summary_idle_pct.infer: the share of the traced window's wall time in
which no device event runs while the host is inside the port's
`cascade.summary` span (a recording's gate and summary, the patient's
JSON), in a "recordings" cell."""

from portbench import spans

NAMES = ("cascade.summary",)


def read(run):
    if run.cell.kind != "recordings":
        return None
    return spans.idle_pct(run.trace, NAMES)
