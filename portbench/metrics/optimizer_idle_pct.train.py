"""optimizer_idle_pct.train: the share of the traced window's wall time in
which no device event runs while the host is inside the port's
`train.optimizer` span (the gradient clip's host read of the norm, then
AdamW's per-leaf update and `apply_updates`), in a "finetune" cell."""

from portbench import spans

NAMES = ("train.optimizer",)


def read(run):
    if run.cell.kind != "finetune":
        return None
    return spans.idle_pct(run.trace, NAMES)
