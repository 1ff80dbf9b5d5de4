"""Experiment tracking (reference observability stack is W&B, SURVEY §5.5).

`Run` is a W&B-shaped tracker (init/log/log_image/log_table/log_artifact/
summary/finish) that always writes locally (config.json + metrics.jsonl +
media/ + tables/ + artifacts/ + summary.json under <dir>/<run_id>/),
mirrors scalar metrics as TensorBoard event files under <run>/logs/ (the
reference's HF Trainer writes TB logs at logging_dir=<output>/logs,
src/train_ast_stage1_cross_validation.py:478,490-491), and mirrors to the
real `wandb` package when it is installed and not disabled —
so the reference's W&B workflow (scalar metrics, confusion-matrix plots,
classification-report tables, config artifacts, per-fold runs + a summary
run; src/train_ast_stage1_cross_validation.py:163-185,564-637,824-864,
922-941) keeps working where wandb exists, and everything stays inspectable
where it doesn't (this environment has no wandb and no network).

The port's copy of the JAX package's `utils/tracking.py` (pure Python; the
tensorboard and wandb channels stay optional).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from datetime import datetime
from typing import Any

from . import fsio


def _wandb_or_none(offline: bool):
    try:
        import wandb  # noqa: F401

        if offline:
            os.environ.setdefault("WANDB_MODE", "offline")
        return wandb
    except ImportError:
        return None


def active_wandb_run():
    """The pre-existing `wandb.run` when the process was launched by
    `wandb agent` (the sweep agent reuses it, as the reference does,
    src/train_ast_stage2_cross_validation.py:901-917); None without wandb or
    without a run."""
    try:
        import wandb
    except ImportError:
        return None
    return wandb.run


class _TBWriter:
    """TensorBoard scalar-event channel (reference: the HF Trainer writes
    TB event files under logging_dir=<output>/logs with logging_steps=20,
    src/train_ast_stage1_cross_validation.py:478,490-491). Uses the
    tensorboard package's own EventFileWriter — no torch dependency — so
    `tensorboard --logdir <run>/logs` shows the per-step loss and per-epoch
    metric curves. Construction raises ImportError where tensorboard is
    absent; Run gates on that and degrades to jsonl-only."""

    def __init__(self, logdir: str):
        from tensorboard.compat.proto import event_pb2
        from tensorboard.summary.writer.event_file_writer import (
            EventFileWriter,
        )

        os.makedirs(logdir, exist_ok=True)
        self._event_pb2 = event_pb2
        self._writer = EventFileWriter(logdir)

    def add_scalars(self, metrics: dict, step: int) -> None:
        ev = self._event_pb2.Event(wall_time=time.time(), step=int(step))
        n = 0
        for k, v in metrics.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            val = ev.summary.value.add()
            val.tag = str(k)
            val.simple_value = float(v)
            n += 1
        if n:
            self._writer.add_event(ev)

    def close(self) -> None:
        self._writer.close()


class Run:
    def __init__(self, project: str, name: str | None = None,
                 config: dict | None = None, group: str | None = None,
                 dir: str = "runs/tracking", use_wandb: bool = True,
                 offline: bool = False, entity: str | None = None,
                 use_tensorboard: bool = True):
        self.run_id = name or datetime.now().strftime("%Y%m%d_%H%M%S")
        self.dir = os.path.join(dir, self.run_id)
        os.makedirs(self.dir, exist_ok=True)
        self.config = dict(config or {})
        self._summary: dict[str, Any] = {}
        self._metrics_path = os.path.join(self.dir, "metrics.jsonl")
        # fresh history per run: a rerun under the same name replaces the
        # previous run's files wholesale (last-run-wins, like config.json /
        # summary.json below) instead of appending mixed metric streams —
        # including media/tables/artifacts, or a rerun with different fold
        # counts / table names would leave the old run's files mixed in
        open(self._metrics_path, "w").close()
        for sub in ("media", "tables", "artifacts", "logs"):
            shutil.rmtree(os.path.join(self.dir, sub), ignore_errors=True)
        fsio.atomic_json_dump(self.config,
                              os.path.join(self.dir, "config.json"),
                              indent=2, default=str)

        # TensorBoard mirror of scalar metrics (created lazily on the first
        # scalar log so metric-free runs leave no empty event files); steps:
        # explicit `step` arg > the record's train_step (the HF global step)
        # > a monotonic auto-counter (same rationale as the wandb auto-step)
        self._use_tb = use_tensorboard
        self._tb: _TBWriter | None = None
        self._tb_failed = False
        self._tb_next_step = 0
        self._tb_last_ts = 0  # per-step loss channel's own monotonic lane

        self._wandb = _wandb_or_none(offline) if use_wandb else None
        self._wandb_run = None
        if self._wandb is not None:
            try:
                self._wandb_run = self._wandb.init(
                    project=project, entity=entity, name=name, group=group,
                    config=config, reinit=True)
            except Exception as exc:  # network/auth failures degrade politely
                print(f"[tracking][WARN] wandb init failed: {exc}")
                self._wandb_run = None

    def log(self, metrics: dict, step: int | None = None) -> None:
        rec = {"_time": time.time(), **metrics}
        if step is not None:
            rec["_step"] = step
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
        self._tb_log(metrics, step)
        if self._wandb_run is not None:
            self._wandb_run.log(metrics, step=step)

    def _tb_log(self, metrics: dict, step: int | None) -> None:
        if not self._use_tb or self._tb_failed:
            return
        if self._tb is None:
            try:
                self._tb = _TBWriter(os.path.join(self.dir, "logs"))
            except Exception as exc:  # tensorboard absent/broken: jsonl-only
                print(f"[tracking][WARN] tensorboard channel disabled: {exc}")
                self._tb_failed = True
                return
        if step is None:
            ts = metrics.get("train_step")
            if isinstance(ts, int):
                # per-step loss channel: monotonic in its OWN lane. In
                # shared-run CV mode folds 2+ restart train_step at 1 —
                # rewinding would rewrite fold 1's points under the same
                # tag (the same non-monotonic-step problem the wandb path
                # avoids via auto-step) — so a rewound step continues past
                # the channel's last point instead
                step = ts if ts > self._tb_last_ts else self._tb_last_ts + 1
                self._tb_last_ts = step
            else:
                step = self._tb_next_step
        self._tb_next_step = max(self._tb_next_step, int(step) + 1)
        self._tb.add_scalars(metrics, step)

    def log_image(self, name: str, path: str) -> None:
        """Register an image file (e.g. a confusion-matrix plot): copied to
        <run>/media/ and mirrored as a wandb.Image (reference CM plots,
        src/train_ast_stage1_cross_validation.py:564-605)."""
        import shutil

        dest = os.path.join(self.dir, "media",
                            f"{name}{os.path.splitext(path)[1]}")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy2(path, dest)
        if self._wandb_run is not None:
            try:
                self._wandb_run.log({name: self._wandb.Image(dest)})
            except Exception as exc:
                print(f"[tracking][WARN] wandb image log failed: {exc}")

    def log_table(self, name: str, columns: list[str],
                  rows: list[list]) -> None:
        """Tabular payload (e.g. a classification report): JSON locally,
        wandb.Table in the mirror (reference report tables, :607-637)."""
        dest = os.path.join(self.dir, "tables", f"{name}.json")
        fsio.atomic_json_dump({"columns": columns, "rows": rows}, dest,
                              indent=2, default=str)
        if self._wandb_run is not None:
            try:
                self._wandb_run.log(
                    {name: self._wandb.Table(columns=columns, data=rows)})
            except Exception as exc:
                print(f"[tracking][WARN] wandb table log failed: {exc}")

    def log_artifact(self, path: str, name: str | None = None,
                     type: str = "config") -> None:
        """File artifact (e.g. the run-config snapshot): copied to
        <run>/artifacts/ and mirrored as a wandb.Artifact (reference
        config-artifact upload, :163-185)."""
        import shutil

        arts = os.path.join(self.dir, "artifacts")
        os.makedirs(arts, exist_ok=True)
        name = name or os.path.basename(path)
        shutil.copy2(path, os.path.join(arts, name))
        if self._wandb_run is not None:
            try:
                art = self._wandb.Artifact(name=name.replace(".", "-"),
                                           type=type)
                art.add_file(path)
                self._wandb_run.log_artifact(art)
            except Exception as exc:
                print(f"[tracking][WARN] wandb artifact failed: {exc}")

    def summary(self, **kwargs) -> None:
        self._summary.update(kwargs)

    def finish(self) -> None:
        # atomic: per-fold runs under a shared id re-finish the same file
        fsio.atomic_json_dump(self._summary,
                              os.path.join(self.dir, "summary.json"),
                              indent=2, default=float)
        if self._tb is not None:
            # final summary scalars at the last step, like the HF Trainer's
            # end-of-train metrics, then flush the event file to disk
            self._tb.add_scalars(
                {f"summary/{k}": v for k, v in self._summary.items()},
                max(self._tb_next_step - 1, 0))
            self._tb.close()
            self._tb = None
        if self._wandb_run is not None:
            for k, v in self._summary.items():
                self._wandb_run.summary[k] = v
            self._wandb_run.finish()
