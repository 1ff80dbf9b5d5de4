"""Traffic of kind "recordings": a cohort of long recordings through the
two-stage engine, one caller in a closed loop.

Set-up makes both stages' weights, calibrates their heads on the
reference (`inputs.calibrate_head`), makes the pool of patients and builds the
engine as `cli/infer_long_audio.py` builds it. A unit of timed work is one
`TwoStageEngine.run_patient` over a patient's recordings; the pool is
cycled in an order drawn from the seed. The check compares a sample of the
windows with the reference, the gate on every window, and every summary.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import inputs, work
from ..reference import ast as ref_ast
from ..reference import cascade as ref_cascade
from ..reference import fbank as ref_fbank

LABELS = (("Idle", "Swallow"), ("Healthy", "Zenker"))


@dataclasses.dataclass
class Done:
    """One recording the timed window completed."""
    visit: int
    patient: int
    path: str
    windows: int
    p1: np.ndarray
    p2: np.ndarray


class Driver:
    """See the module docstring. `variant` "control" builds the engine
    with the program's own int8 path; "fault:<name>" breaks the timed path
    as `FAULTS` says, for the harness's tests."""

    def __init__(self, cell, seed: int, device, variant: str | None = None):
        self.cell, self.seed, self.device = cell, seed, device
        self.variant = variant
        self.mix, self.config = cell.mix, cell.config

    # ---------------- set-up ----------------

    def _ast_config(self, ast_mod):
        fields = {f.name for f in dataclasses.fields(ast_mod.ASTConfig)}
        return ast_mod.ASTConfig(**{k: v for k, v in self.config.items()
                                    if k in fields})

    def _features(self, pcm: np.ndarray, starts: np.ndarray) -> torch.Tensor:
        m = self.mix
        return ref_fbank.window_features(
            pcm, starts, m["window_samples"], self.config["max_length"],
            m["feature_mean"], m["feature_std"], self.device)

    def _reference(self, params, feats, pooled=False):
        rows = ref_ast.rows_within(self.config, 2 ** 31)
        out = []
        with torch.no_grad():
            for i in range(0, len(feats), rows):
                logits, pool = ref_ast.forward(params, feats[i: i + rows],
                                               self.config)
                out.append(pool if pooled else torch.softmax(logits, -1))
        return torch.cat(out)

    def setup(self) -> None:
        from zenker_audio_detection_tpu_torch.infer import cascade as C
        from zenker_audio_detection_tpu_torch.models import ast as ast_mod

        m, dev = self.mix, self.device
        self.params = [inputs.weights(self.config, self.seed, f"stage{s}", dev)
                       for s in (1, 2)]
        # the heads, calibrated on the reference over one recording; the
        # reference's seconds are kept out of setup_s
        t0 = time.perf_counter()
        cal = inputs.audio([m["gate"]["calibration_s"]], m, self.seed,
                           "calibration", dev)[0]
        starts = ref_cascade.window_starts(len(cal), m["window_samples"],
                                           m["hop_samples"])
        feats = self._features(cal, starts)
        for params, rate in zip(self.params, m["gate"]["rates"]):
            pooled = self._reference(params, feats, pooled=True)
            params["head"]["dense"] = inputs.calibrate_head(
                pooled, params["head"]["ln"], self.config["layer_norm_eps"],
                rate, m["gate"]["band"], m["gate"]["spread_logits"])
        del feats
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.reference_s = time.perf_counter() - t0
        # the pool: one fixed set of lengths, evenly spaced; each patient
        # holds the i-th shortest and the i-th longest, so that every
        # patient is the same work; the seed deals the patients' order and
        # which of its two recordings comes first
        lo, hi = m["length_s"]["low"], m["length_s"]["high"]
        k, P = m["recordings_per_patient"], m["patients"]
        lengths = np.linspace(lo, hi, k * P)
        pairs = [lengths[[p, k * P - 1 - p]] for p in range(P)]
        rng = np.random.default_rng(inputs.substream(self.seed, "pool"))
        lengths = np.concatenate([pair[rng.permutation(k)] for pair in pairs])
        pcm = inputs.audio(lengths, m, self.seed, "pool", dev)
        self.pool = [[(f"patient{p:02d}_{j}.wav", pcm[p * k + j])
                      for j in range(k)] for p in range(P)]
        self.order = rng.permutation(P)

        cfg = self._ast_config(ast_mod)
        specs = [C.StageSpec(params, cfg, m["feature_mean"],
                             m["feature_std"], labels)
                 for params, labels in zip(self.params, LABELS)]
        engine_cfg = C.CascadeConfig(**m.get("engine", {}))
        if self.variant == "control":
            engine_cfg = dataclasses.replace(engine_cfg, int8=True)
        self.engine_config = engine_cfg
        self.engine = C.TwoStageEngine(*specs, engine_cfg, device=dev)
        self.done: list[Done] = []
        self.patients: dict = {}
        self.units, self._patient = -1, -1
        if self.variant and self.variant.startswith("fault:"):
            FAULTS[self.variant[6:]](self)
        self._capture()
        # warm-up: recordings whose window counts fill every chunk bucket
        # of stage 1 and, at the gate's rate, of stage 2
        warm = inputs.audio(
            [((w - 1) * m["hop_samples"] + m["window_samples"])
             / m["sample_rate"] for w in m["warmup_windows"]],
            m, self.seed, "warmup", dev)
        for a in warm:
            self.engine.run_patient(["warmup.wav"], [a])
        self.done.clear()
        self.patients.clear()
        self.units = 0
        self.mark()

    def _capture(self) -> None:
        """Keeps each recording's probabilities as the engine computes
        them, by wrapping its public `window_probs` (all-window
        probabilities of one recording). The check holds every capture
        against the windows that `run_patient`'s JSON counts, so a path
        that leaves the wrapper out fails the run and counts nothing."""
        window_probs = self.engine.window_probs

        def capture(audio, path=None):
            p1, p2 = window_probs(audio, path)
            self.done.append(Done(self.units, self._patient, path or "",
                                  len(p1), p1, p2))
            return p1, p2

        self.engine.window_probs = capture

    # ---------------- the window ----------------

    def unit(self) -> None:
        p = int(self.order[self.units % len(self.order)])
        files, audios = zip(*self.pool[p])
        self._patient = p
        self.patients[self.units] = self.engine.run_patient(list(files),
                                                            list(audios))
        self.units += 1

    def mark(self) -> None:
        self._mark, self._mark_units = len(self.done), self.units

    def tally(self) -> dict:
        """What the window since `mark` completed: its windows as
        `run_patient`'s JSON counts them, the rest from the captures."""
        done = self.done[self._mark:]
        gate = self.engine_config.stage1_threshold
        gated = [len(ref_cascade.gate(d.p1, gate)) for d in done]
        batch = self.engine_config.batch_size
        chunks = [b for d, g in zip(done, gated)
                  for b in work.buckets(d.windows, batch)
                  + work.buckets(g, batch)]
        return {"recordings": len(done),
                "windows": sum(
                    self.patients[u]["aggregate"]["total_windows"]
                    for u in range(self._mark_units, self.units)),
                "stage_windows": sum(d.windows for d in done) + sum(gated),
                "chunks": chunks}

    def metrics(self, wall_s: float) -> dict:
        return {"windows_per_s": (self.tally()["windows"] / wall_s,
                                  "windows/s")}

    def attempted(self) -> tuple[int, int]:
        return sum(len(self.patients[u]["per_file"])
                   for u in range(self._mark_units, self.units)), 0

    def release(self) -> None:
        del self.engine
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ---------------- the check ----------------

    def _sample(self, rng, candidates: list, n: int) -> list:
        """n (recording, window) pairs: half from the longest recording,
        the rest from all, without repeats."""
        longest = max(range(len(self.done)), key=lambda i: self.done[i].windows)
        first = [c for c in candidates if c[0] == longest]
        take = rng.permutation(len(first))[: n // 2]
        chosen = {first[i] for i in take}
        rest = [c for c in candidates if c not in chosen]
        chosen |= {rest[i] for i in rng.permutation(len(rest))[: n - len(chosen)]}
        return sorted(chosen)

    def _pcm(self, d: Done) -> np.ndarray:
        return dict(self.pool[d.patient])[d.path]

    def _margin_error(self, got: np.ndarray, want: np.ndarray,
                      stage: int) -> np.ndarray:
        """The class-1 margin (logit 1 - logit 0) of the program less the
        reference's, per window, over the head's scale: the error along
        the pooled features' direction that the head reads, whatever the
        scale the calibration gave this seed's head."""
        def margin(p):
            p = np.clip(p, 1e-300, None)
            return np.log(p[:, 1]) - np.log(p[:, 0])

        scale = float(torch.linalg.vector_norm(
            self.params[stage]["head"]["dense"]["kernel"][:, 1].double()))
        return (margin(got) - margin(want)) / scale

    def check(self) -> dict:
        m, chk = self.mix, self.mix["check"]
        thr1 = self.engine_config.stage1_threshold
        thr2 = self.engine_config.stage2_threshold
        rng = np.random.default_rng(inputs.substream(self.seed, "check"))
        done = self.done[self._mark:]
        offset = self._mark
        # the gate as the program applied it, on every window
        gate_set = 0
        for d in done:
            want = np.zeros(d.windows, bool)
            want[ref_cascade.gate(d.p1, thr1)] = True
            gate_set += int(((np.abs(d.p2).sum(1) > 0) != want).sum())
        # every recording the JSON reports was captured, window for window
        visits: dict = {u: [] for u in range(self._mark_units, self.units)}
        for d in done:
            visits[d.visit].append(d)
        capture = 0
        for visit, recs in visits.items():
            out = self.patients[visit]
            capture += abs(len(out["per_file"]) - len(recs)) + abs(
                out["aggregate"]["total_windows"]
                - sum(d.windows for d in recs))
        # every patient's JSON against the reference summary of the
        # program's probabilities
        summary = 0
        for visit, recs in visits.items():
            out = self.patients[visit]
            if len(recs) != len(out["per_file"]):
                continue
            files = [ref_cascade.file_summary(d.p1, d.p2, thr1, thr2)
                     for d in recs]
            for j, f in enumerate(files):
                summary += len(ref_cascade.mismatches(
                    out["per_file"][f"file_{j}"], f))
            summary += len(ref_cascade.mismatches(
                out["aggregate"], ref_cascade.patient_totals(files)))
        # probabilities of a sample of windows, against the reference
        s1 = [(i, w) for i, d in enumerate(self.done) if i >= offset
              for w in range(d.windows)]
        if not s1:
            # nothing captured: the capture count alone decides
            self.detail = {"captured": 0}
            return {"far": 0, "gate_flips": 0, "gate_set": gate_set,
                    "summary": summary, "capture": capture}
        s1 = self._sample(rng, s1, chk["stage1_windows"])
        s2 = [(i, int(w)) for i, d in enumerate(self.done) if i >= offset
              for w in ref_cascade.gate(d.p1, thr1)]
        s2 = self._sample(rng, s2, chk["stage2_windows"]) if s2 else []
        ref = {}
        for stage, pairs in ((0, s1), (1, s2)):
            if not pairs:
                ref[stage] = np.zeros((0, 2))
                continue
            feats = torch.cat([
                self._features(self._pcm(self.done[i]), np.array(
                    [w * m["hop_samples"] for i2, w in pairs if i2 == i]))
                for i in sorted({i for i, _ in pairs})])
            ref[stage] = self._reference(self.params[stage], feats) \
                .double().cpu().numpy()
            del feats
        got1 = np.array([self.done[i].p1[w] for i, w in s1])
        got2 = np.array([self.done[i].p2[w] for i, w in s2]).reshape(-1, 2)
        dev1 = self._margin_error(got1, ref[0], 0)
        dev2 = self._margin_error(got2, ref[1], 1)
        lim = self.cell.limits
        # the shift that rounding the weights gives every window of a
        # stage alike: the median of its error over the sample (recorded
        # beside the check: the int8 control's shifts overlap sound runs')
        shifts = [float(np.median(d)) if len(d) else 0.0
                  for d in (dev1, dev2)]
        # the windows whose error departs from the sample's own
        dev1 = dev1 - shifts[0]
        dev2 = dev2 - shifts[1]
        far = int((np.abs(dev1) > lim["far"]["tol"]).sum()
                  + (np.abs(dev2) > lim["far"]["tol"]).sum())
        # gate decisions of the sample that differ where the reference's
        # probability lies farther from the threshold than the band
        flips = ((got1[:, 1] >= thr1) & (got1.argmax(1) == 1)) != \
            ((ref[0][:, 1] >= thr1) & (ref[0].argmax(1) == 1))
        away = np.abs(ref[0][:, 1] - thr1) > lim["gate_flips"]["band"]
        self.detail = {
            "shifts": shifts,
            "gate_rate": sum(len(ref_cascade.gate(d.p1, thr1)) for d in done)
            / max(1, sum(d.windows for d in done)),
            "largest_departure": [float(np.abs(d).max()) if len(d) else 0.0
                                  for d in (dev1, dev2)],
            "largest_probability_gap": [
                float(np.abs(got1[:, 1] - ref[0][:, 1]).max()),
                float(np.abs(got2[:, 1] - ref[1][:, 1]).max())
                if len(got2) else 0.0]}
        return {"far": far, "gate_flips": int((flips & away).sum()),
                "gate_set": gate_set, "summary": summary,
                "capture": capture}


def _perturb_answers(driver: Driver) -> None:
    """An answer altered where it is produced: every other window of every
    recording gets a stage-1 Swallow probability 0.05 higher."""
    wp = driver.engine.window_probs

    def window_probs(audio, path=None):
        p1, p2 = wp(audio, path)
        p1 = p1.copy()
        p1[::2, 1] = np.minimum(1.0, p1[::2, 1] + 0.05)
        p1[::2, 0] = 1.0 - p1[::2, 1]
        return p1, p2

    driver.engine.window_probs = window_probs


def _miscount(driver: Driver) -> None:
    """A summary altered: one Zenker window more in every file."""
    gs = driver.engine.gate_and_summarize

    def gate_and_summarize(p1, p2):
        out = gs(p1, p2)
        out[0]["stage2_zenker_windows"] += 1
        return out

    driver.engine.gate_and_summarize = gate_and_summarize


FAULTS = {"answer": _perturb_answers, "summary": _miscount}
