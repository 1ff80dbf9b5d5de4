"""Traffic of kind "finetune": the fold fine-tuning step as the training
loop takes it.

Set-up makes the weights and a host pool of normalised feature rows with
balanced labels, builds the step as `train/loop.py:train_fold` builds it,
and takes its first `check_steps` steps through the same call and feed as
the window, on rows that all differ. A unit of timed work is one step: the
batch gathered on the host from the seed's permutation, moved to the
device, the step, and the loss read back. The check follows those first
steps with the reference from the same weights and batches.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .. import inputs
from ..reference import fbank as ref_fbank
from ..reference import train as ref_train


class Driver:
    """See the module docstring. `variant` "control" puts the reference
    computed in float8 in the program's place; "fault:<name>" breaks the
    step as `FAULTS` says."""

    def __init__(self, cell, seed: int, device, variant: str | None = None):
        self.cell, self.seed, self.device = cell, seed, device
        self.variant = variant
        self.mix, self.config = cell.mix, cell.config

    def _pool(self) -> tuple[np.ndarray, np.ndarray]:
        m = self.mix
        n, rate = m["pool_rows"], m["sample_rate"]
        # one fixed set of loudness levels, dealt to the clips in the
        # seed's order
        rng = np.random.default_rng(inputs.substream(self.seed, "levels"))
        levels = np.linspace(m["level_db"]["low"], m["level_db"]["high"], n)
        stds = 10.0 ** (levels[rng.permutation(n)] / 20.0)
        clips = inputs.audio([m["clip_samples"] / rate] * n, m, self.seed,
                             "clips", self.device, stds)
        # the reference front end's seconds are kept out of setup_s
        t0 = time.perf_counter()
        starts = np.zeros(1, np.int64)
        feats = torch.cat([ref_fbank.window_features(
            c, starts, m["clip_samples"], self.config["max_length"],
            m["feature_mean"], m["feature_std"], self.device) for c in clips])
        feats = feats.cpu().numpy()
        self.reference_s = time.perf_counter() - t0
        rng = np.random.default_rng(inputs.substream(self.seed, "labels"))
        labels = rng.permutation(np.arange(n) % 2).astype(np.int64)
        return feats, labels

    def setup(self) -> None:
        from zenker_audio_detection_tpu_torch.models import ast as ast_mod
        from zenker_audio_detection_tpu_torch.train import losses, optim, steps

        m, dev = self.mix, self.device
        self.params0 = inputs.weights(self.config, self.seed, "model", dev)
        self.feats, self.labels = self._pool()
        self.labels_t = torch.from_numpy(self.labels)
        self.epoch_rng = np.random.default_rng(
            inputs.substream(self.seed, "epochs"))
        self.order = np.zeros(0, np.int64)
        fields = {f.name for f in dataclasses.fields(ast_mod.ASTConfig)}
        cfg = ast_mod.ASTConfig(**{k: v for k, v in self.config.items()
                                   if k in fields})
        opt = m["optimizer"]
        self.tx = optim.make_optimizer(
            opt["learning_rate"], opt["total_steps"], opt["warmup_ratio"],
            opt["weight_decay"], beta2=opt["beta2"])

        def loss_fn(logits, labels):
            return losses.stage1_loss(logits, labels, m["focal_gamma"],
                                      m["label_smoothing"])

        self.loss_fn = loss_fn
        if self.variant and self.variant.startswith("fault:"):
            FAULTS[self.variant[6:]](self)
        self.step = steps.make_train_step(self.tx, cfg, self.loss_fn,
                                          dtype=getattr(torch, m["dtype"]))
        if self.variant == "fault:unchanged":
            self.step = _frozen(self.step)
        self.params = self.params0
        self.state = self.tx.init(self.params)
        # the first steps, through the window's own call and feed
        self.batches, self.losses, self.logits = [], [], []
        self.failed = self.units = 0
        for i in range(m["check_steps"]):
            self.unit()
            if i == 0:
                self.mu1 = self.state["mu"]
        self.params_checked = self.params
        self.failed = 0
        self.mark()

    def _next_batch(self) -> np.ndarray:
        b = self.mix["batch"]
        if len(self.order) < b:
            self.order = np.concatenate(
                [self.order, self.epoch_rng.permutation(len(self.labels))])
        idx, self.order = self.order[:b], self.order[b:]
        return idx

    def unit(self) -> None:
        idx = self._next_batch()
        feats = torch.from_numpy(self.feats[idx]).to(self.device)
        labels = self.labels_t[idx].to(self.device)
        self.params, self.state, loss, logits = self.step(
            self.params, self.state, feats, labels)
        loss = float(loss)
        if len(self.batches) < self.mix["check_steps"]:
            self.batches.append(idx)
            self.losses.append(loss)
            self.logits.append(logits.detach().float().cpu())
        self.failed += not np.isfinite(loss)
        self.units += 1

    def mark(self) -> None:
        self._mark = self.units

    def tally(self) -> dict:
        return {"steps": self.units - self._mark}

    def metrics(self, wall_s: float) -> dict:
        return {"train_step_ms": (1e3 * wall_s / self.tally()["steps"], "ms")}

    def attempted(self) -> tuple[int, int]:
        return self.tally()["steps"], self.failed

    def release(self) -> None:
        self.params = self.state = self.step = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ---------------- the check ----------------

    def _reference_steps(self, quant=None):
        m = self.mix
        opt = {**m["optimizer"], "beta1": 0.9, "eps": 1e-8,
               "max_grad_norm": 1.0}
        params, state = self.params0, ref_train.init_state(self.params0)
        losses, logits, states = [], [], [state]
        for idx in self.batches:
            feats = torch.from_numpy(self.feats[idx]).to(self.device)
            labels = torch.from_numpy(self.labels[idx]).to(self.device)
            loss, grads, out = ref_train.loss_and_grads(
                params, feats, labels, self.config, m["reference_rows"], quant)
            params, state = ref_train.adamw_step(params, state, grads, opt)
            states.append(state)
            losses.append(loss)
            logits.append(out.cpu())
        # each step's gradient as the optimizer got it, from its moments
        b1 = opt["beta1"]
        self.ref_grads = [{n: (b["mu"][n] - b1 * a["mu"][n]) / (1 - b1)
                           for n in b["mu"]}
                          for a, b in zip(states, states[1:])]
        self.ref_state = state
        return losses, logits, self.ref_grads[0], params

    def readings(self) -> tuple:
        """(losses, logits, first clipped gradient by leaf, parameters
        after the checked steps) of the program, or of the control in its
        place."""
        if self.variant == "control":
            return self._reference_steps(quant="fp8")
        b1 = self.tx.beta1
        g1 = {n: mu / (1 - b1) for n, mu in ref_train.leaves(self.mu1)}
        return self.losses, self.logits, g1, self.params_checked

    def check(self) -> dict:
        losses, logits, g1, p3 = self.readings()
        ref_losses, ref_logits, ref_g1, ref_p3 = self._reference_steps()
        # each step's loss against the batch's mean cross-entropy of the
        # logits the step returned, all rows
        loss_of_logits = max(
            abs(loss - float(torch.nn.functional.cross_entropy(
                out.double(), torch.from_numpy(self.labels[idx]))))
            / abs(loss) for loss, out, idx in zip(losses, logits,
                                                   self.batches))
        norm = lambda t: float(torch.linalg.vector_norm(t.double()))
        ref_g = {n: norm(g) for n, g in ref_g1.items()}
        med = float(np.median(list(ref_g.values())))
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone: left out by this rule, not by name
        include = [n for n, v in ref_g.items() if v >= 1e-3 * med]
        p0 = dict(ref_train.leaves(self.params0))
        got_p, want_p = dict(ref_train.leaves(p3)), dict(ref_train.leaves(ref_p3))
        got_c = {n: norm(got_p[n] - p0[n]) for n in include}
        want_c = {n: norm(want_p[n] - p0[n]) for n in include}
        # the logits of the checked steps: the class-1 margin's error over
        # the norm of the head's margin direction, the error along what the
        # head reads, whatever its scale at this seed; the largest over
        # every row of every step is compared (each step's, and the root
        # mean square, are recorded beside it)
        w = self.params0["head"]["dense"]["kernel"].double()
        scale = float(torch.linalg.vector_norm(w[:, 1] - w[:, 0]))
        errors = [((a[:, 1] - a[:, 0]) - (b[:, 1] - b[:, 0])).double() / scale
                  for a, b in zip(logits, ref_logits)]
        step_gaps = [float(e.abs().max()) for e in errors]
        logit_gap = max(step_gaps)
        # the first gradient: the gap of the norms and the norm of the
        # difference, by the worst leaf (recorded beside the check)
        grad_gap, grad_leaf = worst_gap({n: norm(g1[n]) for n in include},
                                        ref_g, include)
        grad_diff_leaf, _ = worst_gap({n: norm(g1[n] - ref_g1[n])
                                       for n in include},
                                      {n: 0.0 for n in include}, include,
                                      ref_g)
        change_gap, change_leaf = worst_gap(got_c, want_c, include)
        gaps = {n: abs(got_c[n] - want_c[n]) / want_c[n] for n in include}
        change_median = float(np.median(list(gaps.values())))
        # the change's direction, as the first gradient's (recorded beside
        # the check: the steps' cancellation moves it, see _look)
        diff = {n: (got_p[n] - want_p[n]).double() for n in include}
        change_diff = math.sqrt(sum(float((d * d).sum())
                                    for d in diff.values())) / math.sqrt(
            sum(want_c[n] ** 2 for n in include))
        self.detail = {
            "losses": losses, "reference_losses": ref_losses,
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
            "grad_gap": grad_gap, "grad_leaf": grad_leaf,
            "grad_diff_leaf": grad_diff_leaf, "logit_gaps": step_gaps,
            "logit_rms": float(torch.cat(errors).square().mean().sqrt()),
            "change_gap": change_gap, "change_leaf": change_leaf,
            "change_diff": change_diff,
            "left_out": sorted(set(ref_g) - set(include)),
            "look": self._look(g1, ref_g1, got_p, want_p, p0, gaps, diff,
                               include)}
        return {"loss_of_logits": loss_of_logits, "logit_gap": logit_gap,
                "change_median": change_median}

    def _look(self, g1, ref_g1, got_p, want_p, p0, gaps, diff,
              include) -> dict:
        """Why a leaf's change departs: for the worst and the median leaf
        by the gap of the change's norms, and over all leaves, the
        reference's cosine between successive steps' gradients, how far
        the third step's first moment cancels (its norm over the sum of
        its terms' norms; 1 is none), the program's first gradient's error,
        the share of elements whose change has the other sign, and the
        share where eps is a tenth or more of the update's denominator."""
        b1, b2 = 0.9, self.mix["optimizer"]["beta2"]
        g = self.ref_grads
        k = len(g)
        weights = [(1 - b1) * b1 ** (k - 1 - i) for i in range(k)]
        nu_hat = {n: self.ref_state["nu"][n] / (1 - b2 ** k) for n in include}

        def stats(names):
            cat = lambda parts: torch.cat([p.double().flatten()
                                           for p in parts])
            steps = [cat([gi[n] for n in names]) for gi in g]
            cos = [float(torch.nn.functional.cosine_similarity(
                a, b, dim=0)) for a, b in zip(steps, steps[1:])]
            mu = cat([self.ref_state["mu"][n] for n in names])
            cancel = float(mu.norm()) / sum(
                w * float(s.norm()) for w, s in zip(weights, steps))
            r1 = cat([ref_g1[n] for n in names])
            grad_err = float((cat([g1[n] for n in names]) - r1).norm()
                             / r1.norm())
            dp = cat([got_p[n] - p0[n] for n in names])
            dr = cat([want_p[n] - p0[n] for n in names])
            other_sign = float(((dp * dr) < 0).double().mean())
            small = float((torch.sqrt(cat([nu_hat[n] for n in names]))
                           < 10 * 1e-8).double().mean())
            return {"cos_steps": cos, "cancel": cancel, "grad_err": grad_err,
                    "other_sign": other_sign, "eps_share": small,
                    "diff": float(cat([diff[n] for n in names]).norm()
                                  / dr.norm())}

        order = sorted(include, key=gaps.get)
        worst, median = order[-1], order[len(order) // 2]
        return {"worst": {"leaf": worst, "gap": gaps[worst], **stats([worst])},
                "median": {"leaf": median, "gap": gaps[median],
                           **stats([median])},
                "all": stats(include)}


def worst_gap(got: dict, want: dict, include, scale: dict | None = None
              ) -> tuple[float, str]:
    """The worst leaf's |got - want| over the larger of its `scale` (want
    by default) and the median leaf's, and that leaf's name."""
    scale = want if scale is None else scale
    med = float(np.median([scale[n] for n in include]))
    return max((abs(got[n] - want[n]) / max(scale[n], med), n)
               for n in include)


def _frozen(step):
    """A step that returns its state unchanged."""

    def frozen(params, state, feats, labels):
        _, _, loss, logits = step(params, state, feats, labels)
        return params, state, loss, logits

    return frozen


def _half_batch(driver: Driver) -> None:
    """Half of the batch left out, the mean taken over the rest."""
    loss_fn = driver.loss_fn

    def half(logits, labels):
        n = len(labels) // 2
        return loss_fn(logits[:n], labels[:n])

    driver.loss_fn = half


def _sign(driver: Driver) -> None:
    """A gradient of the wrong sign, the loss it reports unchanged."""
    loss_fn = driver.loss_fn

    def flipped(logits, labels):
        loss = loss_fn(logits, labels)
        return 2 * loss.detach() - loss

    driver.loss_fn = flipped


FAULTS = {"unchanged": lambda driver: None, "half_batch": _half_batch,
          "sign": _sign}
