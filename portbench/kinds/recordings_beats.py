"""Traffic of kind "recordings_beats": the cohort of kind "recordings"
through two BEATs stages (`models/beats.py` of the program).

The driver is `recordings.Driver` with what belongs to the model replaced:
the weights (`weights`, `leaf_shapes`), the features (the reference's povey
front end, `reference/beats.py`), the reference forward, and the heads'
calibration (`calibrate_head`'s rule with no LayerNorm in front: BEATs's
predictor reads the pooled tokens as they are). The window, the tally and
the check are the recordings driver's.

`variant` "control" runs the engine on the weights rounded through float8
e4m3 (one scale per leaf), the precision below the configuration's
bfloat16, against the reference on the weights as drawn. "fault:<name>"
breaks the timed path as `FAULTS` says: the recordings faults `answer` and
`summary`, and `gate_const` (each layer's gates held at their mean) and
`alpha1` (DeepNorm's alpha taken as 1).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .. import inputs
from ..reference import ast as ref_ast
from ..reference import beats as ref_beats
from ..reference import cascade as ref_cascade
from . import recordings


def leaf_shapes(config: dict) -> dict:
    """The weights' layout, as the program and the reference read them."""
    E, H = config["embed_dim"], config["encoder_embed_dim"]
    I, L = config["encoder_ffn_embed_dim"], config["encoder_layers"]
    NH, p = config["encoder_attention_heads"], config["input_patch_size"]
    K, G = config["conv_pos"], config["conv_pos_groups"]

    def dense(i, o, layers=(L,)):
        return {"kernel": (*layers, i, o), "bias": (*layers, o)}

    def ln(width, layers=()):
        return {"scale": (*layers, width), "bias": (*layers, width)}

    return {
        "patch_embed": {"kernel": (E, 1, p, p)},
        "ln_patch": ln(E),
        "proj": dense(E, H, ()),
        "pos_conv": {"kernel": (H, H // G, K), "bias": (H,)},
        "ln_pos": ln(H),
        "rel_bias": (config["num_buckets"], NH),
        "encoder": {"q": dense(H, H), "k": dense(H, H), "v": dense(H, H),
                    "grep": dense(H // NH, 8), "grep_a": (L, NH),
                    "attn_out": dense(H, H), "ln1": ln(H, (L,)),
                    "fc1": dense(H, I), "fc2": dense(I, H),
                    "ln2": ln(H, (L,))},
        "head": {"dense": dense(H, config["num_labels"], ())},
    }


def weights(config: dict, seed: int, name: str, device) -> dict:
    """Float32 weights from one draw on the device: every leaf normal with
    std `initializer_range`, LayerNorm scales 1 plus such a draw; the
    position-bias table with std `rel_bias_std`, the gates' `grep_linear`
    leaves with std `grep_std` and `grep_a` 1 plus a draw of std
    `grep_a_std` (the configuration's `assumed` says why)."""
    flat = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat.append((path + (k,), v))

    walk(leaf_shapes(config), ())
    sizes = [int(np.prod(s)) for _, s in flat]
    buf = torch.randn(sum(sizes), generator=inputs.generator(seed, name,
                                                             device),
                      device=device)
    out: dict = {}
    for (path, shape), part in zip(flat, torch.split(buf, sizes)):
        std = (config["rel_bias_std"] if path[-1] == "rel_bias"
               else config["grep_a_std"] if path[-1] == "grep_a"
               else config["grep_std"] if "grep" in path
               else config["initializer_range"])
        leaf = part.view(shape).mul_(std)
        if path[-1] in ("scale", "grep_a"):
            leaf.add_(1.0)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def rounded_fp8(tree: dict) -> dict:
    """Every leaf rounded through float8 e4m3 with one scale per leaf (its
    largest magnitude to 448), back in float32."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = rounded_fp8(v)
        else:
            scale = v.abs().amax().clamp_min(1e-30) / ref_ast.FP8_MAX
            out[k] = (v / scale).to(torch.float8_e4m3fn).float() * scale
    return out


def calibrate_head(pooled: torch.Tensor, rate: float, band: float,
                   spread: float) -> dict:
    """`inputs.calibrate_head`'s rule on the pooled tokens themselves:
    class 1's margin reads their first principal direction, scaled to a
    standard deviation of `spread` logits, its zero in the widest gap
    between the windows' margins among the cuts that pass rate +- band."""
    z = pooled.double()
    v = torch.linalg.svd(z - z.mean(0), full_matrices=False)[2][0]
    proj = z @ v
    scale = spread / float(proj.std())
    desc = torch.sort(scale * proj, descending=True)[0].cpu().numpy()
    W = len(desc)
    k = max(range(max(1, math.ceil((rate - band) * W)),
                  min(W - 1, math.floor((rate + band) * W)) + 1),
            key=lambda k: desc[k - 1] - desc[k])
    kernel = torch.zeros(z.shape[1], 2, dtype=torch.float64, device=z.device)
    kernel[:, 1] = scale * v
    bias = torch.tensor([0.0, -0.5 * float(desc[k - 1] + desc[k])],
                        dtype=torch.float64, device=z.device)
    return {"kernel": kernel.float(), "bias": bias.float()}


class Driver(recordings.Driver):
    """See the module docstring."""

    def _features(self, pcm: np.ndarray, starts: np.ndarray) -> torch.Tensor:
        m = self.mix
        return ref_beats.window_features(
            pcm, starts, m["window_samples"], self.config["max_length"],
            m["feature_mean"], m["feature_std"], self.device)

    def _reference(self, params, feats, pooled=False):
        rows = ref_beats.rows_within(self.config, 2 ** 31)
        out = []
        with torch.no_grad():
            for i in range(0, len(feats), rows):
                logits, pool = ref_beats.forward(params, feats[i: i + rows],
                                                 self.config)
                out.append(pool if pooled else torch.softmax(logits, -1))
        return torch.cat(out)

    def setup(self) -> None:
        from zenker_audio_detection_tpu_torch.infer import cascade as C
        from zenker_audio_detection_tpu_torch.models import beats as beats_mod

        m, dev = self.mix, self.device
        self.params = [weights(self.config, self.seed, f"stage{s}", dev)
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
            params["head"]["dense"] = calibrate_head(
                pooled, rate, m["gate"]["band"], m["gate"]["spread_logits"])
        del feats
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.reference_s = time.perf_counter() - t0
        # the pool, as the recordings driver deals it
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

        fields = {f.name for f in dataclasses.fields(beats_mod.BEATsConfig)}
        cfg = beats_mod.BEATsConfig(**{key: v for key, v in self.config.items()
                                       if key in fields})
        engine_params = self.params
        if self.variant == "control":
            engine_params = [rounded_fp8(p) for p in self.params]
        specs = [C.StageSpec(params, cfg, m["feature_mean"],
                             m["feature_std"], labels)
                 for params, labels in zip(engine_params, recordings.LABELS)]
        self.engine_config = C.CascadeConfig(**m.get("engine", {}))
        self.engine = C.TwoStageEngine(*specs, self.engine_config, device=dev)
        self.done: list[recordings.Done] = []
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

    def release(self) -> None:
        from zenker_audio_detection_tpu_torch.models import beats as beats_mod

        beats_mod.relpos_gates = _GATES.get("gates", beats_mod.relpos_gates)
        super().release()


_GATES: dict = {}


def _gate_const(driver: Driver) -> None:
    """Each layer's gates held at their mean over the chunk (every query,
    head and window), in the program's forward."""
    from zenker_audio_detection_tpu_torch.models import beats as beats_mod

    gates = _GATES.setdefault("gates", beats_mod.relpos_gates)

    def held(q, lp, config):
        g = gates(q, lp, config)
        return g.mean().expand_as(g).contiguous()

    beats_mod.relpos_gates = held


def _alpha1(driver: Driver) -> None:
    """DeepNorm's residual factor taken as 1 in both stages of the engine:
    their configurations without DeepNorm."""
    engine = driver.engine
    for name in ("stage1", "stage2"):
        spec = getattr(engine, name)
        setattr(engine, name, dataclasses.replace(
            spec, config=dataclasses.replace(spec.config, deep_norm=False)))


FAULTS = {**recordings.FAULTS, "gate_const": _gate_const, "alpha1": _alpha1}
