"""The port's spans (`utils/profiling.py:span`): no `record_function`
without a profiler; under a CPU `torch.profiler`, the engine's `cascade.*`
spans of each recording in their documented order and without overlap,
`ast.attention` once a layer and stage-chunk, the train step's `train.*`
spans; and the same numbers with and without the profiler."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zenker_audio_detection_tpu_torch.infer import cascade as C
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.train import losses, optim, steps
from zenker_audio_detection_tpu_torch.utils import profiling

CFG = ast_mod.ASTConfig(hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        max_length=128, num_labels=2)
BATCH = 4
SECONDS = (3.0, 2.2)  # 5 and 3 windows of 1 s at a 0.5 s hop
ORDER = {"gated": ["frontend", "stage1", "fetch", "gate", "stage2", "fetch",
                   "summary"],
         "all": ["frontend", "stage1", "fetch", "stage2", "fetch", "summary"],
         "none": ["frontend", "stage1", "fetch", "gate", "summary"]}


def _engine(mode):
    """A small CPU engine whose stage-1 head bias sends every window to
    stage 2 ("gated", "all") or none ("none")."""
    specs = []
    for stage, labels in ((1, ("Idle", "Swallow")), (2, ("Healthy", "Zenker"))):
        params = ast_mod.init_params(np.random.default_rng(stage), CFG)
        if stage == 1:
            push = -8.0 if mode == "none" else 8.0
            params["head"]["dense"]["bias"] = torch.tensor([-push, push])
        specs.append(C.StageSpec(params, CFG, -4.0, 4.0, labels))
    return C.TwoStageEngine(
        *specs, C.CascadeConfig(batch_size=BATCH, dtype=torch.float32,
                                stage2_mode="all" if mode == "all"
                                else "gated"),
        device="cpu")


def _audios():
    rng = np.random.default_rng(7)
    return [(0.1 * rng.standard_normal(int(s * C.SAMPLING_RATE)))
            .astype(np.float32) for s in SECONDS]


def _spans(prof, prefix):
    """(name, start, end) of the profiler's events named `prefix*`, in
    order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda s: (s[1], -s[2]))


def _inside(outer, spans):
    return [s for s in spans if outer[1] <= s[1] and s[2] <= outer[2]
            and s is not outer]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_without_a_profiler_no_span_enters_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b")
    engine = _engine("gated")
    engine.run_patient(["a.wav", "b.wav"], _audios())
    params = ast_mod.init_params(np.random.default_rng(0), CFG)
    tx = optim.make_optimizer(1e-3, 10, 0.0, 0.01)
    step = steps.make_train_step(tx, CFG, losses.stage1_loss,
                                 dtype=torch.float32)
    step(params, tx.init(params), torch.randn(2, CFG.max_length, 128),
         torch.tensor([0, 1]))


@pytest.mark.parametrize("mode", sorted(ORDER))
def test_each_recording_gives_its_spans_in_order_without_overlap(mode):
    engine = _engine(mode)
    audios = _audios()
    plain = engine.run_patient(["a.wav", "b.wav"], audios)
    traced, prof = _traced(
        lambda: engine.run_patient(["a.wav", "b.wav"], audios))
    assert traced == plain
    spans = _spans(prof, "cascade.")
    recordings = [s for s in spans if s[0] == "cascade.recording"]
    assert len(recordings) == len(audios)
    inside = set()
    for rec in recordings:
        children = _inside(rec, spans)
        assert [n[len("cascade."):] for n, _, _ in children] == ORDER[mode]
        assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))
        inside |= set(children)
    # the patient's JSON, after the recordings
    rest = [s for s in spans if s not in inside and s not in recordings]
    assert [s[0] for s in rest] == ["cascade.summary"]
    assert rest[0][1] >= recordings[-1][2]


@pytest.mark.parametrize("mode", ["gated", "all"])
def test_attention_is_one_span_a_layer_and_stage_chunk(mode):
    engine = _engine(mode)
    _, prof = _traced(lambda: engine.run_patient(["a.wav", "b.wav"],
                                                 _audios()))
    attention = _spans(prof, "ast.attention")
    stages = _spans(prof, "cascade.stage")
    assert len(stages) == 2 * len(SECONDS)
    for stage in stages:
        windows = int(2 * SECONDS[stages.index(stage) // 2] - 1)
        chunks = -(-windows // BATCH)  # every window passes the gate
        assert len(_inside(stage, attention)) == \
            CFG.num_hidden_layers * chunks
    assert len(attention) == sum(len(_inside(s, attention)) for s in stages)


def test_window_probs_are_bitwise_the_same_under_the_profiler():
    engine = _engine("gated")
    audio = _audios()[0]
    p1, p2 = engine.window_probs(audio)
    (q1, q2), _ = _traced(lambda: engine.window_probs(audio))
    assert p2.any()
    np.testing.assert_array_equal(p1, q1)
    np.testing.assert_array_equal(p2, q2)


@pytest.mark.parametrize("accum", [False, True])
def test_a_train_step_gives_its_spans_and_the_same_parameters(accum):
    params = ast_mod.init_params(np.random.default_rng(0), CFG)
    tx = optim.make_optimizer(1e-3, 10, 0.0, 0.01)
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal(
        (4, CFG.max_length, 128)).astype(np.float32))
    labels = torch.tensor([0, 1, 1, 0])
    if accum:
        grad_step, apply_step = steps.make_accum_steps(
            tx, CFG, losses.stage1_loss, dtype=torch.float32)

        def step():
            buf = optim.tree_map(torch.zeros_like, params)
            buf, _, _ = grad_step(params, buf, feats, labels)
            return apply_step(params, tx.init(params), buf, 1)[0]
    else:
        train_step = steps.make_train_step(tx, CFG, losses.stage1_loss,
                                           dtype=torch.float32)

        def step():
            return train_step(params, tx.init(params), feats, labels)[0]

    plain = step()
    traced, prof = _traced(step)
    for (path, a), (_, b) in zip(optim.tree_items(plain),
                                 optim.tree_items(traced)):
        assert torch.equal(a, b), path
    spans = _spans(prof, "train.")
    outer = [s for s in spans if s[0] == "train.step"]
    inner = [[n for n, _, _ in _inside(o, spans)] for o in outer]
    if accum:
        assert inner == [["train.forward", "train.backward"],
                         ["train.optimizer"]]
    else:
        assert inner == [["train.forward", "train.backward",
                          "train.optimizer"]]
    attention = _spans(prof, "ast.attention")
    forward = [s for s in spans if s[0] == "train.forward"][0]
    assert len(_inside(forward, attention)) == CFG.num_hidden_layers
