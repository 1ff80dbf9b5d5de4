"""The idle time inside the program's spans (`portbench/spans.py`) and the
five readers built on it, on synthetic traces."""

import pytest

from portbench import harness, spans, tracing

ENGINE = {"frontend_idle_pct.infer": ("cascade.frontend",),
          "launch_idle_pct.infer": ("cascade.stage1", "cascade.stage2"),
          "sync_idle_pct.infer": ("cascade.fetch", "cascade.gate"),
          "summary_idle_pct.infer": ("cascade.summary",)}
TRAIN = {"optimizer_idle_pct.train": ("train.optimizer",)}


def trace_of(host, device=((100.0, 400.0), (600.0, 1000.0))):
    """A window of 0-1000 us whose device is busy over `device`; its gaps
    are (0, 100) and (400, 600)."""
    return tracing.Trace(0.0, 1000.0,
                         [("k", s, e, "kernel") for s, e in device],
                         [(n, s, e) for n, s, e in host])


def test_a_gap_partly_inside_a_span_counts_by_the_part_inside():
    t = trace_of([("a", 300.0, 500.0), ("aten::mm", 0.0, 1000.0)])
    assert spans.idle_s(t, ("a",)) == pytest.approx(100e-6)
    assert spans.idle_pct(t, ("a",)) == pytest.approx(10.0)


def test_a_gap_across_two_spans_counts_each_part_once():
    t = trace_of([("a", 420.0, 450.0), ("b", 550.0, 700.0),
                  ("a", 50.0, 120.0)])
    assert spans.idle_s(t, ("a", "b")) == pytest.approx((30 + 50 + 50) * 1e-6)
    assert spans.idle_s(t, ("b",)) == pytest.approx(50e-6)


def test_nested_and_overlapping_spans_count_once():
    t = trace_of([("a", 0.0, 1000.0), ("a", 50.0, 80.0),
                  ("b", 450.0, 550.0)])
    assert spans.union(t, ("a", "b")) == [[0.0, 1000.0]]
    assert spans.idle_s(t, ("a", "b")) == pytest.approx(300e-6)


def test_no_span_reads_none_and_a_span_without_idle_reads_nought():
    t = trace_of([("aten::mm", 0.0, 1000.0)])
    assert spans.idle_s(t, ("a",)) is None
    assert spans.idle_pct(t, ("a",)) is None
    t = trace_of([("a", 150.0, 350.0)])
    assert spans.idle_s(t, ("a",)) == 0.0
    assert spans.idle_s(trace_of([("a", 0, 1000)], device=()), ("a",)) \
        is None


def run_of(cell_name, trace):
    return harness.Run(harness.find(cell_name), trace, {}, {})


def each_span(names, step=100.0):
    """One span of each name, side by side from 0 us, each `step` long."""
    return [(n, i * step, (i + 1) * step) for i, n in enumerate(names)]


@pytest.mark.parametrize("metric", sorted(ENGINE))
@pytest.mark.parametrize("cell", ["ast1024.recordings_gated",
                                  "ast128.recordings_gated"])
def test_the_engine_readers(cell, metric):
    read = harness.reader(harness.find(cell).base, metric)
    names = ENGINE[metric]
    t = trace_of([("cascade.recording", 0.0, 1000.0)]
                 + [(n, 350.0 + 100 * i, 450.0 + 100 * i)
                    for i, n in enumerate(names)])
    # the gap (400, 600) holds 50 us of the first span and all 100 of a
    # second
    want = 100.0 * {1: 50, 2: 150}[len(names)] * 1e-6 / t.window_s
    assert read(run_of(cell, t)) == pytest.approx(want)
    assert read(run_of(cell, trace_of([("cascade.recording", 0, 1000)]))) \
        is None
    assert read(run_of("ast1024.finetune_b16", t)) is None


def test_the_training_reader():
    cell = harness.find("ast1024.finetune_b16")
    read = harness.reader(cell.base, "optimizer_idle_pct.train")
    t = trace_of([("train.step", 0.0, 1000.0), ("train.forward", 0, 300),
                  ("train.optimizer", 380.0, 620.0)])
    assert read(run_of(cell.name, t)) == pytest.approx(20.0)
    assert read(run_of(cell.name, trace_of([("train.step", 0, 1000)]))) \
        is None
    assert read(run_of("ast128.recordings_gated", t)) is None


def test_the_engine_shares_sum_to_no_more_than_the_device_idle():
    names = [n for v in ENGINE.values() for n in v]
    t = trace_of(each_span(names, 110.0) + [("cascade.recording", 0, 900)])
    cell = harness.find("ast128.recordings_gated")
    run = run_of(cell.name, t)
    shares = [harness.reader(cell.base, m)(run) for m in ENGINE]
    idle = harness.reader(cell.base, "device_idle_pct.infer")(run)
    assert all(s is not None for s in shares)
    assert sum(shares) == pytest.approx(30.0)  # every gap inside a span
    assert sum(shares) <= idle + 1e-9


def test_the_manifest_lists_each_reader_with_its_cells():
    entries = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for metric in ENGINE:
        assert entries[metric]["moves"] == "windows_per_s"
        assert entries[metric]["workloads"] == ["ast1024.recordings_gated",
                                                "ast128.recordings_gated"]
    assert entries["optimizer_idle_pct.train"]["moves"] == "train_step_ms"
    assert entries["optimizer_idle_pct.train"]["workloads"] == [
        "ast1024.finetune_b16"]
    assert entries["frontend_idle_pct.infer"]["layer"] == "Front end"
    for metric in list(ENGINE)[1:]:
        assert entries[metric]["layer"] == "Engine"
    for cell, names in (("ast1024.recordings_gated", ENGINE),
                        ("ast128.recordings_gated", ENGINE),
                        ("ast1024.finetune_b16", TRAIN)):
        assert set(names) <= set(harness.find(cell).per_layer)
