"""The benchmark's BEATs cell on the CPU: the harness finds its files, a
tiny run of it is correct and its faults are not, the four new per-layer
readers read their own kind only, the operation counts at the published
sizes, and the port's `beats.*` spans under a profiler."""

import copy
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, tracing, work_beats  # noqa: E402
from portbench.kinds import recordings_beats as RB  # noqa: E402
from zenker_audio_detection_tpu_torch.models import beats  # noqa: E402

CELL = "beats1024.recordings_gated"
METRICS = ("relpos_attention_roofline_pct.beats", "mfu.beats",
           "relpos_idle_pct.beats", "device_idle_pct.beats")
TINY = dict(embed_dim=32, encoder_layers=2, encoder_embed_dim=64,
            encoder_ffn_embed_dim=128, encoder_attention_heads=2,
            conv_pos=16, conv_pos_groups=4, max_length=128)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell():
    cell = copy.deepcopy(harness.find(CELL))
    cell.config.update(TINY)
    cell.mix.update(patients=2, length_s={"low": 4, "high": 7},
                    warmup_windows=[8], trace_seconds=0.3,
                    check={"stage1_windows": 16, "stage2_windows": 8},
                    engine={"batch_size": 8})
    cell.mix["gate"]["calibration_s"] = 20
    return cell


def test_the_harness_finds_the_cell_and_its_files():
    cell = harness.find(CELL)
    assert cell.kind == "recordings_beats" and cell.chips == 1
    assert cell.end_to_end == ["windows_per_s", "setup_s"]
    assert sorted(cell.per_layer) == sorted(METRICS)
    assert set(cell.limits) == {"far", "gate_flips", "gate_set", "summary",
                                "capture"}
    assert harness.driver_class(cell.kind) is RB.Driver
    # the configuration is the published one but for the head
    cfg = cell.config
    assert (cfg["encoder_embed_dim"], cfg["encoder_ffn_embed_dim"],
            cfg["encoder_layers"], cfg["encoder_attention_heads"],
            cfg["num_buckets"], cfg["max_distance"]) == (768, 3072, 12, 12,
                                                         320, 800)
    assert list(cfg["reduced"]) == ["num_labels"]


@pytest.mark.parametrize("variant,correct", [(None, True),
                                             ("fault:answer", False),
                                             ("fault:summary", False)])
def test_a_tiny_run_checks_as_the_cell_does(variant, correct):
    out = harness.run_cell(tiny_cell(), 3000000001, 0.3, False,
                           time.perf_counter(), device="cpu",
                           variant=variant, log=lambda m: None)
    assert out["correct"] is correct
    assert out["metrics"]["windows_per_s"]["value"] > 0
    assert out["device"]["platform"] == "cpu"


def test_the_control_runs_the_engine_on_float8_weights():
    tree = {"a": torch.tensor([0.3, -1.7, 0.011]),
            "b": {"c": torch.linspace(-2, 2, 9)}}
    fp8 = RB.rounded_fp8(tree)
    for got, want in ((fp8["a"], tree["a"]), (fp8["b"]["c"],
                                              tree["b"]["c"])):
        assert got.dtype == torch.float32 and not torch.equal(got, want)
        # e4m3 keeps 3 mantissa bits: within 2^-4 of the value or of the
        # subnormal step
        assert float((got - want).abs().max()) <= \
            2 ** -4 * float(want.abs().max())


def test_the_weights_draw_the_bias_table_and_gates_as_assumed():
    config = dict(harness.find(CELL).config, **TINY)
    w = RB.weights(config, 11, "stage1", torch.device("cpu"))
    assert float(w["rel_bias"].std()) == pytest.approx(
        config["rel_bias_std"], rel=0.2)
    assert float(w["encoder"]["grep"]["kernel"].std()) == pytest.approx(
        config["grep_std"], rel=0.2)
    assert float(w["encoder"]["q"]["kernel"].std()) == pytest.approx(
        config["initializer_range"], rel=0.2)
    full = RB.weights(harness.find(CELL).config, 11, "stage1",
                      torch.device("cpu"))["encoder"]["grep_a"]  # (12, 12)
    assert float((full - 1).std()) == pytest.approx(config["grep_a_std"],
                                                    rel=0.2)
    assert float(w["encoder"]["ln1"]["scale"].mean()) == pytest.approx(
        1.0, abs=0.05)
    again = RB.weights(config, 11, "stage1", torch.device("cpu"))
    assert torch.equal(again["rel_bias"], w["rel_bias"])


def test_the_operation_counts_at_the_published_sizes():
    cfg = harness.find(CELL).config
    assert work_beats.seq_length(cfg) == 512
    assert work_beats.attention_flops(cfg, 1) * 12 == pytest.approx(9.664e9,
                                                                    rel=1e-3)
    assert work_beats.pos_conv_flops(cfg) == pytest.approx(4.832e9, rel=1e-3)
    assert work_beats.stem_flops(cfg) == pytest.approx(0.537e9, rel=1e-3)
    assert work_beats.forward_flops(cfg) == pytest.approx(102.08e9, rel=1e-3)


class _Cell:
    def __init__(self, kind, config):
        self.kind, self.config = kind, config


class _Run:
    def __init__(self, kind, launches):
        cfg = harness.find(CELL).config
        self.cell = _Cell(kind, cfg)
        # a 2 s window: 1.5 s of kernels, half of it the relpos walk;
        # the host in beats.relpos over 0.5 s of idle device
        dev = [("void (anonymous namespace)::ws_relpos_kernel<64>(...)", 0.0,
                0.75e6, "kernel"), ("nvjet_gemm", 0.75e6, 1.5e6, "kernel")]
        host = [("beats.relpos", 1.5e6, 2.0e6)]
        self.trace = tracing.Trace(0.0, 2.0e6, dev, host)
        self.tally = {"chunks": [128, 128], "stage_windows": 300,
                      "windows": 200}
        self.counters = {"mha_packed_relpos": launches}


def _read(name, run):
    return harness.reader(harness.find(CELL).base, name)(run)


def test_the_new_readers_read_their_kind_only():
    for name in METRICS:
        assert _read(name, _Run("recordings", 24)) is None
    run = _Run("recordings_beats", 24)
    cfg = run.cell.config
    flops = 12 * 2 * work_beats.attention_flops(cfg, 128)
    assert _read("relpos_attention_roofline_pct.beats", run) == \
        pytest.approx(100 * flops / 989e12 / 0.75)
    assert _read("mfu.beats", run) == pytest.approx(
        100 * 300 * work_beats.forward_flops(cfg) / 2.0 / 989e12)
    assert _read("relpos_idle_pct.beats", run) == pytest.approx(25.0)
    assert _read("device_idle_pct.beats", run) == pytest.approx(25.0)
    # a program whose launches do not agree with the chunks (or that has no
    # such kernel, as the parent has not) gives no roofline
    assert _read("relpos_attention_roofline_pct.beats",
                 _Run("recordings_beats", 23)) is None
    assert _read("relpos_attention_roofline_pct.beats",
                 _Run("recordings_beats", None)) is None


def test_the_forward_names_its_work_in_spans():
    cfg = beats.BEATsConfig(**{k: v for k, v in TINY.items()},
                            num_labels=2)
    params = beats.init_params(np.random.default_rng(0), cfg)
    x = torch.randn(2, 128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        beats.forward(params, x, cfg, attention_impl="kernel")
    names = [e.name for e in prof.events() if e.name.startswith("beats.")]
    assert names.count("beats.embed") == 1
    assert names.count("beats.relpos") == 1 + cfg.encoder_layers
    assert names.count("beats.attention") == cfg.encoder_layers
