"""The trace reduction and the per-layer readers, on a synthetic trace in
the shape `torch.profiler` exports."""

import types

import pytest

from portbench import harness, tracing, work

WS = ("void (anonymous namespace)::ws_kernel<64, false>(CUtensorMap_st, "
      "CUtensorMap_st, __nv_bfloat16 const*, __nv_bfloat16*, float, int)")
GEMM = "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN"
ATEN = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::GeluCUDAKernelImpl(at::TensorIteratorBase&)>")
CONV = ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
        "optimized_bf16_128x128_32x3_nhwc_align8>(cutlass_tensorop)")


def events():
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    return [
        x(tracing.WINDOW_SPAN, "user_annotation", 1000.0, 1000.0),
        x(tracing.WINDOW_SPAN, "gpu_user_annotation", 1100.0, 850.0),
        x("aten::mm", "cpu_op", 1000.0, 300.0),
        x("aten::copy_", "cpu_op", 1420.0, 200.0),
        x(WS, "kernel", 1100.0, 200.0),
        x(GEMM, "kernel", 1200.0, 200.0),     # overlaps the first
        x(ATEN, "kernel", 1500.0, 50.0),
        x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1600.0, 100.0),
        x(CONV, "kernel", 1900.0, 200.0),     # runs past the window's end
        x(WS, "kernel", 500.0, 100.0),        # before the window
        {"ph": "i", "name": "marker", "ts": 1500.0},
    ]


@pytest.fixture
def trace():
    return tracing.from_chrome(events())


def test_window_and_union_of_device_intervals(trace):
    assert trace.window_s == pytest.approx(1e-3)
    assert trace.busy() == [[1100.0, 1400.0], [1500.0, 1550.0],
                            [1600.0, 1700.0], [1900.0, 2000.0]]
    assert trace.busy_s == pytest.approx(550e-6)
    assert len(trace.kernels()) == 4


def test_gaps_and_their_host_operations(trace):
    assert trace.gaps() == [(1000.0, 1100.0), (1400.0, 1500.0),
                            (1550.0, 1600.0), (1700.0, 1900.0)]
    b = trace.breakdown()
    idle = dict(map(tuple, b["idle_gaps"]))
    assert idle["aten::mm"] == pytest.approx(100e-6)
    assert idle["aten::copy_"] == pytest.approx(150e-6)
    assert idle["host (no operation)"] == pytest.approx(200e-6)
    ops = dict(map(tuple, b["device_ops"]))
    assert ops[WS[:tracing.NAME_CHARS]] == pytest.approx(200e-6)
    assert b["device_ops"][0][1] >= b["device_ops"][-1][1]


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(ValueError):
        tracing.from_chrome([e for e in events()
                             if e["name"] != tracing.WINDOW_SPAN])


def run_of(cell_name, trace, tally, counters):
    cell = harness.find(cell_name)
    return harness.Run(cell, trace, tally, counters), cell


def read(cell, name, run):
    return harness.reader(cell.base, name)(run)


def test_the_attention_roofline_counts_own_kernels_only(trace):
    chunks = [128, 8]
    run, cell = run_of("ast1024.recordings_gated", trace,
                       {"chunks": chunks, "windows": 100,
                        "stage_windows": 130, "recordings": 1},
                       {"mha_packed": 24})
    own = harness.reader(cell.base, "attention_roofline_pct.infer")
    module = own.__globals__
    assert module["own"](WS)
    assert not any(module["own"](n) for n in (GEMM, ATEN, CONV,
                                              "Memcpy HtoD", "Memset (Device)",
                                              "sm90_xmma_gemm_bf16bf16",
                                              "cudnn::bn_fw_inf_1C11"))
    s = work.Shape.of(cell.config)
    flops = 12 * (work.attention_flops(s, 128) + work.attention_flops(s, 8))
    want = 100 * flops / work.PEAK_BF16_FLOPS / 200e-6
    assert own(run) == pytest.approx(want)


def test_the_attention_roofline_reads_nothing_when_the_counter_disagrees(
        trace):
    run, cell = run_of("ast1024.recordings_gated", trace,
                       {"chunks": [128], "windows": 100,
                        "stage_windows": 130, "recordings": 1},
                       {"mha_packed": 13})
    assert read(cell, "attention_roofline_pct.infer", run) is None


def test_the_inference_readers(trace):
    run, cell = run_of("ast128.recordings_gated", trace,
                       {"chunks": [128], "windows": 100,
                        "stage_windows": 130, "recordings": 1},
                       {"mha_packed": 12})
    s = work.Shape.of(cell.config)
    assert read(cell, "mfu.infer", run) == pytest.approx(
        100 * 130 * work.forward_flops(s) / (1e-3 * work.PEAK_BF16_FLOPS))
    assert read(cell, "launches_per_window.infer", run) == pytest.approx(0.04)
    assert read(cell, "device_idle_pct.infer", run) == pytest.approx(45.0)


def test_the_training_readers(trace):
    run, cell = run_of("ast1024.finetune_b16", trace, {"steps": 2}, {})
    s = work.Shape.of(cell.config)
    assert read(cell, "mfu.train", run) == pytest.approx(
        100 * 2 * 3 * 16 * work.forward_flops(s)
        / (1e-3 * work.PEAK_BF16_FLOPS))
    assert read(cell, "launches_per_step.train", run) == pytest.approx(2.0)
    assert read(cell, "device_idle_pct.train", run) == pytest.approx(45.0)


def test_readers_of_another_kind_read_nothing(trace):
    run, cell = run_of("ast1024.finetune_b16", trace, {"steps": 2}, {})
    for name in ("attention_roofline_pct.infer", "mfu.infer",
                 "launches_per_window.infer", "device_idle_pct.infer"):
        assert read(cell, name, run) is None
    empty = types.SimpleNamespace(**{**vars(trace), "device": []})
    run, cell = run_of("ast128.recordings_gated", empty,
                       {"chunks": [], "windows": 0, "stage_windows": 0,
                        "recordings": 0}, {})
    for name in cell.per_layer:
        assert read(cell, name, run) is None
