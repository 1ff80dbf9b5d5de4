"""The port's streaming server (cli/serve.py) and its recycle supervisor
(cli/serve_supervisor.py) against the JAX package's serve on the same model
directories and audio: the port's counterparts of tests/test_serve_cli.py
and tests/test_serve_supervisor.py. Window and summary lines must equal
the JAX serve's (probabilities at 1e-5, predictions, indices and counts
equal); a stream served through recycles must equal an uninterrupted one
line for line. The port runs with --device cpu; the supervisor's children
are real subprocesses of the port's serve."""

import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.cli import serve as jserve
from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.models import convert as jconvert
from zenker_audio_detection_tpu.train import loop as jtrain_loop
from zenker_audio_detection_tpu_torch.cli import serve, serve_supervisor
from zenker_audio_detection_tpu_torch.infer import cascade as C
from zenker_audio_detection_tpu_torch.models import convert
from zenker_audio_detection_tpu_torch.train import loop as train_loop

MEAN1, STD1 = -1.1509622, 3.5340312
MEAN2, STD2 = -0.9, 2.8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# int8 lines of the two packages: their front ends agree to f32 rounding,
# and a 1-ulp difference in a token can flip one rint decision of the
# activation quantization, which moves that token's product by one
# quantization step (read up to 2.5e-4 on the probabilities here)
INT8_TOL = 1e-3

# first-generation-only crash shim: hard-exits mid-stream after the 6th
# emitted window line, once per marker file (later children serve
# normally); drives the supervisor's crash-recovery path
CRASH_WRAPPER = f"""\
import os
import sys
sys.path.insert(0, {REPO!r})
marker = sys.argv[1]
argv = sys.argv[2:]
from zenker_audio_detection_tpu_torch.cli import serve
if not os.path.exists(marker):
    open(marker, "w").close()
    real_line = serve.window_line
    count = [0]
    def counting_line(engine, r, index_offset=0):
        line = real_line(engine, r, index_offset)
        count[0] += 1
        if count[0] > 6:
            sys.stdout.flush()
            os._exit(17)  # hard crash, no handoff line
        return line
    serve.window_line = counting_line
sys.exit(serve.main(argv))
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors (and for child
    processes, through OMP_NUM_THREADS): the suite runs in several worker
    processes on a few cores, where each process's thread pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """Two tiny stage directories exported by the JAX package, shared by
    every test of the module."""
    root = tmp_path_factory.mktemp("port_serve_models")
    cfg = jast.ASTConfig(hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         num_mel_bins=128, max_length=128, num_labels=2)
    dirs = []
    for seed, (mean, std) in [(0, (MEAN1, STD1)), (1, (MEAN2, STD2))]:
        d = str(root / f"stage{seed + 1}")
        params = jast.init_params(jax.random.PRNGKey(seed), cfg)
        jconvert.save_hf_model_dir(params, cfg, d)
        jtrain_loop.save_feature_extractor_config(d, mean, std,
                                                  max_length=cfg.max_length)
        dirs.append(d)
    return dirs


@pytest.fixture(scope="module")
def int8_dirs(model_dirs, tmp_path_factory):
    """The same stages as int8 directories written by the port."""
    root = tmp_path_factory.mktemp("port_serve_int8")
    dirs = []
    for src, name in zip(model_dirs, ("s1", "s2")):
        params, cfg = convert.load_hf_model_dir(src)
        dst = str(root / name)
        convert.save_int8_model_dir(params, cfg, dst)
        mean, std = train_loop.load_feature_extractor_config(src)
        train_loop.save_feature_extractor_config(dst, mean, std,
                                                 max_length=cfg.max_length)
        dirs.append(dst)
    return dirs


def make_audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    x = 0.05 * rng.standard_normal(n) + 0.1 * np.sin(
        2 * np.pi * 300 * np.arange(n) / 16000)
    return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)


def serve_args(dirs):
    return ["--stage1-model-root", dirs[0], "--stage2-model-root", dirs[1],
            "--f32", "--chunk-windows", "4"]


def run_main(main, argv, stdin_bytes, want_rc=0):
    out = io.StringIO()
    rc = main(argv, stdin_buffer=io.BytesIO(stdin_bytes), stdout=out)
    assert rc == want_rc
    return out.getvalue().splitlines()


def port_lines(dirs, extra, stdin_bytes, want_rc=0):
    return [json.loads(l) for l in run_main(
        serve.main, serve_args(dirs) + ["--device", "cpu"] + extra,
        stdin_bytes, want_rc)]


def jax_lines(dirs, extra, stdin_bytes, want_rc=0):
    return [json.loads(l) for l in run_main(
        jserve.main, serve_args(dirs) + extra, stdin_bytes, want_rc)]


def assert_lines_match(got, want, atol=1e-5):
    """Protocol lines of the port against the JAX serve's: same types,
    indices, start times, predictions and counts; probabilities (and the
    handoff line's accumulator sums) to atol."""
    assert [l["type"] for l in got] == [l["type"] for l in want]
    for g, w in zip(got, want):
        assert_fields_match(g, w, atol)


def assert_fields_match(got, want, atol):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            assert_fields_match(got[k], v, atol)
        elif isinstance(v, list):
            np.testing.assert_allclose(got[k], v, atol=atol, err_msg=k)
        elif isinstance(v, float):
            assert got[k] == pytest.approx(v, abs=atol), k
        else:
            assert got[k] == v, k


def offline_reference(dirs, audio):
    params1, cfg1 = convert.load_hf_model_dir(dirs[0])
    params2, cfg2 = convert.load_hf_model_dir(dirs[1])
    import torch

    engine = C.TwoStageEngine(
        C.StageSpec(params1, cfg1, MEAN1, STD1, ("Idle", "Swallow")),
        C.StageSpec(params2, cfg2, MEAN2, STD2, ("Healthy", "Zenker")),
        C.CascadeConfig(dtype=torch.float32), device="cpu")
    return engine, engine.window_probs(audio)


def test_serve_stdin_pcm16_matches_jax_and_offline(model_dirs):
    audio = make_audio(6.0)
    lines = port_lines(model_dirs, [], audio.tobytes())
    assert_lines_match(lines, jax_lines(model_dirs, [], audio.tobytes()))
    windows = [l for l in lines if l["type"] == "window"]
    assert [l["type"] for l in lines].count("summary") == 1
    engine, (p1_ref, p2_ref) = offline_reference(model_dirs, audio)
    assert len(windows) == len(p1_ref)
    np.testing.assert_allclose([w["stage1_probs"] for w in windows], p1_ref,
                               atol=1e-5)
    for w, row in zip(windows, p2_ref):
        if np.abs(row).sum() > 0:
            np.testing.assert_allclose(w["stage2_probs"], row, atol=1e-5)
            assert w["stage1_pred"] == "Swallow"
        else:
            assert w["stage2_probs"] is None and w["stage2_pred"] is None
    ref_summary, _, _, _ = engine.gate_and_summarize(p1_ref, p2_ref)
    for k, v in ref_summary.items():
        if isinstance(v, list):
            np.testing.assert_allclose(lines[-1][k], v, atol=1e-5)
        else:
            assert lines[-1][k] == v, k
    assert [w["start_sec"] for w in windows[:3]] == [0.0, 0.5, 1.0]


def test_serve_f32_stdin_and_odd_chunks(model_dirs):
    audio = (make_audio(3.0, seed=4).astype(np.float32) / 32768.0).tobytes()
    extra = ["--input-format", "f32", "--read-chunk-samples", "1111",
             "--no-summary"]
    lines = port_lines(model_dirs, extra, audio)
    assert lines and all(l["type"] == "window" for l in lines)
    assert_lines_match(lines, jax_lines(model_dirs, extra, audio))


def test_serve_wav_simulation(model_dirs, tmp_path):
    from zenker_audio_detection_tpu_torch.audio import io as aio

    audio = make_audio(2.5, seed=7)
    wav = str(tmp_path / "rec.wav")
    aio.write_wav(wav, audio.astype(np.float32) / 32768.0, 16000)
    extra = ["--input", wav, "--simulate-chunk-sec", "0.3"]
    lines = port_lines(model_dirs, extra, b"")
    assert len(lines) == 4 + 1  # 4 windows and the summary
    assert_lines_match(lines, jax_lines(model_dirs, extra, b""))


@pytest.mark.parametrize("mode", ["all", "gated"])
def test_serve_stage2_modes_and_thresholds_match_jax(model_dirs, mode):
    audio = make_audio(5.0, seed=19).tobytes()
    extra = ["--stage2-mode", mode, "--stage1-threshold", "0.45",
             "--stage2-argmax"]
    assert_lines_match(port_lines(model_dirs, extra, audio),
                       jax_lines(model_dirs, extra, audio))


def test_serve_summary_nan_serialized_as_null(model_dirs):
    """Swallow windows present but none passing an unreachable stage-1
    gate: the summary's NaN sentinel goes on the wire as null."""

    def reject_constant(_s):
        raise AssertionError("non-standard JSON constant on the wire")

    out = run_main(serve.main, serve_args(model_dirs) + [
        "--device", "cpu", "--stage1-threshold", "1.01"],
        make_audio(8.0).tobytes())
    lines = [json.loads(l, parse_constant=reject_constant) for l in out]
    summary = lines[-1]
    assert summary["stage1_swallow_windows"] > 0
    assert summary["stage2_swallow_windows_evaluated"] == 0
    assert summary["stage2_mean_probs_over_swallow"] is None


def test_json_safe_maps_all_nonfinite_to_null():
    payload = {"a": float("nan"), "b": float("inf"), "c": float("-inf"),
               "d": [1.0, float("inf")], "e": ("x", float("nan")), "f": 2}
    assert serve._json_safe(payload) == {
        "a": None, "b": None, "c": None, "d": [1.0, None], "e": ["x", None],
        "f": 2}


def test_serve_requires_model_roots():
    with pytest.raises(ValueError, match="Model roots"):
        serve.main(["--device", "cpu"], stdin_buffer=io.BytesIO(b""),
                   stdout=io.StringIO())


def test_serve_int8_model_dirs(model_dirs, int8_dirs):
    """serve --int8 over int8 directories: equal to the port's offline
    int8 engine (1e-5), to the JAX serve on the same directories at
    INT8_TOL, and within the int8 band of the f32 run."""
    import torch

    audio = make_audio(4.0, seed=11)
    lines = port_lines(int8_dirs, ["--int8"], audio.tobytes())
    assert_lines_match(lines, jax_lines(int8_dirs, ["--int8"],
                                        audio.tobytes()), atol=INT8_TOL)
    specs = [C.StageSpec(*convert.load_hf_model_dir(d), m, s, lab)
             for d, (m, s), lab in zip(int8_dirs, ((MEAN1, STD1),
                                                   (MEAN2, STD2)),
                                       (("Idle", "Swallow"),
                                        ("Healthy", "Zenker")))]
    engine = C.TwoStageEngine(*specs, C.CascadeConfig(
        dtype=torch.float32, int8=True), device="cpu")
    p1, _ = engine.window_probs(audio)
    got = np.array([l["stage1_probs"] for l in lines[:-1]])
    np.testing.assert_allclose(got, p1, atol=1e-5)
    f32 = port_lines(model_dirs, [], audio.tobytes())
    want = np.array([l["stage1_probs"] for l in f32[:-1]])
    assert np.abs(got - want).max() < 5e-2


def test_serve_rss_limit_graceful_recycle(model_dirs):
    """--rss-limit-mb: past the bound the stream stops with the remaining
    windows flushed and a summary carrying stopped_reason='rss_limit',
    exit 3; a generous bound does not trigger."""
    lines = port_lines(model_dirs, ["--rss-limit-mb", "1"],
                       make_audio(6.0, seed=5).tobytes(), want_rc=3)
    assert lines[-1]["type"] == "summary"
    assert lines[-1]["stopped_reason"] == "rss_limit"
    assert all(l["type"] == "window" for l in lines[:-1])
    lines2 = port_lines(model_dirs, ["--rss-limit-mb", "1000000"],
                        make_audio(2.5, seed=5).tobytes())
    assert lines2[-1]["type"] == "summary"
    assert "stopped_reason" not in lines2[-1]


def test_handoff_protocol_roundtrip(model_dirs):
    """--handoff + --expect-preamble: segment A hands off, a
    preamble-seeded segment B fed the replay suffix reproduces the
    uninterrupted lines and the whole-stream summary exactly; the handoff
    line equals the JAX serve's."""
    audio = make_audio(6.0, seed=33)  # 11 windows
    ref = port_lines(model_dirs, [], audio.tobytes())
    lines_a = port_lines(model_dirs, ["--rss-limit-mb", "1", "--handoff"],
                         audio.tobytes(), want_rc=3)
    handoff = lines_a[-1]
    assert handoff["type"] == "handoff"
    assert all(l["type"] == "window" for l in lines_a[:-1])
    assert handoff["next_window_index"] == len(lines_a) - 1
    assert_lines_match(lines_a, jax_lines(
        model_dirs, ["--rss-limit-mb", "1", "--handoff"], audio.tobytes(),
        want_rc=3))

    replay = audio[handoff["next_window_index"] * 8000:]
    preamble = json.dumps({"index_offset": handoff["next_window_index"],
                           "acc": handoff["acc"]}).encode() + b"\n"
    lines_b = port_lines(model_dirs, ["--expect-preamble"],
                         preamble + replay.tobytes())
    assert lines_a[:-1] + lines_b == ref


def test_preamble_and_handoff_flag_checks(model_dirs):
    args = serve_args(model_dirs) + ["--device", "cpu"]
    assert run_main(serve.main, args + ["--expect-preamble"], b"") == []
    with pytest.raises(SystemExit, match="rss-limit"):
        serve.main(args + ["--handoff"], stdin_buffer=io.BytesIO(b""),
                   stdout=io.StringIO())
    with pytest.raises(SystemExit, match="stdin"):
        serve.main(args + ["--expect-preamble", "--input", "x.wav"],
                   stdin_buffer=io.BytesIO(b""), stdout=io.StringIO())
    with pytest.raises(SystemExit, match="read-chunk-samples"):
        serve.main(args + ["--read-chunk-samples", "0"],
                   stdin_buffer=io.BytesIO(b""), stdout=io.StringIO())


def test_fold_window_lines_reproduce_summary(model_dirs):
    lines = port_lines(model_dirs, [], make_audio(5.0, seed=21).tobytes())
    summary = lines[-1]
    acc = serve.fresh_acc()
    for line in lines[:-1]:
        serve.fold_window_line_into_acc(acc, line)
    assert acc["n"] == summary["num_windows"]
    assert acc["idle"] == summary["stage1_idle_windows"]
    assert acc["swallow"] == summary["stage1_swallow_windows"]
    assert acc["eval_count"] == summary["stage2_swallow_windows_evaluated"]
    assert acc["healthy"] == summary["stage2_healthy_windows"]
    assert acc["zenker"] == summary["stage2_zenker_windows"]
    np.testing.assert_allclose(np.array(acc["s1_sum"]) / acc["n"],
                               summary["stage1_mean_probs"], rtol=1e-12)


def test_seed_accumulators_contract(model_dirs):
    import torch

    from zenker_audio_detection_tpu_torch.infer.streaming import (
        StreamingCascade)

    params1, cfg1 = convert.load_hf_model_dir(model_dirs[0])
    engine = C.TwoStageEngine(
        C.StageSpec(params1, cfg1, MEAN1, STD1, ("Idle", "Swallow")),
        C.StageSpec(params1, cfg1, MEAN2, STD2, ("Healthy", "Zenker")),
        C.CascadeConfig(dtype=torch.float32), device="cpu")
    stream = StreamingCascade(engine, chunk_windows=4, retain_results=False)
    state = json.loads(json.dumps(stream.acc_state()))
    assert state == serve.fresh_acc()
    stream.seed_accumulators(state)
    with pytest.raises(ValueError, match="missing keys"):
        stream.seed_accumulators({"n": 0})
    with pytest.raises(ValueError, match="shape"):
        stream.seed_accumulators(dict(state, s1_sum=[1.0]))
    stream.feed(make_audio(2.5, seed=1))
    with pytest.raises(RuntimeError, match="started stream"):
        stream.seed_accumulators(state)


def test_supervisor_validates_flags(model_dirs):
    for flag in ("--handoff", "--expect-preamble", "--rss-limit-mb",
                 "--input"):
        with pytest.raises(SystemExit, match="managed by the supervisor"):
            serve_supervisor.main(
                ["--rss-limit-mb", "64", "--"] + serve_args(model_dirs)
                + ([flag, "1"] if flag.endswith("mb") else [flag]),
                stdin_buffer=io.BytesIO(b""), stdout=io.StringIO())
    with pytest.raises(SystemExit, match="pump-bytes"):
        serve_supervisor.main(
            ["--rss-limit-mb", "64", "--pump-bytes", "0", "--"]
            + serve_args(model_dirs),
            stdin_buffer=io.BytesIO(b""), stdout=io.StringIO())
    with pytest.raises(SystemExit, match="max-restarts"):
        serve_supervisor.main(
            ["--rss-limit-mb", "64", "--max-restarts-without-progress", "0",
             "--"] + serve_args(model_dirs),
            stdin_buffer=io.BytesIO(b""), stdout=io.StringIO())


def test_tail_buffer_replay_and_eviction():
    tb = serve_supervisor.TailBuffer(max_bytes=10)
    tb.append(b"0123")
    tb.append(b"4567")
    assert tb.replay_from(2) == b"234567"
    tb.append(b"89ab")  # held=12 > 10: evicts the first chunk
    assert tb.replay_from(4) == b"456789ab"
    with pytest.raises(RuntimeError, match="replay-buffer-sec"):
        tb.replay_from(3)


def run_supervisor(dirs, audio_bytes, sup_flags):
    out = io.StringIO()
    rc = serve_supervisor.main(
        sup_flags + ["--"] + serve_args(dirs) + ["--device", "cpu"],
        stdin_buffer=io.BytesIO(audio_bytes), stdout=out)
    return rc, out.getvalue().splitlines()


def test_supervisor_recycles_bit_identical_to_uninterrupted(
        model_dirs, monkeypatch, capsys):
    """rss-limit 1 makes every child of the port's serve (the default
    child command) hand off after its first emitted batch; the supervised
    stream, with prewarmed standbys, reproduces the uninterrupted run
    line for line, summary included."""
    monkeypatch.chdir(REPO)  # `python -m` children import the checkout
    audio = make_audio(6.0, seed=3)  # 11 windows -> 2 handoffs at cw=4
    ref = run_main(serve.main, serve_args(model_dirs) + ["--device", "cpu"],
                   audio.tobytes())
    rc, got = run_supervisor(model_dirs, audio.tobytes(),
                             ["--rss-limit-mb", "1", "--replay-buffer-sec",
                              "120", "--prewarm-standby"])
    assert rc == 0
    assert "recycle #2" in capsys.readouterr().err, "fewer than 2 recycles"
    assert [json.loads(l) for l in got] == [json.loads(l) for l in ref]
    summary = json.loads(got[-1])
    assert summary["num_windows"] == 11 and "stopped_reason" not in summary


def test_supervisor_crash_recovery_resumes_without_loss(model_dirs, tmp_path,
                                                       capsys):
    """A hard crash (no handoff line) resumes from the last forwarded
    window with line-rebuilt accumulators: contiguous indices, windows
    equal to the uninterrupted run's, the summary to the summation-order
    ulp."""
    audio = make_audio(5.0, seed=9)  # 9 windows; the crash after 6
    ref = [json.loads(l) for l in run_main(
        serve.main, serve_args(model_dirs) + ["--device", "cpu"],
        audio.tobytes())]
    crash_py = tmp_path / "serve_crash.py"
    crash_py.write_text(CRASH_WRAPPER)
    marker = tmp_path / "crashed.marker"
    rc, got = run_supervisor(model_dirs, audio.tobytes(), [
        "--rss-limit-mb", "100000",
        "--child-cmd", f"{sys.executable} {crash_py} {marker}"])
    assert rc == 0
    assert "crash-resuming" in capsys.readouterr().err
    got = [json.loads(l) for l in got]
    assert got[:-1] == ref[:-1]
    assert [w["index"] for w in got[:-1]] == list(range(9))
    for k, v in ref[-1].items():
        if isinstance(v, list) or isinstance(v, float):
            np.testing.assert_allclose(got[-1][k], v, rtol=1e-12)
        else:
            assert got[-1][k] == v, k
