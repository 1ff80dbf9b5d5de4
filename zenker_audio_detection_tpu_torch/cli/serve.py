"""Real-time streaming serving CLI.

Port of the JAX package's `cli/serve.py`. PCM audio arrives on stdin (a
microphone pipe, `sox -d -t raw ... -`, a network relay), and one JSON line
per completed 1 s window is written to stdout as soon as its probabilities
are available, followed by a final reference-exact summary line at end of
stream. Backed by `infer.streaming.StreamingCascade` (a log-mel ring on the
engine's device, offline-identical numerics).

Protocol (stdout, one JSON object per line, flushed):
  {"type": "window", "index": 0, "start_sec": 0.0,
   "stage1_probs": [p_idle, p_swallow], "stage1_pred": "Swallow",
   "stage2_probs": [p_healthy, p_zenker] | null,   # null = not gated
   "stage2_pred": "Zenker" | null}
  ...
  {"type": "summary", ...same fields as outputs/<pid>_2stage.json per_file}

Gating semantics match the batch engine exactly: `stage1_pred` uses the
thresholded rule (argmax==Swallow AND p>=--stage1-threshold), stage-2 runs
only on gated windows (unless --stage2-mode all), `stage2_pred` uses the
threshold or --stage2-argmax rule — src/test_long_audio_windows_2stage_cache.py:463-522.

A WAV path via --input simulates a live source by feeding
--simulate-chunk-sec at a time (latency rehearsal and tests).

Differences from the JAX CLI: `--attention-impl` takes `kernel` (the CUDA
kernel, default) or `torch` (its plain version), and `--device` (default
`cuda`) says where the engine runs; without a card, `cuda` raises.

Run: python -m zenker_audio_detection_tpu_torch.cli.serve --help
"""

import argparse
import json
import math
import sys

import numpy as np

from ..infer import cascade as C


def build_arg_parser():
    ap = argparse.ArgumentParser(
        description="Stream PCM from stdin through the two-stage cascade; "
        "JSONL window probabilities on stdout.")
    ap.add_argument("--stage1-model-root",
                    help="Stage1 model dir (Idle vs Swallow); auto from --fold")
    ap.add_argument("--stage2-model-root",
                    help="Stage2 model dir (Healthy vs Zenker); auto from --fold")
    ap.add_argument("--fold", type=int,
                    help="Fold number to auto-resolve model roots.")
    ap.add_argument("--model-root", default="runs",
                    help="runs root used with --fold")
    ap.add_argument("--input", default="-",
                    help="'-' = raw PCM on stdin (16 kHz mono); a .wav path "
                    "simulates a live source (--simulate-chunk-sec feeds)")
    ap.add_argument("--input-format", choices=["pcm16", "f32"],
                    default="pcm16",
                    help="stdin sample format: int16 LE or float32 LE")
    ap.add_argument("--simulate-chunk-sec", type=float, default=0.5,
                    help="feed size when --input is a WAV file")
    ap.add_argument("--read-chunk-samples", type=int, default=8000,
                    help="stdin read granularity (samples)")
    ap.add_argument("--window-sec", type=float, default=1.0)
    ap.add_argument("--hop-sec", type=float, default=0.5)
    ap.add_argument("--chunk-windows", type=int, default=8,
                    help="windows per device dispatch: smaller = lower "
                    "latency, larger = higher throughput")
    ap.add_argument("--capacity-frames", type=int, default=4096,
                    help="log-mel ring buffer capacity (10 ms frames)")
    ap.add_argument("--stage1-threshold", type=float, default=0.5)
    ap.add_argument("--stage2-threshold", type=float, default=0.5)
    ap.add_argument("--stage1-forward-min-prob", type=float, default=None)
    ap.add_argument("--stage2-argmax", action="store_true")
    ap.add_argument("--stage2-mode", choices=["gated", "all"], default="gated",
                    help="'all' runs stage-2 speculatively on every window: "
                    "one fetch round-trip less per batch = lowest decision "
                    "latency, at the cost of stage-2 compute on non-gated "
                    "windows")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--attention-impl", choices=["kernel", "torch"],
                    default="kernel",
                    help="kernel: the hand-written CUDA attention kernel; "
                         "torch: its plain PyTorch version")
    ap.add_argument("--device", default="cuda",
                    help="device the engine runs on (cuda, cuda:N or cpu)")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--no-summary", action="store_true",
                    help="suppress the final summary line")
    ap.add_argument("--rss-limit-mb", type=float, default=None,
                    help="graceful stop when process RSS exceeds this: "
                    "emits remaining windows + the final summary (with "
                    "stopped_reason='rss_limit') and exits 3 so a "
                    "supervisor can restart the stream. On a card the RSS "
                    "includes the CUDA context and pinned host buffers: "
                    "set the bound from the process's own startup RSS")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip warming the stream's device paths before "
                    "reading input (the first windows then pay the "
                    "kernel build and library initialisation)")
    ap.add_argument("--handoff", action="store_true",
                    help="with --rss-limit-mb: on the rss stop, emit a "
                    "{'type':'handoff', 'next_window_index', 'acc'} line "
                    "instead of flushing a padded tail window + summary, "
                    "so a successor process (cli.serve_supervisor) can "
                    "resume the stream with zero window loss and an exact "
                    "whole-stream summary")
    ap.add_argument("--expect-preamble", action="store_true",
                    help="read one JSON line from stdin before the PCM "
                    "bytes: {'index_offset': N, 'acc': {...}|null} — seeds "
                    "the window numbering and summary accumulators of a "
                    "resumed stream (supervisor handoff protocol)")
    return ap


def build_engine(args) -> C.TwoStageEngine:
    import torch

    from .infer_long_audio import load_stage_specs

    # resolve the device before loading the weights for nothing
    device = C.resolve_device(args.device)
    spec1, spec2 = load_stage_specs(args)
    config = C.CascadeConfig(
        window_sec=args.window_sec,
        hop_sec=args.hop_sec,
        stage1_threshold=args.stage1_threshold,
        stage2_threshold=args.stage2_threshold,
        stage1_forward_min_prob=args.stage1_forward_min_prob,
        stage2_argmax=args.stage2_argmax,
        dtype=torch.float32 if args.f32 else torch.bfloat16,
        stage2_mode=args.stage2_mode,
        attention_impl=args.attention_impl,
        int8=args.int8,
    )
    return C.TwoStageEngine(spec1, spec2, config, device=device)


def iter_input_chunks(args, stdin_buffer):
    """Yield numpy sample chunks from stdin or a simulated WAV source."""
    if args.input != "-":
        from ..audio import io as aio

        audio = aio.load_audio_compact(args.input)
        step = max(1, int(args.simulate_chunk_sec * C.SAMPLING_RATE))
        for i in range(0, len(audio), step):
            yield audio[i: i + step]
        return
    dtype = np.int16 if args.input_format == "pcm16" else np.float32
    chunk_bytes = args.read_chunk_samples * dtype().itemsize
    carry = b""
    while True:
        data = stdin_buffer.read(chunk_bytes)
        if not data:
            break
        data = carry + data
        usable = len(data) - (len(data) % dtype().itemsize)
        carry = data[usable:]
        if usable:
            yield np.frombuffer(data[:usable], dtype=dtype)
    if carry:
        print(f"[WARN] {len(carry)} trailing bytes did not form a sample",
              file=sys.stderr)


def window_line(engine: C.TwoStageEngine, r, index_offset: int = 0) -> dict:
    """One emitted window -> JSON dict, with the engine's exact gating.

    ``index_offset`` shifts the reported index/start_sec to the stream's
    global frame when this process resumed a recycled stream (handoff
    protocol): local window w == global window w + offset, starting at
    sample (w + offset) * hop."""
    cfg = engine.config
    s1 = r.s1_probs
    # gate = thresholded Swallow AND the optional forward-min-prob second
    # gate (what selects stage-2 evaluation); stage1_pred reports just the
    # thresholded rule, like the reference's aligned predictions
    gated = len(engine._gate_indices(s1[None, :])) == 1
    swallow = s1.argmax() == 1 and s1[1] >= cfg.stage1_threshold
    s1_pred = engine.stage1.label_order[1 if swallow else 0]
    line = {
        "type": "window",
        "index": int(r.window_index) + index_offset,
        "start_sec": (r.start_sample + index_offset * engine._hop)
        / C.SAMPLING_RATE,
        "stage1_probs": [float(x) for x in s1],
        "stage1_pred": s1_pred,
        "stage2_probs": None,
        "stage2_pred": None,
    }
    if gated:
        s2 = r.s2_probs
        line["stage2_probs"] = [float(x) for x in s2]
        cls = (int(np.argmax(s2)) if cfg.stage2_argmax
               else int(s2[1] >= cfg.stage2_threshold))
        line["stage2_pred"] = engine.stage2.label_order[cls]
    return line


def main(argv=None, stdin_buffer=None, stdout=None):
    args = build_arg_parser().parse_args(argv)
    if args.read_chunk_samples < 1:
        # 0 would make read(0) return b'' and be treated as instant EOF;
        # negative buffers the whole stream (read(-n)), defeating streaming
        raise SystemExit("--read-chunk-samples must be >= 1")
    if args.handoff and args.rss_limit_mb is None:
        raise SystemExit("--handoff only applies with --rss-limit-mb")
    if args.expect_preamble and args.input != "-":
        raise SystemExit("--expect-preamble requires stdin input "
                         "(--input -)")
    out = stdout or sys.stdout
    stdin_buffer = stdin_buffer if stdin_buffer is not None else sys.stdin.buffer

    from ..infer.streaming import StreamingCascade

    engine = build_engine(args)
    # retain_results=False: windows are printed as they emit, and summary()
    # runs on O(1) accumulators — memory stays bounded on infinite streams
    stream = StreamingCascade(engine, chunk_windows=args.chunk_windows,
                              capacity_frames=args.capacity_frames,
                              retain_results=False)
    print(f"[serve] models loaded; hop={args.hop_sec}s "
          f"chunk_windows={args.chunk_windows} "
          f"({args.chunk_windows * args.hop_sec:.1f}s buffering)",
          file=sys.stderr)
    if not args.no_warmup:
        stream.warmup()
        print("[serve] warmed up; streaming", file=sys.stderr)

    index_offset = 0
    if args.expect_preamble:
        # handoff protocol: one JSON control line precedes the PCM bytes,
        # carrying the global window offset + accumulator state of the
        # predecessor process (written by cli.serve_supervisor). An
        # empty line/EOF means the supervisor shut down before promoting
        # this standby — exit cleanly without touching the stream.
        line = stdin_buffer.readline()
        if not line.strip():
            print("[serve] EOF before preamble; exiting", file=sys.stderr)
            return 0
        preamble = json.loads(line)
        index_offset = int(preamble.get("index_offset", 0))
        if preamble.get("acc"):
            stream.seed_accumulators(preamble["acc"])
        print(f"[serve] resumed at window {index_offset}", file=sys.stderr)

    def emit(results):
        for r in results:
            print(json.dumps(window_line(engine, r, index_offset)),
                  file=out, flush=True)

    stopped_reason = None
    for chunk in iter_input_chunks(args, stdin_buffer):
        emit(stream.feed(chunk))
        if (args.rss_limit_mb is not None and stream.windows_emitted > 0
                and _rss_mb() > args.rss_limit_mb):
            # graceful recycle: stop at the operator's bound with a valid
            # summary (or a handoff) instead of growing until killed.
            # Gated on >=1 emitted window: a successor resuming from the
            # same point with no progress would recycle forever.
            stopped_reason = "rss_limit"
            print(f"[serve] rss {_rss_mb():.0f} MB > limit "
                  f"{args.rss_limit_mb:.0f} MB; stopping for recycle",
                  file=sys.stderr)
            break
    if stopped_reason and args.handoff:
        # no flush: the tail windows would be zero-PADDED here but are
        # completed by real future samples in the successor — flushing
        # would emit different values for windows the successor re-emits.
        # No summary either: the successor's (seeded) summary covers the
        # whole stream.
        print(json.dumps({
            "type": "handoff",
            "next_window_index": index_offset + stream.windows_emitted,
            "acc": stream.acc_state(),
        }), file=out, flush=True)
        return 3
    emit(stream.flush())
    if not args.no_summary:
        summary = {"type": "summary", **stream.summary()}
        if stopped_reason:
            summary["stopped_reason"] = stopped_reason
        print(json.dumps(_json_safe(summary)), file=out, flush=True)
    return 3 if stopped_reason else 0


def fresh_acc() -> dict:
    """Zero summary-accumulator state in the acc_state() wire format."""
    return {"n": 0, "idle": 0, "swallow": 0, "s1_sum": [0.0, 0.0],
            "eval_count": 0, "s2_sum": [0.0, 0.0], "healthy": 0,
            "zenker": 0}


def fold_window_line_into_acc(acc: dict, line: dict, *,
                              stage2_threshold: float = 0.5,
                              stage2_argmax: bool = False) -> None:
    """Fold one emitted window line back into an acc_state()-format dict.

    The supervisor's crash-recovery path: when a child dies WITHOUT a
    graceful handoff line, the successor's accumulators are reconstructed
    from the window lines already forwarded. Mirrors
    ``StreamingCascade._accumulate`` element-wise; a window was gated iff
    its ``stage2_probs`` is non-null (``window_line`` emits stage-2 fields
    exactly for gated windows, in both stage2 modes). JSON round-trips
    float64 exactly, so the rebuilt sums match the lost process's to the
    summation-order ULP."""
    s1 = line["stage1_probs"]
    acc["n"] += 1
    acc["idle" if s1[0] >= s1[1] else "swallow"] += 1  # argmax, ties -> 0
    acc["s1_sum"] = [acc["s1_sum"][0] + s1[0], acc["s1_sum"][1] + s1[1]]
    s2 = line["stage2_probs"]
    if s2 is not None:
        acc["eval_count"] += 1
        acc["s2_sum"] = [acc["s2_sum"][0] + s2[0], acc["s2_sum"][1] + s2[1]]
        z = (s2[1] > s2[0]) if stage2_argmax else (s2[1] >= stage2_threshold)
        acc["zenker" if z else "healthy"] += 1


def _rss_mb() -> float:
    """Current RSS in MB (Linux /proc; 0.0 where unavailable, which
    disables the limit rather than killing a healthy stream)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _json_safe(obj):
    """Replace non-finite floats (NaN, +/-Inf) with None for the wire.

    ``streaming.summary()`` keeps the reference-exact NaN sentinel for
    stage2_mean_probs_over_swallow when swallow windows exist but none passed
    the stage-1 gate (test_long_audio_windows_2stage.py:176-183 semantics);
    ``json.dumps`` would serialize that as the non-standard token ``NaN``
    (and an overflowing metric as ``Infinity``), breaking strict JSONL
    consumers of the one-object-per-line protocol, so the wire form is
    ``null`` while on-disk summaries keep NaN."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


if __name__ == "__main__":
    sys.exit(main())
