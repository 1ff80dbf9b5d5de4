"""Warm-standby recycle supervisor for the streaming server.

Port of the JAX package's `cli/serve_supervisor.py`. It keeps ONE live PCM
stream served indefinitely across process recycles with zero window loss
and an exact whole-stream summary. A server that stops at its
`--rss-limit-mb` bound (or crashes) is replaced by a successor that resumes
exactly where it stopped.

    mic | python -m zenker_audio_detection_tpu_torch.cli.serve_supervisor \
              --rss-limit-mb 8192 -- --fold 1 --model-root runs

The supervisor owns stdin and pumps it to an active serve child (spawned
with `--expect-preamble --handoff --rss-limit-mb N`), forwarding the
child's JSONL verbatim. Exactness across a recycle:

- The child stops WITHOUT flushing (a flushed tail window would be
  zero-padded where the true stream has real future samples) and emits a
  handoff line `{"type": "handoff", "next_window_index", "acc"}`.
- The supervisor replays its tail buffer from sample
  `next_window_index * hop` into the successor. Window starts sit on the
  fbank frame grid (`infer/streaming.py` enforces hop % 160 == 0), so the
  successor's features and windows are bit-identical to an uninterrupted
  stream's; the preamble seeds the successor's window numbering and
  summary accumulators, so indices/start_sec stay global and the final
  summary covers the whole stream.
- With `--prewarm-standby`, a standby child (models loaded, device paths
  warmed, blocked on its preamble read) is promoted at once, hiding the
  restart. It holds a second CUDA context on the card beside the active
  child's, which a CUDA card allows (the TPU the JAX package served from
  did not). The default is one child at a time: the replay buffer absorbs
  the audio arriving during the restart and the stream catches up.

Crash recovery (child dies without a handoff): the resume point is the
last forwarded window + 1, and the accumulators are rebuilt from the
forwarded lines (`serve.fold_window_line_into_acc`): exact counts, sums to
the summation-order ULP.

The default child is `<python> -m zenker_audio_detection_tpu_torch.cli.serve`;
`--child-cmd` replaces it (a wrapper that pins the environment).
"""

import argparse
import collections
import json
import shlex
import subprocess
import sys
import threading

from . import serve

READY_MARKERS = (b"warmed up; streaming", b"models loaded")


def build_arg_parser():
    ap = argparse.ArgumentParser(
        description="Supervise the streaming server (cli.serve) across "
        "--rss-limit-mb recycles with zero window loss (args after '--' go "
        "to cli.serve).",
        usage="python -m zenker_audio_detection_tpu_torch.cli."
              "serve_supervisor [options] -- [cli.serve args]")
    ap.add_argument("--rss-limit-mb", type=float, required=True,
                    help="per-child RSS bound triggering a graceful recycle")
    ap.add_argument("--replay-buffer-sec", type=float, default=600.0,
                    help="tail audio retained for handoff replay; must "
                    "cover in-flight windows plus (without a prewarmed "
                    "standby) the successor's startup time at the live "
                    "rate. 600 s of 16 kHz pcm16 is ~19 MB")
    ap.add_argument("--prewarm-standby", action="store_true",
                    help="keep a warmed standby child for instant "
                    "promotion. It holds a second CUDA context on the "
                    "card beside the active child's, which a CUDA card "
                    "allows (budget its device memory); without it, "
                    "recycles pay the cold start from the replay buffer")
    ap.add_argument("--max-restarts-without-progress", type=int, default=3,
                    help="abort after this many consecutive child exits "
                    "that emitted no new window (supervision-loop guard)")
    ap.add_argument("--pump-bytes", type=int, default=16384,
                    help="stdin read granularity")
    ap.add_argument("--child-cmd", default=None,
                    help="command prefix for serve children (default: "
                    "'<python> -m zenker_audio_detection_tpu_torch.cli."
                    "serve'); use a wrapper script to pin the child's "
                    "environment")
    return ap


class TailBuffer:
    """Rolling byte buffer addressed by global stream byte offset."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._chunks: collections.deque = collections.deque()
        self._base = 0  # global offset of the first retained byte
        self._end = 0  # global offset one past the last retained byte
        self._held = 0

    def append(self, data: bytes) -> None:
        self._chunks.append(data)
        self._end += len(data)
        self._held += len(data)
        while self._held > self.max_bytes and len(self._chunks) > 1:
            old = self._chunks.popleft()
            self._base += len(old)
            self._held -= len(old)

    def replay_from(self, offset: int) -> bytes:
        if offset < self._base:
            raise RuntimeError(
                f"replay point (byte {offset}) fell out of the tail buffer "
                f"(oldest retained: {self._base}); raise "
                f"--replay-buffer-sec")
        out, pos = [], self._base
        for chunk in self._chunks:
            end = pos + len(chunk)
            if end > offset:
                out.append(chunk[max(0, offset - pos):])
            pos = end
        return b"".join(out)


class Child:
    """One serve process plus its output-reader threads."""

    def __init__(self, cmd, forward_out, forward_err):
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        self.handoff = None
        self.last_index = None  # last window index forwarded by THIS child
        self.windows = 0
        self.ready = threading.Event()
        self._out_thread = threading.Thread(
            target=self._read_stdout, args=(forward_out,), daemon=True)
        self._err_thread = threading.Thread(
            target=self._read_stderr, args=(forward_err,), daemon=True)
        self._out_thread.start()
        self._err_thread.start()

    def _read_stdout(self, forward):
        for raw in self.proc.stdout:
            try:
                line = json.loads(raw)
            except ValueError:
                # a crash can truncate the final line mid-write; everything
                # before it was flushed whole (serve prints line-buffered)
                sys.stderr.write("[supervisor] dropping truncated child "
                                 "output line\n")
                continue
            if line.get("type") == "handoff":
                self.handoff = line
            else:
                if line.get("type") == "window":
                    self.last_index = line["index"]
                    self.windows += 1
                forward(line, raw)

    def _read_stderr(self, forward):
        for raw in self.proc.stderr:
            if any(m in raw for m in READY_MARKERS):
                self.ready.set()
            forward(raw)

    def finish(self):
        """Wait for exit and drain both reader threads."""
        rc = self.proc.wait()
        self._out_thread.join()
        self._err_thread.join()
        return rc

    def write(self, data: bytes) -> None:
        self.proc.stdin.write(data)
        self.proc.stdin.flush()


def main(argv=None, stdin_buffer=None, stdout=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, serve_args = argv[:split], argv[split + 1:]
    else:
        serve_args = []
    args = build_arg_parser().parse_args(argv)
    if args.pump_bytes < 1:
        # read(0) returns b'' and would be mistaken for instant EOF
        raise SystemExit("--pump-bytes must be >= 1")
    if args.max_restarts_without_progress < 1:
        raise SystemExit("--max-restarts-without-progress must be >= 1")

    # validate the serve args up front with serve's own parser, and read
    # the fields the replay math depends on
    banned = {"--handoff", "--expect-preamble", "--rss-limit-mb", "--input"}
    clash = banned.intersection(serve_args)
    if clash:
        raise SystemExit(f"{sorted(clash)} are managed by the supervisor; "
                         "remove them from the cli.serve args")
    serve_ns = serve.build_arg_parser().parse_args(serve_args)
    itemsize = 2 if serve_ns.input_format == "pcm16" else 4
    hop_samples = int(serve_ns.hop_sec * 16000)  # engine's own formula

    out = stdout or sys.stdout
    stdin_buffer = (stdin_buffer if stdin_buffer is not None
                    else sys.stdin.buffer)
    child_prefix = (shlex.split(args.child_cmd) if args.child_cmd else
                    [sys.executable, "-m",
                     "zenker_audio_detection_tpu_torch.cli.serve"])
    child_cmd = child_prefix + serve_args + [
        "--expect-preamble", "--handoff",
        "--rss-limit-mb", str(args.rss_limit_mb)]

    tail = TailBuffer(int(args.replay_buffer_sec * 16000) * itemsize)
    crash_acc = serve.fresh_acc()
    state = {"offset": 0, "acc": None}
    out_lock = threading.Lock()

    def forward_out(line, raw):
        with out_lock:
            out.write(raw.decode() if isinstance(raw, bytes) else raw)
            out.flush()
        if line.get("type") == "window":
            serve.fold_window_line_into_acc(
                crash_acc, line,
                stage2_threshold=serve_ns.stage2_threshold,
                stage2_argmax=serve_ns.stage2_argmax)

    def forward_err(raw):
        sys.stderr.write(raw.decode(errors="replace"))
        sys.stderr.flush()

    def spawn():
        return Child(child_cmd, forward_out, forward_err)

    def activate(child):
        """Write the resume preamble + tail replay; child goes live."""
        preamble = {"index_offset": state["offset"], "acc": state["acc"]}
        child.write(json.dumps(preamble).encode() + b"\n")
        replay = tail.replay_from(state["offset"] * hop_samples * itemsize)
        if replay:
            child.write(replay)

    active = spawn()
    activate(active)
    standby = spawn() if args.prewarm_standby else None
    no_progress = 0
    generation = 0

    def recycle(reason: str):
        """Collect the dead child's handoff (or crash) state and promote
        the standby / a fresh child. The replay inside activate() carries
        every sample since the resume window, including any chunk whose
        write to the dead child just failed — callers must NOT re-send
        it."""
        nonlocal active, standby, no_progress, generation
        rc = active.finish()
        if rc == 3 and active.handoff is not None:
            state["offset"] = active.handoff["next_window_index"]
            state["acc"] = active.handoff["acc"]
            # the handoff acc is authoritative: re-sync the crash mirror
            crash_acc.clear()
            crash_acc.update(json.loads(json.dumps(state["acc"])))
        else:
            # crash: resume after the last forwarded window with the
            # line-rebuilt accumulators
            if active.last_index is not None:
                state["offset"] = active.last_index + 1
            state["acc"] = json.loads(json.dumps(crash_acc))
            sys.stderr.write(f"[supervisor] child exited rc={rc} without "
                             f"handoff ({reason}); crash-resuming at "
                             f"window {state['offset']}\n")
        no_progress = 0 if active.windows else no_progress + 1
        if no_progress >= args.max_restarts_without_progress:
            raise SystemExit(
                f"{no_progress} consecutive child exits with no emitted "
                "window; aborting (check the cli.serve args / stderr)")
        generation += 1
        sys.stderr.write(f"[supervisor] recycle #{generation}: resuming at "
                         f"window {state['offset']}\n")
        while True:
            active = standby if standby is not None else spawn()
            standby = None
            try:
                activate(active)
                break
            except RuntimeError as e:
                # replay point fell out of the tail buffer: unrecoverable
                # without losing windows — stop with the actionable message
                raise SystemExit(str(e)) from None
            except (BrokenPipeError, OSError):
                # the promoted child died before going live (e.g. crashed
                # during warmup); the no-progress guard bounds this loop
                rc2 = active.finish()
                no_progress += 1
                sys.stderr.write(f"[supervisor] promoted child died "
                                 f"rc={rc2} before activation\n")
                if no_progress >= args.max_restarts_without_progress:
                    raise SystemExit(
                        f"{no_progress} consecutive dead children; "
                        "aborting") from None
        if args.prewarm_standby:
            standby = spawn()

    while True:
        data = stdin_buffer.read(args.pump_bytes)
        if not data:
            break
        tail.append(data)
        try:
            active.write(data)
        except (BrokenPipeError, OSError):
            recycle("write failed")  # replay already carries this chunk
        if active.proc.poll() is not None:
            recycle("exited after write")

    # EOF: drain until a child survives to flush + summarize the whole
    # stream (the final segment can itself hit the rss bound mid-drain)
    while True:
        try:
            active.proc.stdin.close()
        except OSError:
            pass
        rc = active.finish()
        if rc == 0:
            break
        recycle(f"exited rc={rc} during final drain")
    if standby is not None:
        try:
            standby.proc.stdin.close()  # EOF-before-preamble: clean exit
        except OSError:
            pass
        standby.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
