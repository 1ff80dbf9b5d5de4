"""The port's StreamingCascade (infer/streaming.py) against the port's
offline engine and against the JAX package's StreamingCascade: the port's
counterparts of tests/test_streaming.py.

Every stream is fed the same audio in the same chunks as a JAX stream over
the same parameter tree, and must emit the same windows with the same
probabilities (1e-5, f32), the same gating and the same summary; and it
must equal the port's offline engine on the concatenated audio (1e-5):
any chunking (1-sample feeds, the whole file at once), gated-mode zero
rows, the single zero-padded window of a short input, the
reference-exact summary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.infer import cascade as JC
from zenker_audio_detection_tpu.infer import streaming as JS
from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu_torch.infer import cascade as C
from zenker_audio_detection_tpu_torch.infer.streaming import StreamingCascade
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert

MEAN1, STD1 = -1.1509622, 3.5340312
MEAN2, STD2 = -0.9, 2.8
SMALL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, num_mel_bins=128, max_length=128,
             num_labels=2)
LABELS = (("Idle", "Swallow"), ("Healthy", "Zenker"))


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


def jax_tree(seed):
    return jax.tree.map(np.asarray, jast.init_params(
        jax.random.PRNGKey(seed), jast.ASTConfig(**SMALL)))


@pytest.fixture(scope="module")
def trees():
    return jax_tree(0), jax_tree(1)


def engines(trees, stage2_mode="gated", **cfg_kw):
    """(port engine, JAX engine) over the same two trees, f32."""
    norms = ((MEAN1, STD1), (MEAN2, STD2))
    cfg, jcfg = ast_mod.ASTConfig(**SMALL), jast.ASTConfig(**SMALL)
    port = C.TwoStageEngine(
        *(C.StageSpec(convert.params_from_jax(t), cfg, *n, lab)
          for t, n, lab in zip(trees, norms, LABELS)),
        C.CascadeConfig(dtype=torch.float32, batch_size=64,
                        stage2_mode=stage2_mode, **cfg_kw), device="cpu")
    jeng = JC.TwoStageEngine(
        *(JC.StageSpec(t, jcfg, *n, lab)
          for t, n, lab in zip(trees, norms, LABELS)),
        JC.CascadeConfig(dtype=jnp.float32, batch_size=64,
                         stage2_mode=stage2_mode, **cfg_kw))
    return port, jeng


def make_audio(seconds, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    x = 0.05 * rng.standard_normal(n) + 0.1 * np.sin(
        2 * np.pi * 300 * np.arange(n) / 16000)
    if dtype == np.int16:
        return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    return x.astype(np.float32)


def chunks_of(audio, rng, max_chunk=30000):
    """Random chunk boundaries (empty chunks included), drawn once so both
    packages' streams get the same feeds."""
    out, i = [], 0
    while i < len(audio):
        n = int(rng.integers(0, max_chunk))
        out.append(audio[i: i + n])
        i += n
    return out


def run(stream, chunks):
    out = []
    for c in chunks:
        out.extend(stream.feed(c))
    return out + stream.flush()


def assert_stream_matches_offline(engine, audio, results, stream):
    p1_ref, p2_ref = engine.window_probs(audio)
    assert len(results) == len(p1_ref)
    assert [r.window_index for r in results] == list(range(len(p1_ref)))
    np.testing.assert_allclose(stream.stage1_probs(), p1_ref, atol=1e-5)
    np.testing.assert_allclose(stream.stage2_probs(), p2_ref, atol=1e-5)
    # identical gating decisions (zero rows in gated mode)
    assert ((np.abs(stream.stage2_probs()).sum(1) > 0)
            == (np.abs(p2_ref).sum(1) > 0)).all()
    ref_summary, _, _, _ = engine.gate_and_summarize(p1_ref, p2_ref)
    assert_summary_close(stream.summary(), ref_summary)


def assert_summary_close(got, want, atol=1e-5):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, list):
            np.testing.assert_allclose(got[k], v, atol=atol)
        else:
            assert got[k] == v or got[k] == pytest.approx(v, abs=1e-9), k


def assert_streams_match(port_results, port_stream, jax_results, jax_stream):
    """The port's stream against the JAX stream fed the same chunks."""
    assert ([(r.window_index, r.start_sample) for r in port_results]
            == [(r.window_index, r.start_sample) for r in jax_results])
    for got, want in zip(port_results, jax_results):
        np.testing.assert_allclose(got.s1_probs, want.s1_probs, atol=1e-5)
        np.testing.assert_allclose(got.s2_probs, want.s2_probs, atol=1e-5)
        assert (np.abs(got.s2_probs).sum() > 0) == (
            np.abs(want.s2_probs).sum() > 0)
    assert_summary_close(port_stream.summary(), jax_stream.summary())


def check_both(trees, audio, chunks, *, stage2_mode="gated", cfg_kw=None,
               **stream_kw):
    port, jeng = engines(trees, stage2_mode, **(cfg_kw or {}))
    stream = StreamingCascade(port, **stream_kw)
    jstream = JS.StreamingCascade(jeng, **stream_kw)
    results, jresults = run(stream, chunks), run(jstream, chunks)
    assert_stream_matches_offline(port, audio, results, stream)
    assert_streams_match(results, stream, jresults, jstream)
    return results


def test_streaming_gated_random_chunks(trees):
    audio = make_audio(12.0)
    results = check_both(trees, audio,
                         chunks_of(audio, np.random.default_rng(1)),
                         chunk_windows=8)
    # start samples follow the 0.5 s hop
    assert [r.start_sample for r in results[:3]] == [0, 8000, 16000]


def test_streaming_all_mode_single_feed(trees):
    audio = make_audio(6.0, seed=3)
    check_both(trees, audio, [audio], stage2_mode="all", chunk_windows=4)


def test_streaming_short_file_single_padded_window(trees):
    port, _ = engines(trees)
    audio = make_audio(0.3, seed=5)
    stream = StreamingCascade(port)
    assert stream.feed(audio) == []
    assert len(stream.flush()) == 1
    results = check_both(trees, audio, [audio])
    assert len(results) == 1


def test_streaming_empty_input(trees):
    results = check_both(trees, np.zeros(0, np.float32), [])
    assert len(results) == 1  # offline emits one zero-padded window


def test_streaming_ring_wraparound(trees):
    audio = make_audio(10.0, seed=7)
    # 10 s -> 19 windows -> 1048 frames >> 256-frame ring: several wraps
    check_both(trees, audio,
               chunks_of(audio, np.random.default_rng(2), max_chunk=9000),
               chunk_windows=2, capacity_frames=256)


def test_streaming_int16_matches_offline_int16(trees):
    audio = make_audio(5.0, seed=9, dtype=np.int16)
    check_both(trees, audio, chunks_of(audio, np.random.default_rng(3)),
               chunk_windows=4)


def test_streaming_mixed_dtype_chunks(trees):
    audio16 = make_audio(4.0, seed=11, dtype=np.int16)
    audio_f = audio16.astype(np.float32) / 32768.0
    half = len(audio16) // 2
    # a raw PCM chunk, then a float chunk
    check_both(trees, audio_f, [audio16[:half], audio_f[half:]],
               chunk_windows=4)


def test_streaming_emission_latency(trees):
    """With chunk_windows=1, window w is emitted by the first feed that
    completes its last sample: no buffering beyond the window itself."""
    port, _ = engines(trees)
    audio = make_audio(3.0, seed=13)
    stream = StreamingCascade(port, chunk_windows=1)
    emitted = []
    for i in range(0, len(audio), 4000):
        out = stream.feed(audio[i: i + 4000])
        fed = min(i + 4000, len(audio))
        for r in out:
            assert r.start_sample + 16000 <= fed
        emitted.extend(out)
        # every window whose samples are all fed must already be out
        expected = 0 if fed < 16000 else (fed - 16000) // 8000 + 1
        assert len(emitted) == expected
    emitted.extend(stream.flush())
    assert_stream_matches_offline(port, audio, emitted, stream)


def test_streaming_nondefault_window_geometry(trees):
    """1.2 s windows / 0.4 s hop (both on the 10 ms frame grid)."""
    audio = make_audio(7.0, seed=23)
    results = check_both(
        trees, audio,
        chunks_of(audio, np.random.default_rng(6), max_chunk=11000),
        cfg_kw=dict(window_sec=1.2, hop_sec=0.4), chunk_windows=5)
    assert results[1].start_sample == int(0.4 * 16000)


def test_streaming_int8_engine_matches_offline_int8(trees):
    """The stream uses the engine's committed (quantized) params."""
    audio = make_audio(4.0, seed=21)
    check_both(trees, audio, chunks_of(audio, np.random.default_rng(5)),
               cfg_kw=dict(int8=True), chunk_windows=4)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_warmup_leaves_the_stream_untouched(trees, dtype):
    """warmup() runs every frame block (both sample dtypes) and window
    bucket of both stages on dummy data; the ring keeps its contents and
    the stream's results are those of a stream without warmup."""
    port, _ = engines(trees)
    stream = StreamingCascade(port, chunk_windows=8)
    stream.warmup()
    assert not stream._ring.any()
    assert stream.windows_emitted == 0 and stream._next_frame == 0
    audio = make_audio(14.0, seed=17, dtype=dtype)  # 27 windows
    results = []
    for i in range(0, len(audio), 12000):
        results.extend(stream.feed(audio[i: i + 12000]))
    assert len(results) == 24  # only full batches so far
    results.extend(stream.flush())
    assert_stream_matches_offline(port, audio, results, stream)


def test_streaming_unretained_summary_matches_retained(trees):
    """retain_results=False keeps the summary exact via O(1) accumulators
    (the memory-bounded mode for indefinite live streams)."""
    port, _ = engines(trees)
    audio = make_audio(9.0, seed=25)
    retained = StreamingCascade(port, chunk_windows=4)
    unretained = StreamingCascade(port, chunk_windows=4,
                                  retain_results=False)
    for s in (retained, unretained):
        s.feed(audio)
        s.flush()
    assert unretained._results == []
    assert_summary_close(unretained.summary(), retained.summary(),
                         atol=1e-12)
    with pytest.raises(RuntimeError, match="retain_results"):
        unretained.stage1_probs()
    with pytest.raises(RuntimeError, match="retain_results"):
        unretained.stage2_probs()


def test_streaming_validation_errors(trees):
    port, _ = engines(trees)
    with pytest.raises(ValueError, match="capacity_frames"):
        StreamingCascade(port, chunk_windows=64, capacity_frames=256)
    with pytest.raises(ValueError, match="chunk_windows"):
        StreamingCascade(port, chunk_windows=0)
    stream = StreamingCascade(port)
    stream.flush()
    with pytest.raises(RuntimeError, match="flush"):
        stream.feed(np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="1-D"):
        StreamingCascade(port).feed(np.zeros((2, 100), np.float32))

    def engine(**kw):
        return C.TwoStageEngine(port.stage1, port.stage2, C.CascadeConfig(
            dtype=torch.float32, **kw), device="cpu")

    with pytest.raises(ValueError, match="frame grid"):
        StreamingCascade(engine(hop_sec=0.4755))  # 7608 % 160 != 0
    with pytest.raises(ValueError, match="must be > 0"):
        StreamingCascade(engine(hop_sec=0.0))


def test_concurrent_streams_one_engine_per_thread(trees):
    """Fleet serving: one engine and stream per thread (on the card, one
    per cuda:N). Each stream's numerics equal its own offline engine run,
    with no interference between the streams."""
    from concurrent.futures import ThreadPoolExecutor

    def serve(fold):
        port, _ = engines((jax_tree(2 * fold), jax_tree(2 * fold + 1)))
        audio = make_audio(5.0, seed=100 + fold)
        stream = StreamingCascade(port, chunk_windows=4)
        results = run(stream, chunks_of(audio, np.random.default_rng(fold)))
        return port, audio, results, stream

    with ThreadPoolExecutor(max_workers=3) as pool:
        outs = list(pool.map(serve, range(3)))
    for port, audio, results, stream in outs:
        assert_stream_matches_offline(port, audio, results, stream)
    # distinct weights per fold: the streams did not all compute one thing
    assert not np.allclose(outs[0][3].stage1_probs(),
                           outs[1][3].stage1_probs())
