"""WAV decode/encode and audio loading.

Replaces the reference's `torchaudio.load` / `soundfile` / `librosa` I/O
(src/test_long_audio_windows_2stage.py:53-59, utils/PrepareDataset.py:51-56)
with a dependency-free RIFF/WAVE parser. Decode is host-side by design —
it is I/O-bound and feeds device buffers (SURVEY §2.3); the compute-heavy
resample lives in ops/resample.py.

Supports PCM 8/16/24/32-bit and IEEE float32/float64, mono or multi-channel,
including the WAVE_FORMAT_EXTENSIBLE wrapper. `load_audio` reproduces the
reference's exact loading semantics: decode -> mean over channels -> resample
to 16 kHz.

Port of the JAX package's `audio/io.py`. `load_audio` takes the native C++
loader (`audio/native.py`, built at first use) when it is available, and the
pure-Python path here otherwise; that path is the native one's numerics
oracle (decode 1e-7, resample 2e-6, tests/test_torch_native_audio.py).
"""

from __future__ import annotations

import struct

import numpy as np

SAMPLING_RATE = 16000

_FMT_PCM = 1
_FMT_IEEE_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE
# corrupt-header bound — single source of truth with the resampler guard
from ..ops.resample import MAX_SAMPLE_RATE as _MAX_WAV_SAMPLE_RATE  # noqa: E402,E501


# chunk ids that legitimately trail a data chunk in real WAVs (shared with
# infer/discovery's header-only scanner): used to tell an explicitly empty
# data chunk followed by metadata apart from a streaming-recorder size
# placeholder (recorder died before finalizing the header)
KNOWN_TRAILING_CHUNKS = frozenset([
    b"LIST", b"fact", b"cue ", b"smpl", b"inst", b"bext", b"junk", b"JUNK",
    b"PAD ", b"id3 ", b"ID3 ", b"afsp", b"FLLR", b"plst", b"note", b"labl",
])


def _is_known_trailing_chunk(data: bytes, pos: int) -> bool:
    if pos + 8 > len(data):
        return False
    cid = data[pos:pos + 4]
    size = struct.unpack_from("<I", data, pos + 4)[0]
    return (cid in KNOWN_TRAILING_CHUNKS
            and pos + 8 + size <= len(data) + 1)  # +1: pad-byte slack


def find_wav_chunks(data: bytes) -> tuple[bytes | None, bytes | None]:
    """(fmt_body, data_body) from a RIFF/WAVE byte buffer, robust to
    streaming-recorder headers the way infer/discovery.wav_num_frames is:
    chunk sizes are clamped to the bytes actually present (over-declared
    sizes incl. the 0xFFFFFFFF placeholder), and a zero data size with
    bytes remaining is treated as 'runs to EOF' unless what follows parses
    as a known trailing chunk (then the data chunk really is empty).
    The single fix site for WAV header parsing — read_wav,
    load_audio_compact and discovery all share these semantics."""
    fmt = raw = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        avail = len(data) - pos - 8
        if size > avail:
            size = avail  # over-declared / 0xFFFFFFFF placeholder: clamp
        if (chunk_id == b"data" and size == 0 and avail > 0
                and not _is_known_trailing_chunk(data, pos + 8)):
            size = avail  # unfinalized header: samples run to EOF
        if chunk_id == b"fmt ":
            fmt = data[pos + 8:pos + 8 + size]
        elif chunk_id == b"data":
            raw = data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    return fmt, raw


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 array (channels, n_samples) in [-1, 1], sr).

    Matches torchaudio.load's normalization: integer PCM is scaled by
    2**(bits-1) (e.g. int16 / 32768).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt, raw = find_wav_chunks(data)

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    # corrupt-header shapes (the unfinalized streaming-recorder scenario)
    # must surface as this function's ValueError contract — not as raw
    # struct.error / ZeroDivisionError deep in the decode
    if len(fmt) < 16:
        raise ValueError(f"{path}: fmt chunk truncated ({len(fmt)} bytes)")
    (audio_format, channels, sr, _byte_rate, _block_align,
     bits) = struct.unpack_from("<HHIIHH", fmt, 0)
    if channels < 1:
        raise ValueError(f"{path}: invalid WAV channel count {channels}")
    if sr < 1 or sr > _MAX_WAV_SAMPLE_RATE:
        # u32 garbage rates (corrupt header) would drive the polyphase
        # resampler's O(sr) kernel table into a multi-GB swap-hang
        raise ValueError(f"{path}: invalid WAV sample rate {sr}")
    # a clamped (truncated mid-sample) body must not crash frombuffer:
    # drop the trailing partial sample
    bytes_per = max(bits // 8, 1)
    raw = raw[: len(raw) // bytes_per * bytes_per]
    if audio_format == _FMT_EXTENSIBLE:
        if len(fmt) < 26:
            raise ValueError(
                f"{path}: EXTENSIBLE fmt chunk truncated ({len(fmt)} bytes)")
        # actual format is the first 2 bytes of the SubFormat GUID
        audio_format = struct.unpack_from("<H", fmt, 24)[0]

    if audio_format == _FMT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    elif audio_format == _FMT_PCM:
        if bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            vals = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {audio_format}")

    n = (len(x) // channels) * channels
    wav = x[:n].reshape(-1, channels).T  # (channels, samples)
    return np.ascontiguousarray(wav), sr


def write_wav(path: str, wav: np.ndarray, sr: int, *,
              dtype: str = "int16") -> None:
    """Write mono/multichannel audio to WAV (PCM16 or float32)."""
    wav = np.asarray(wav, dtype=np.float32)
    if wav.ndim == 1:
        wav = wav[None, :]
    channels, n = wav.shape
    interleaved = wav.T.reshape(-1)

    if dtype == "int16":
        fmt_tag, bits = _FMT_PCM, 16
        body = (np.clip(interleaved, -1.0, 1.0 - 1.0 / 32768)
                * 32768.0).astype("<i2").tobytes()
    elif dtype == "float32":
        fmt_tag, bits = _FMT_IEEE_FLOAT, 32
        body = interleaved.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported dtype {dtype}")

    block_align = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, sr,
                      sr * block_align, block_align, bits)
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(body)))
        f.write(b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(body)) + body)


def load_audio_compact(path: str, target_sr: int = SAMPLING_RATE) -> np.ndarray:
    """Like `load_audio` but returns raw int16 PCM when the file is already
    mono PCM16 at target_sr (the study's recording format) — half the
    host->device transfer; the cascade engine scales int16 on device with
    bit-identical results (x * 2^-15 is exact in float32 either way).
    Falls back to the float32 path for every other format."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
            fmt, raw = find_wav_chunks(data)
            if fmt is not None and raw is not None:
                (audio_format, channels, sr, _br, _ba,
                 bits) = struct.unpack_from("<HHIIHH", fmt, 0)
                if (audio_format == _FMT_PCM and channels == 1
                        and bits == 16 and sr == target_sr):
                    return np.frombuffer(raw[: len(raw) // 2 * 2],
                                         dtype="<i2").copy()
    except (OSError, ValueError, struct.error):
        pass
    return load_audio(path, target_sr)


def load_audio(path: str, target_sr: int = SAMPLING_RATE) -> np.ndarray:
    """Reference-equivalent loader (src/test_long_audio_windows_2stage.py:53-59):
    decode -> mono channel-mean -> resample to target_sr -> 1-D float32.

    Uses the native loader (audio/native.py) when it is available; the
    pure-Python path below is the fallback and the numerics oracle."""
    from . import native

    if native.available():
        out = native.load_audio(path, target_sr)
        if out is not None:
            return out

    from ..ops import resample as R

    wav, sr = read_wav(path)
    mono = wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]
    if sr != target_sr:
        mono = R.resample(mono, sr, target_sr)
    return np.ascontiguousarray(mono, dtype=np.float32)
