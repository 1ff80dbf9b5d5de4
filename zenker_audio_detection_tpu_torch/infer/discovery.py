"""Patient audio-file discovery, a copy of the JAX package's
`infer/discovery.py` (reference discover_two_files,
src/test_long_audio_windows_2stage.py:119-142): recursive walk matching the
patient id as a dirpath substring, glob pattern on filenames, keep the 2
longest recordings when more than 2 match, and error unless exactly 2
remain. File length read from the WAV header (no torchaudio.info)."""

from __future__ import annotations

import fnmatch
import os
import struct


def wav_num_frames(path: str) -> int:
    """Sample count from the RIFF header (cheap torchaudio.info stand-in).

    The data-chunk size field is CLAMPED to the bytes actually present in
    the file: streaming recorders leave placeholder sizes (0 or 0xFFFFFFFF)
    that would otherwise rank a file as the shortest/longest recording
    regardless of its real length and silently change which two files the
    keep-2-longest selection picks."""
    try:
        file_size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(12)
            if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
                return 0
            block_align = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return 0
                chunk_id, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if chunk_id == b"fmt ":
                    fmt = f.read(size + (size & 1))
                    block_align = struct.unpack_from("<H", fmt, 12)[0]
                elif chunk_id == b"data":
                    avail = file_size - f.tell()
                    if size > avail:
                        # over-declared (incl. the 0xFFFFFFFF placeholder):
                        # clamp to the bytes actually present
                        size = avail
                    elif size == 0 and avail > 0 and \
                            not _looks_like_riff_chunk(f, avail):
                        # size==0 is a placeholder only when the data chunk
                        # runs to EOF (recorder never finalized the header);
                        # an explicitly empty data chunk followed by valid
                        # trailing chunks (LIST/INFO/...) really has 0 frames
                        size = avail
                    return size // block_align if block_align else 0
                else:
                    f.seek(size + (size & 1), 1)
    except Exception:
        return 0


def _looks_like_riff_chunk(f, avail: int) -> bool:
    """True if the bytes at the current position parse as a KNOWN trailing
    RIFF chunk header with a declared size fitting in the file. Position is
    restored. Used to tell an empty data chunk with trailing chunks apart
    from a streaming-recorder size placeholder; the id whitelist (shared
    with audio/io.py's byte-buffer parser so decode and ranking agree)
    keeps raw PCM payload bytes from masquerading as a header, which would
    drop a real unfinalized recording from keep-2-longest discovery."""
    from ..audio.io import KNOWN_TRAILING_CHUNKS

    pos = f.tell()
    hdr = f.read(8)
    f.seek(pos)
    if len(hdr) < 8:
        return False
    cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
    return (cid in KNOWN_TRAILING_CHUNKS
            and 8 + size <= avail + 1)  # +1: optional pad byte slack


def discover_two_files(root: str, patient_id: str,
                       pattern: str = "*.wav") -> list[str]:
    base = os.path.abspath(root)
    matches = []
    for dirpath, _, filenames in os.walk(base):
        if patient_id not in dirpath:
            continue
        for fn in filenames:
            if fnmatch.fnmatch(fn, pattern):
                matches.append(os.path.join(dirpath, fn))
    matches = sorted(matches)
    if len(matches) > 2:
        lengths = [(p, wav_num_frames(p)) for p in matches]
        matches = [p for p, _ in sorted(lengths, key=lambda x: x[1],
                                        reverse=True)[:2]]
    if len(matches) != 2:
        raise ValueError(
            f"Expected exactly 2 files for patient {patient_id}, "
            f"found {len(matches)}: {matches}")
    return matches
