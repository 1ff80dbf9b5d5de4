"""Raw-dataset organizers (one-shot data cleanup, reference C2/C3): the
port's copy of the JAX package's `data/prepare.py`, over the port's
`audio/io.py`.

* organize_short_clips: utils/PrepareDataset.py — picks each specimen's
  subfolder containing "1sec" (:38), specimen_id = name.split("_")[0] (:30),
  re-writes every WAV (decoded mono, original sr) into
  `short_dir/Class/<specimen_id>/<file>.wav`.
* organize_long_audio: utils/PrepareDatasetLongAudio.py — same for
  continuous recordings: skips the Idle class (:22-23), picks subfolders
  with "long" in the name (:38-39).

Decode/encode uses the framework's own WAV codec (audio/io.py) instead of
librosa/soundfile.
"""

from __future__ import annotations

import os

from ..audio import io as aio


def _reorganize(root_dir: str, save_path: str, *, subfolder_tag: str,
                skip_classes: tuple[str, ...] = ()) -> int:
    count = 0
    os.makedirs(save_path, exist_ok=True)
    for cl in os.listdir(root_dir):
        if cl in skip_classes:
            continue
        os.makedirs(os.path.join(save_path, cl), exist_ok=True)
        for specimen in os.listdir(os.path.join(root_dir, cl)):
            specimen_id = specimen.split("_")[0]
            out_folder = os.path.join(save_path, cl, specimen_id)
            if subfolder_tag == "1sec":
                # the short reference creates the specimen dir EAGERLY
                # (PrepareDataset.py:34, before any subfolder check)...
                os.makedirs(out_folder, exist_ok=True)
            # ...while the long reference creates it lazily inside the
            # write loop (PrepareDatasetLongAudio.py:59-62): a specimen
            # with no long recordings must leave NO empty patient dir, or
            # downstream patient enumeration sees phantom patients

            spec_dir = os.path.join(root_dir, cl, specimen)
            if subfolder_tag == "1sec":
                # short organizer: case-sensitive tag, csv filter (:38)
                subfolders = [f for f in os.listdir(spec_dir)
                              if ".csv" not in f and "1sec" in f]
            else:
                # long organizer: dirs only, case-insensitive tag (:38-39)
                subfolders = [f for f in os.listdir(spec_dir)
                              if os.path.isdir(os.path.join(spec_dir, f))
                              and subfolder_tag in f.lower()]
            if not subfolders:
                print(f"[WARN] no '{subfolder_tag}' subfolder for "
                      f"{cl}/{specimen}; skipping")
                continue
            src_dir = os.path.join(root_dir, cl, specimen, subfolders[0])
            for file in os.listdir(src_dir):
                # reference filter is a substring test, not a suffix test
                # (utils/PrepareDataset.py: ".wav" in f or ".WAV" in f) —
                # keep it so the same raw tree organizes identically
                if ".wav" not in file and ".WAV" not in file:
                    continue
                wav, sr = aio.read_wav(os.path.join(src_dir, file))
                mono = wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]
                os.makedirs(out_folder, exist_ok=True)
                base, _ = os.path.splitext(file)
                # PCM16 like the reference's soundfile.write default — also
                # what keeps organized trees on the engine's int16
                # transfer fast path (audio/io.py load_audio_compact)
                aio.write_wav(os.path.join(out_folder, base + ".wav"),
                              mono, sr, dtype="int16")
                count += 1
    return count


def organize_short_clips(raw_data_dir: str, short_audio_dir: str) -> int:
    """Raw -> short-clip tree (subfolders tagged "1sec")."""
    return _reorganize(raw_data_dir, short_audio_dir, subfolder_tag="1sec")


def organize_long_audio(raw_data_dir: str, long_audio_dir: str) -> int:
    """Raw -> long-recording tree (subfolders tagged "long"; Idle skipped)."""
    return _reorganize(raw_data_dir, long_audio_dir, subfolder_tag="long",
                       skip_classes=("Idle",))
