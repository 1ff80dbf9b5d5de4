"""Raw-dataset organizer CLI (reference utils/PrepareDataset.py and
utils/PrepareDatasetLongAudio.py)."""

import argparse

from ..data import config as env_config, prepare


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Organize raw SwallowSet data into Class/<patient>/ trees.")
    ap.add_argument("--mode", choices=["short", "long", "both"],
                    default="short",
                    help="short = 1sec clips; long = continuous recordings")
    ap.add_argument("--raw-data-dir", help="override RAW_DATA_DIR from .env")
    ap.add_argument("--short-audio-dir", help="override SHORT_AUDIO_DIR")
    ap.add_argument("--long-audio-dir", help="override LONG_AUDIO_DIR")
    args = ap.parse_args(argv)

    cfg = env_config.load_dataset_config()
    raw = args.raw_data_dir or cfg["raw_data_dir"]
    if args.mode in ("short", "both"):
        n = prepare.organize_short_clips(
            raw, args.short_audio_dir or cfg["short_audio_dir"])
        print(f"Total files processed: {n}")
    if args.mode in ("long", "both"):
        n = prepare.organize_long_audio(
            raw, args.long_audio_dir or cfg["long_audio_dir"])
        print(f"Total long files processed: {n}")


if __name__ == "__main__":
    main()
