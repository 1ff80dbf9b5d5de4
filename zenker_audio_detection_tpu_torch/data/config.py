"""Dataset-path configuration via .env (reference utils/config.py:9-58).

Same environment-variable contract: DATASET_ROOT, RAW_DATA_DIR,
SHORT_AUDIO_DIR, LONG_AUDIO_DIR (+ LONG_AUDIO_ROOT used by the batch
drivers, .env.example:8). No python-dotenv dependency — the tiny .env
parser below handles the KEY=VALUE (+ ${VAR} interpolation) subset the
reference uses.

The port's copy of the JAX package's `data/config.py` (pure Python).
"""

from __future__ import annotations

import os
import re
from pathlib import Path

_DEFAULTS = {
    "DATASET_ROOT": "/path/to/your/datasets/New_SwallowSet",
    "RAW_DATA_DIR": "/path/to/your/datasets/New_SwallowSet/Raw",
    "SHORT_AUDIO_DIR": "/path/to/your/datasets/New_SwallowSet/Test",
    "LONG_AUDIO_DIR": "/path/to/your/datasets/New_SwallowSet/Long",
}

_VAR_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}")


def parse_env_file(path: str | Path) -> dict[str, str]:
    """Parse KEY=VALUE lines with ${VAR} interpolation against the process
    environment first, then earlier file keys — python-dotenv's
    load_dotenv(override=False) semantics (the reference's loader,
    utils/config.py): an exported variable wins over the file value both
    at lookup time AND inside interpolations, so .env-derived paths stay
    consistent with the exported root they reference."""
    out: dict[str, str] = {}
    try:
        # explicit utf-8: without it read_text uses the locale's preferred
        # encoding, so under LANG=C/latin-1 a binary .env would silently
        # decode to garbage instead of hitting the typed error below
        text = Path(path).read_text(encoding="utf-8")
    except UnicodeDecodeError as e:
        # a binary file dropped in as .env should name itself, not
        # surface as a bare UnicodeDecodeError mid-config-load
        raise ValueError(f".env file {path} is not valid UTF-8 text: "
                         f"{e}") from e
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip().strip('"').strip("'")
        value = _VAR_RE.sub(
            lambda m: os.environ.get(m.group(1)) if m.group(1) in os.environ
            else out.get(m.group(1), ""), value)
        out[key] = value
    return out


def load_dataset_config(project_root: str | Path | None = None) -> dict[str, str]:
    root = Path(project_root) if project_root else Path.cwd()
    env_path = root / ".env"
    file_vars: dict[str, str] = {}
    if env_path.exists():
        file_vars = parse_env_file(env_path)

    def get_set(key: str):
        """Set-but-empty counts as set — os.getenv/dotenv override=False
        semantics (the reference's loader), matching the ${VAR}
        interpolation rule in parse_env_file."""
        if key in os.environ:
            return os.environ[key]
        if key in file_vars:
            return file_vars[key]
        return None

    def get(key: str) -> str:
        v = get_set(key)
        return v if v is not None else _DEFAULTS[key]

    long_root = get_set("LONG_AUDIO_ROOT")
    return {
        "dataset_root": get("DATASET_ROOT"),
        "raw_data_dir": get("RAW_DATA_DIR"),
        "short_audio_dir": get("SHORT_AUDIO_DIR"),
        "long_audio_dir": get("LONG_AUDIO_DIR"),
        "long_audio_root": (long_root if long_root is not None
                            else get("LONG_AUDIO_DIR")),
    }


def get_dataset_root(**kw) -> str:
    return load_dataset_config(**kw)["dataset_root"]


def get_raw_data_dir(**kw) -> str:
    return load_dataset_config(**kw)["raw_data_dir"]


def get_short_audio_dir(**kw) -> str:
    return load_dataset_config(**kw)["short_audio_dir"]


def get_long_audio_dir(**kw) -> str:
    return load_dataset_config(**kw)["long_audio_dir"]
