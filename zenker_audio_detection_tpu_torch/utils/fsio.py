"""Atomic file-write and typed JSON-load helpers.

A copy of the JAX package's `utils/fsio.py`:
results that gate skip-if-exists logic are written to a sibling tmp file
and renamed into place, so a killed process never leaves a truncated file
under the final name.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any


def load_json_value(path: str, what: str = "JSON file") -> Any:
    """json.load that fails with a typed, file-naming error. Missing files
    still raise ``FileNotFoundError``."""
    try:
        with open(path) as f:
            return json.load(f)
    except ValueError as e:  # JSONDecodeError subclasses ValueError
        raise ValueError(f"{what} {path} is not valid JSON: {e}") from e


def load_json_object(path: str, what: str = "JSON config") -> dict:
    """load_json_value + require a JSON object at the top level."""
    obj = load_json_value(path, what)
    if not isinstance(obj, dict):
        raise ValueError(f"{what} {path} must be a JSON object at the top "
                         f"level, got {type(obj).__name__}")
    return obj


def load_npy(path: str, what: str = "array file",
             allow_pickle: bool = False):
    """np.load that fails with a typed, file-naming error.

    Corrupt .npy artifacts surface as path-less ValueError (truncated
    header), EOFError (zero-byte file — np.save is not atomic),
    UnpicklingError (garbage object payload), BadZipFile (a file that
    happens to start with 'PK'), or SyntaxError/TokenError (numpy
    *tokenizes the header dict as Python source* — fuzz-discovered); all
    collapse into one ValueError naming the file. Missing files still
    raise FileNotFoundError."""
    import pickle
    import tokenize
    import zipfile

    import numpy as np

    try:
        return np.load(path, allow_pickle=allow_pickle)
    except (ValueError, EOFError, pickle.UnpicklingError,
            zipfile.BadZipFile, SyntaxError, tokenize.TokenError) as e:
        raise ValueError(f"{what} {path} is corrupt or not a .npy file: "
                         f"{e}") from e


def atomic_json_dump(obj: Any, path: str, **dump_kwargs) -> None:
    """json.dump to a pid+tid-suffixed sibling tmp, then os.replace into
    place (a same-filesystem atomic rename)."""
    out_dir = os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, **dump_kwargs)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
