"""Patient-level cross-validation splits and two-stage dataset derivation.

The port's copy of the JAX package's `data/splits.py`, which reproduces
(bit for bit on identical directory trees) the artifact contract of the
reference's three splitters:

  * base 5-fold CV (utils/PrepareTrainingData_AST_cv.py): stratified k-fold
    (shuffle, seed 42) over pathology patients, Idle clips attached to the
    same side, npy paths/labels + CSVs + ids + per-fold meta JSONs;
  * two-stage derivation (utils/PrepareTrainingData_AST_cv_2stage.py):
    Stage-1 Idle(0)/Swallow(1), Stage-2 Healthy(0)/Zenker(1), optional
    patient-level validation split (seeded random or per-fold rotation);
  * capped variant (utils/PrepareTrainingData_AST_cv_2stage_capped.py):
    Stage-2-only per-patient file caps with seeds (seed+fold) / (seed+fold+100).

The JAX module draws its folds from sklearn's `StratifiedKFold`; the port
draws them from `stratified_kfold`, a numpy function that gives sklearn's
folds for the same seed (sklearn is not needed to run the port).

Determinism notes: patient enumeration preserves `os.listdir` order exactly
like the reference (sorting would silently change fold membership), and the
validation split uses `np.random.default_rng(seed)` consumed in the same
sequence.
"""

from __future__ import annotations

import json
import os
import warnings
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path

import numpy as np

CLASS_TO_INDEX = {"Idle": 0, "Healthy": 1, "Zenker": 2}
INDEX_TO_CLASS = {v: k for k, v in CLASS_TO_INDEX.items()}
PATHO_CLASSES = ("Healthy", "Zenker")
STAGE2_LABEL_MAPPING = {"Healthy": 0, "Zenker": 1}


def extract_patient_id(fp: str) -> str:
    """Patient id = path component after the class folder
    (utils/PrepareTrainingData_AST_cv_2stage.py:74-79)."""
    parts = str(fp).split("/")
    for i, token in enumerate(parts):
        if token in CLASS_TO_INDEX and i + 1 < len(parts):
            return parts[i + 1]
    return "UNKNOWN"


def derive_specimen_ids(paths) -> list[str]:
    """Sorted unique "Class/<pid>" ids (…_2stage.py:283-293)."""
    ids = set()
    for fp in paths:
        parts = str(fp).split("/")
        for i, token in enumerate(parts):
            if token in CLASS_TO_INDEX and i + 1 < len(parts):
                ids.add(f"{token}/{parts[i + 1]}")
                break
    return sorted(ids)


def _dist(labels) -> dict[int, int]:
    u, c = np.unique(np.asarray(labels, dtype=int), return_counts=True)
    return {int(k): int(v) for k, v in zip(u, c)}


def _paths_array(arr) -> np.ndarray:
    """Path list -> the reference scripts' on-disk encoding: a plain
    unicode ('<U') array, loadable WITHOUT allow_pickle — the reference's
    own consumers (compute_ast_normalization_stats.py:60, the trainers'
    np.load at train_ast_stage1_cross_validation.py:345-348) load these
    files with the default allow_pickle=False, so a dtype=object (pickled)
    save would crash them. Empty lists keep the 2stage reference's own
    quirk of an empty OBJECT array (PrepareTrainingData_AST_cv_2stage.py
    :219,:252)."""
    if len(arr) == 0:
        return np.empty((0,), dtype=object)
    return np.asarray([str(p) for p in arr])


def _save_paths(path, arr):
    np.save(path, _paths_array(arr))


def _write_csv(path, header, rows):
    with open(path, "w") as f:
        f.write(header + "\n")
        for file, lbl in rows:
            f.write(f"{file},{lbl}\n")


def _write_lines(path, lines):
    with open(path, "w") as f:
        for line in lines:
            f.write(str(line) + "\n")


# ---------------------------------------------------------------------------
# Stratified k-fold (sklearn's StratifiedKFold(shuffle=True), in numpy)
# ---------------------------------------------------------------------------


def stratified_kfold(y, n_splits: int,
                     seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(train, test) index arrays of sklearn 1.9's
    `StratifiedKFold(n_splits, shuffle=True, random_state=seed).split(X, y)`
    (`_make_test_folds`): classes are numbered by first appearance, each
    fold's share of a class comes from a round robin over the sorted
    labels, and each class's fold numbers are shuffled by one
    `np.random.RandomState(seed)` in class order. The same errors and
    warning as sklearn's."""
    if not isinstance(n_splits, (int, np.integer)) or n_splits < 2:
        raise ValueError(
            "k-fold cross-validation requires at least one train/test split "
            f"by setting n_splits=2 or more, got n_splits={n_splits}.")
    y = np.asarray(y)
    if n_splits > len(y):
        raise ValueError(
            f"Cannot have number of splits n_splits={n_splits} greater than "
            f"the number of samples: n_samples={len(y)}.")
    rng = np.random.RandomState(seed)

    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    # y_inv numbers the classes in sorted order; renumber them by first
    # appearance, as sklearn does
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]

    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    min_groups = np.min(y_counts)
    if np.all(n_splits > y_counts):
        raise ValueError("n_splits=%d cannot be greater than the"
                         " number of members in each class." % n_splits)
    if n_splits > min_groups:
        warnings.warn("The least populated class in y has only %d"
                      " members, which is less than n_splits=%d."
                      % (min_groups, n_splits), UserWarning)

    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class

    indices = np.arange(len(y))
    return [(indices[test_folds != i], indices[test_folds == i])
            for i in range(n_splits)]


# ---------------------------------------------------------------------------
# Base 5-fold CV (C4)
# ---------------------------------------------------------------------------


def make_base_cv_splits(dataset_root: str, output_dir: str,
                        num_folds: int = 5, seed: int = 42) -> list[dict]:
    """Patient-level stratified k-fold over Healthy/Zenker, Idle attached.

    The dataset tree is `dataset_root/Class/<patient>/**.wav`. Enumeration
    order matches the reference's `os.listdir` usage so identical trees give
    identical folds.
    """
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "class_mapping.json", "w") as f:
        json.dump(CLASS_TO_INDEX, f, indent=2)

    class_specimens = {
        cl: os.listdir(os.path.join(dataset_root, cl))
        for cl in os.listdir(dataset_root)
    }

    patho_subjects = np.array(
        [(s, p) for p in PATHO_CLASSES for s in class_specimens.get(p, [])])
    fold_sets = [
        (set(patho_subjects[tr, 0].tolist()), set(patho_subjects[te, 0].tolist()))
        for tr, te in stratified_kfold(patho_subjects[:, 1], num_folds, seed)
    ]

    def folder_files(cls, specimen):
        folder = os.path.join(dataset_root, cls, specimen)
        return [os.path.join(folder, "", f) for f in os.listdir(folder)
                if f.endswith(".wav")]

    metas = []
    for fold_idx, (train_subjects, test_subjects) in enumerate(fold_sets, start=1):
        split = {"train": ([], [], []), "test": ([], [], [])}  # x, y, ids

        for cls in PATHO_CLASSES:
            for side, subjects in (("train", train_subjects), ("test", test_subjects)):
                x, y, ids = split[side]
                # .get: a missing pathology class dir proceeds with
                # one-class folds like the reference's defaultdict(list)
                for specimen in sorted(s for s in class_specimens.get(cls, [])
                                       if s in subjects):
                    files = folder_files(cls, specimen)
                    x.extend(files)
                    y.extend([CLASS_TO_INDEX[cls]] * len(files))
                    ids.append(f"{cls}/{specimen}")

        for specimen in sorted(class_specimens.get("Idle", [])):
            side = ("train" if specimen in train_subjects
                    else "test" if specimen in test_subjects else None)
            if side:
                x, y, ids = split[side]
                files = folder_files("Idle", specimen)
                x.extend(files)
                y.extend([CLASS_TO_INDEX["Idle"]] * len(files))
                ids.append(f"Idle/{specimen}")

        for side in ("train", "test"):
            x, y, ids = split[side]
            _save_paths(out / f"{side}_x_fold{fold_idx}.npy", x)
            np.save(out / f"{side}_y_fold{fold_idx}.npy", np.asarray(y))
            _write_csv(out / f"{side}_labels_fold{fold_idx}.csv",
                       "file,label", zip(x, y))
            _write_lines(out / f"{side}_ids_fold{fold_idx}.txt", ids)

        meta = {
            "fold": fold_idx,
            "train_pathology_subjects": sorted(train_subjects),
            "test_pathology_subjects": sorted(test_subjects),
            "num_train_pathology_subjects": len(train_subjects),
            "num_test_pathology_subjects": len(test_subjects),
            "idle_in_train_subjects": sorted(
                s for s in train_subjects if s in class_specimens.get("Idle", [])),
            "idle_in_test_subjects": sorted(
                s for s in test_subjects if s in class_specimens.get("Idle", [])),
            "num_train_files": len(split["train"][0]),
            "num_test_files": len(split["test"][0]),
            "file_class_distribution_train": {
                INDEX_TO_CLASS[k]: v for k, v in _dist(split["train"][1]).items()},
            "file_class_distribution_test": {
                INDEX_TO_CLASS[k]: v for k, v in _dist(split["test"][1]).items()},
            "labels_mapping": CLASS_TO_INDEX,
        }
        with open(out / f"fold{fold_idx}_meta.json", "w") as mf:
            json.dump(meta, mf, indent=2)
        metas.append(meta)

    unmatched = [s for s in class_specimens.get("Idle", [])
                 if s not in class_specimens.get("Healthy", [])
                 and s not in class_specimens.get("Zenker", [])]
    if unmatched:
        print(f"Ignored {len(unmatched)} idle specimens with no pathology "
              f"match: {unmatched[:5]}{'...' if len(unmatched) > 5 else ''}")
    return metas


# ---------------------------------------------------------------------------
# Patient-level validation splits (C5 helpers)
# ---------------------------------------------------------------------------


def extract_patient_id_capped(fp: str) -> str:
    """Class-qualified patient key "Class/<pid>" — the CAPPED reference
    script's own id format (…_capped.py:48-55). Unlike the uncapped
    script's bare pid, this treats a patient's Idle and pathology files as
    SEPARATE split units, which changes stage-1 validation membership and
    the RNG consumption order; capped-mode splits must group this way to
    stay bit-exact with the executed capped script."""
    parts = str(fp).split("/")
    for i, token in enumerate(parts):
        if token in CLASS_TO_INDEX and i + 1 < len(parts):
            return f"{token}/{parts[i + 1]}"
    return "UNKNOWN"


def _group_by_patient(x, y, key_fn=extract_patient_id):
    patient_to_indices: dict[str, list[int]] = {}
    for idx, fp in enumerate(x):
        patient_to_indices.setdefault(key_fn(fp), []).append(idx)
    patient_label = {}
    for pid, indices in patient_to_indices.items():
        vals, counts = np.unique(np.asarray(y)[indices], return_counts=True)
        patient_label[pid] = int(vals[np.argmax(counts)])
    label_to_patients: dict[int, list[str]] = {}
    for pid, lbl in patient_label.items():
        label_to_patients.setdefault(lbl, []).append(pid)
    return patient_to_indices, label_to_patients


def _materialize(x, y, patient_to_indices, train_patients, val_patients):
    train_indices, val_indices = [], []
    for pid, indices in patient_to_indices.items():
        (val_indices if pid in val_patients else train_indices).extend(indices)
    train_indices = np.array(sorted(train_indices), dtype=int)
    val_indices = np.array(sorted(val_indices), dtype=int)
    return (x[train_indices], y[train_indices], x[val_indices], y[val_indices],
            train_patients, val_patients)


def patient_stratified_split(x, y, val_ratio: float, seed: int,
                             key_fn=extract_patient_id):
    """Seeded random patient-level split (…_2stage.py:82-119)."""
    x, y = np.asarray(x, dtype=object), np.asarray(y)
    if val_ratio <= 0:
        return (x, y, np.empty((0,), object), np.empty((0,), y.dtype),
                set(), set())
    rng = np.random.default_rng(seed)
    patient_to_indices, label_to_patients = _group_by_patient(x, y, key_fn)
    val_patients, train_patients = set(), set()
    for lbl, plist in label_to_patients.items():
        rng.shuffle(plist)
        val_count = int(round(len(plist) * val_ratio))
        if val_count >= len(plist):
            val_count = max(0, len(plist) - 1)
        val_patients.update(plist[:val_count])
        train_patients.update(plist[val_count:])
    return _materialize(x, y, patient_to_indices, train_patients, val_patients)


def patient_per_fold_split(x, y, val_ratio: float, fold: int,
                           key_fn=extract_patient_id):
    """Deterministic per-fold rotation split (…_2stage.py:122-160)."""
    x, y = np.asarray(x, dtype=object), np.asarray(y)
    if val_ratio <= 0:
        return (x, y, np.empty((0,), object), np.empty((0,), y.dtype),
                set(), set())
    patient_to_indices, label_to_patients = _group_by_patient(x, y, key_fn)
    val_patients, train_patients = set(), set()
    for lbl, plist in label_to_patients.items():
        plist_sorted = sorted(plist)
        val_count = int(round(len(plist_sorted) * val_ratio))
        if val_count >= len(plist_sorted):
            val_count = max(0, len(plist_sorted) - 1)
        rot = (fold - 1) % len(plist_sorted) if plist_sorted else 0
        rotated = plist_sorted[rot:] + plist_sorted[:rot]
        val_patients.update(rotated[:val_count])
        train_patients.update(rotated[val_count:])
    return _materialize(x, y, patient_to_indices, train_patients, val_patients)


# ---------------------------------------------------------------------------
# Stage-2 per-patient capping (C6)
# ---------------------------------------------------------------------------


def cap_files_per_patient(x, y, max_files: int, seed: int):
    """Random per-patient downsampling to max_files
    (…_capped.py:57-113); selected indices re-sorted to preserve order.
    Patient keys are "Class/<pid>" — the capped script's own id format
    (…_capped.py:48-55), kept for stats-JSON parity."""
    x, y = np.asarray(x, dtype=object), np.asarray(y)
    rng = np.random.default_rng(seed)
    patient_files: dict[str, list[int]] = defaultdict(list)
    for idx, fp in enumerate(x):
        parts = str(fp).split("/")
        key = "UNKNOWN"
        for i, token in enumerate(parts):
            if token in CLASS_TO_INDEX and i + 1 < len(parts):
                key = f"{token}/{parts[i + 1]}"
                break
        patient_files[key].append(idx)

    selected: list[int] = []
    stats = {"patients_capped": 0, "files_before": int(len(x)),
             "files_after": 0, "files_removed": 0, "patient_details": {}}
    for pid, indices in patient_files.items():
        if len(indices) > max_files:
            chosen = rng.choice(np.array(indices), size=max_files,
                                replace=False).tolist()
            stats["patients_capped"] += 1
            stats["patient_details"][pid] = {
                "before": len(indices), "after": max_files,
                "removed": len(indices) - max_files}
        else:
            chosen = indices
        selected.extend(chosen)
    selected.sort()
    stats["files_after"] = len(selected)
    stats["files_removed"] = stats["files_before"] - stats["files_after"]
    return x[selected], y[selected], stats


# ---------------------------------------------------------------------------
# Two-stage derivation (C5 + C6)
# ---------------------------------------------------------------------------


@dataclass
class TwoStageOptions:
    num_folds: int = 5
    val_ratio: float = 0.0
    seed: int = 42
    val_mode: str = "random"  # or "per-fold"
    max_files_per_patient: int | None = None  # C6 capping when set


def derive_two_stage_splits(cv_dir: str, out_stage1: str, out_stage2: str,
                            opts: TwoStageOptions = TwoStageOptions()) -> list[dict]:
    """Derive Stage-1/Stage-2 artifacts from base CV artifacts."""
    os.makedirs(out_stage1, exist_ok=True)
    os.makedirs(out_stage2, exist_ok=True)

    mapping_path = os.path.join(cv_dir, "class_mapping.json")
    if not os.path.exists(mapping_path):
        raise FileNotFoundError(
            f"class_mapping.json not found in {cv_dir}; run the base CV "
            f"splitter first")
    from ..utils.fsio import load_json_object
    class_mapping = load_json_object(mapping_path, "class mapping")
    try:
        idle_idx = class_mapping["Idle"]
        healthy_idx = class_mapping["Healthy"]
    except KeyError as e:
        raise ValueError(f"class mapping {mapping_path} is missing the "
                         f"{e} class entry") from e

    capping = opts.max_files_per_patient is not None
    if capping:
        with open(os.path.join(out_stage2, "capping_config.json"), "w") as f:
            json.dump({
                "max_files_per_patient": opts.max_files_per_patient,
                "capping_applied_to": "Stage 2 only (Healthy vs Zenker)",
                "stage1_uncapped": True,
                "seed": opts.seed,
                "val_ratio": opts.val_ratio,
            }, f, indent=2)
    all_capping_stats = {}

    # the capped script groups split patients by class-qualified keys
    # (extract_patient_id_capped docstring); the uncapped one by bare pid
    key_fn = extract_patient_id_capped if capping else extract_patient_id

    def split_fn(x, y, fold):
        if opts.val_mode == "per-fold":
            return patient_per_fold_split(x, y, opts.val_ratio, fold,
                                          key_fn=key_fn)
        return patient_stratified_split(x, y, opts.val_ratio, opts.seed,
                                        key_fn=key_fn)

    from ..utils.fsio import load_npy

    metas = []
    for fold in range(1, opts.num_folds + 1):
        paths = [os.path.join(cv_dir, f"{side}_{ax}_fold{fold}.npy")
                 for side in ("train", "test") for ax in ("x", "y")]
        if not all(os.path.exists(p) for p in paths):
            print(f"[WARN] Missing one or more base files for fold {fold}; skipping.")
            continue
        train_x = load_npy(paths[0], "base split paths", allow_pickle=True)
        train_y = load_npy(paths[1], "base split labels",
                           allow_pickle=True).astype(int)
        test_x = load_npy(paths[2], "base split paths", allow_pickle=True)
        test_y = load_npy(paths[3], "base split labels",
                          allow_pickle=True).astype(int)

        # ---- Stage 1: Idle vs Swallow (full 3-class labels for val strat) ----
        # remap to 0=Idle 1=Healthy 2=Zenker regardless of base mapping order
        def full3(yarr):
            return np.array([0 if v == idle_idx else (1 if v == healthy_idx else 2)
                             for v in yarr], dtype=int)

        train_full = full3(train_y)
        test_y_s1 = np.where(full3(test_y) == 0, 0, 1)

        tr_x1, tr_full, val_x1, val_full = train_x, train_full, \
            np.empty((0,), object), np.empty((0,), int)
        tr_pat1, val_pat1 = set(), set()
        if opts.val_ratio > 0:
            tr_x1, tr_full, val_x1, val_full, tr_pat1, val_pat1 = split_fn(
                train_x, train_full, fold)
        tr_y1 = np.where(tr_full == 0, 0, 1)
        val_y1 = np.where(val_full == 0, 0, 1) if len(val_x1) else \
            np.empty((0,), int)

        # ---- Stage 2: Healthy vs Zenker (Idle dropped) ----
        tr_mask = train_y != idle_idx
        te_mask = test_y != idle_idx
        s2_tr_x = np.asarray(train_x, object)[tr_mask]
        s2_tr_y = np.array([0 if v == healthy_idx else 1
                            for v in train_y[tr_mask]], dtype=int)
        s2_te_x = np.asarray(test_x, object)[te_mask]
        s2_te_y = np.array([0 if v == healthy_idx else 1
                            for v in test_y[te_mask]], dtype=int)

        cap_meta = None
        if capping:
            s2_tr_x, s2_tr_y, tr_cap = cap_files_per_patient(
                s2_tr_x, s2_tr_y, opts.max_files_per_patient, opts.seed + fold)
            s2_te_x, s2_te_y, te_cap = cap_files_per_patient(
                s2_te_x, s2_te_y, opts.max_files_per_patient,
                opts.seed + fold + 100)
            cap_meta = {"max_files_per_patient": opts.max_files_per_patient,
                        "train_capping": tr_cap, "test_capping": te_cap}
            all_capping_stats[f"fold{fold}"] = {"train": tr_cap, "test": te_cap}

        tr_x2, tr_y2, val_x2, val_y2 = s2_tr_x, s2_tr_y, \
            np.empty((0,), object), np.empty((0,), int)
        if opts.val_ratio > 0:
            tr_x2, tr_y2, val_x2, val_y2, _, _ = split_fn(s2_tr_x, s2_tr_y, fold)

        warnings_stage2 = []
        if len(set(tr_y2.tolist())) < 2:
            warnings_stage2.append("Stage2 train missing one of the classes")
        if len(set(s2_te_y.tolist())) < 2:
            warnings_stage2.append("Stage2 test missing one of the classes")
        if opts.val_ratio > 0 and len(val_x2) and len(set(val_y2.tolist())) < 2:
            warnings_stage2.append("Stage2 val missing one of the classes")
        if warnings_stage2:
            print(f"[WARN][Fold {fold}] {'; '.join(warnings_stage2)}")

        # ---- persist ----
        def persist(out_dir, stage, tr_x, tr_y, va_x, va_y, te_x, te_y):
            _save_paths(os.path.join(out_dir, f"train_x_fold{fold}.npy"),
                        tr_x)
            np.save(os.path.join(out_dir, f"train_y_fold{fold}.npy"), tr_y)
            if opts.val_ratio > 0:
                _save_paths(os.path.join(out_dir, f"val_x_fold{fold}.npy"),
                            va_x)
                np.save(os.path.join(out_dir, f"val_y_fold{fold}.npy"), va_y)
            _save_paths(os.path.join(out_dir, f"test_x_fold{fold}.npy"),
                        te_x)
            np.save(os.path.join(out_dir, f"test_y_fold{fold}.npy"), te_y)
            _write_csv(os.path.join(out_dir, f"train_{stage}_labels_fold{fold}.csv"),
                       f"file,label_{stage}", zip(tr_x, tr_y))
            if opts.val_ratio > 0:
                _write_csv(os.path.join(out_dir, f"val_{stage}_labels_fold{fold}.csv"),
                           f"file,label_{stage}", zip(va_x, va_y))
            _write_csv(os.path.join(out_dir, f"test_{stage}_labels_fold{fold}.csv"),
                       f"file,label_{stage}", zip(te_x, te_y))
            _write_lines(os.path.join(out_dir, f"train_ids_fold{fold}.txt"),
                         derive_specimen_ids(tr_x))
            if opts.val_ratio > 0:
                _write_lines(os.path.join(out_dir, f"val_ids_fold{fold}.txt"),
                             derive_specimen_ids(va_x) if len(va_x) else [])
            _write_lines(os.path.join(out_dir, f"test_ids_fold{fold}.txt"),
                         derive_specimen_ids(te_x))

        persist(out_stage1, "stage1", tr_x1, tr_y1, val_x1, val_y1,
                test_x, test_y_s1)
        persist(out_stage2, "stage2", tr_x2, tr_y2, val_x2, val_y2,
                s2_te_x, s2_te_y)

        meta = {
            "fold": fold,
            "stage1_train_distribution": _dist(tr_y1),
            "stage1_test_distribution": _dist(test_y_s1),
            "stage1_val_distribution": _dist(val_y1) if len(val_y1) else {},
            "stage1_num_train_files": int(len(tr_x1)),
            "stage1_num_val_files": int(len(val_x1)),
            "stage1_num_test_files": int(len(test_x)),
            "stage2_num_train_files": int(len(tr_x2)),
            "stage2_num_val_files": int(len(val_x2)),
            "stage2_num_test_files": int(len(s2_te_x)),
            "stage2_train_distribution": _dist(tr_y2),
            "stage2_val_distribution": _dist(val_y2) if len(val_y2) else {},
            "stage2_test_distribution": _dist(s2_te_y),
            "stage2_label_mapping": STAGE2_LABEL_MAPPING,
            "stage2_warnings": warnings_stage2,
            "base_class_mapping": class_mapping,
            "val_ratio": opts.val_ratio,
            "seed": opts.seed,
            "val_mode": opts.val_mode,
            "stage1_train_patients": sorted(tr_pat1),
            "stage1_val_patients": sorted(val_pat1),
            "stage2_train_patients": sorted({extract_patient_id(fp)
                                             for fp in tr_x2}),
            "stage2_val_patients": sorted({extract_patient_id(fp)
                                           for fp in val_x2}) if len(val_x2) else [],
        }
        if cap_meta:
            meta["stage2_capping"] = cap_meta
        with open(os.path.join(out_stage2, f"fold{fold}_2stage_meta.json"),
                  "w") as mf:
            json.dump(meta, mf, indent=2)
        metas.append(meta)
        print(f"Fold {fold}: Stage1 train={len(tr_y1)} val={len(val_y1)} "
              f"test={len(test_y_s1)} | Stage2 train={len(tr_y2)} "
              f"val={len(val_y2)} test={len(s2_te_y)}")

    if capping:
        with open(os.path.join(out_stage2, "capping_stats_all_folds.json"),
                  "w") as f:
            json.dump(all_capping_stats, f, indent=2)
    return metas
