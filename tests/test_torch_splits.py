"""The port's patient-level splits (data/splits.py) and the preparation
CLIs (cli/prepare_training_data.py, cli/prepare_two_stage.py) against the
JAX package's, and its numpy stratified k-fold against sklearn's
`StratifiedKFold(shuffle=True)`.

Tolerance: none. Fold indices, the errors and the warning equal sklearn's;
every artifact (class_mapping.json, the csvs, the id lists, the meta and
capping JSONs, the .npy arrays with their dtypes) equals the JAX
splitters' bit for bit on the same tree: the fixed tree of
tests/test_splits.py and seeded random trees built as there (:232)."""

import json
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from sklearn.model_selection import StratifiedKFold

from zenker_audio_detection_tpu.data import splits as JS
from zenker_audio_detection_tpu_torch.cli import prepare_training_data
from zenker_audio_detection_tpu_torch.cli import prepare_two_stage
from zenker_audio_detection_tpu_torch.data import splits as S
from zenker_audio_detection_tpu.cli import (
    prepare_training_data as jprepare_training_data,
    prepare_two_stage as jprepare_two_stage)

from test_splits import _random_tree, make_tree


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the numpy stratified k-fold against sklearn
# ---------------------------------------------------------------------------


def _label_vectors(kind: str, n_vectors: int = 50):
    """Seeded label vectors of one kind: 2 or 3 classes, int or string
    labels, 2 to 40 samples (class counts below and above n_splits)."""
    r = np.random.default_rng({"int2": 1, "int3": 2, "str2": 3,
                               "str3": 4}[kind])
    k = int(kind[-1])
    names = np.array(["Zenker", "Healthy", "Idle"])
    out = []
    for _ in range(n_vectors):
        m = int(r.integers(k, 41))
        y = r.integers(0, k, m)
        if r.random() < 0.3:  # a rare class
            y[r.random(m) < 0.8] = 0
        out.append(names[y] if kind.startswith("str") else y * 7 - 3)
    return out


def _capture(fn):
    """(result or ("raise", type, message), warning messages)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = fn()
        except ValueError as e:
            out = ("raise", type(e), str(e))
    return out, [(w.category, str(w.message)) for w in caught]


@pytest.mark.parametrize("n_splits", [2, 3, 5])
@pytest.mark.parametrize("kind", ["int2", "int3", "str2", "str3"])
def test_stratified_kfold_equals_sklearn(kind, n_splits):
    """50 label vectors of each kind (200 in all) x 3 seeds: the same
    (train, test) folds, or the same ValueError, and the same warnings."""
    raised = 0
    for y in _label_vectors(kind):
        for seed in (0, 42, 2024):
            want, want_w = _capture(lambda: list(StratifiedKFold(
                n_splits, shuffle=True, random_state=seed).split(
                    np.zeros(len(y)), y)))
            got, got_w = _capture(lambda: S.stratified_kfold(y, n_splits,
                                                             seed))
            assert got_w == want_w, (y, seed)
            if want[0] == "raise":
                assert got == want
                raised += 1
                continue
            assert len(got) == len(want) == n_splits
            for (gtr, gte), (wtr, wte) in zip(got, want):
                assert gtr.dtype == wtr.dtype and gte.dtype == wte.dtype
                np.testing.assert_array_equal(gtr, wtr)
                np.testing.assert_array_equal(gte, wte)
    # the grid reaches both sides of the class-count limit
    assert raised < 150


def test_stratified_kfold_errors_and_warning():
    with pytest.raises(ValueError, match="cannot be greater than the number "
                                         "of members in each class"):
        S.stratified_kfold(np.array([0, 0, 1, 1]), 3, 0)
    with pytest.raises(ValueError, match="greater than the number of "
                                         "samples"):
        S.stratified_kfold(np.array([0, 1]), 3, 0)
    with pytest.raises(ValueError, match="at least one train/test split"):
        S.stratified_kfold(np.array([0, 1, 0, 1]), 1, 0)
    with pytest.warns(UserWarning, match="least populated class in y has "
                                         "only 2 members"):
        S.stratified_kfold(np.array([0] * 6 + [1, 1]), 3, 0)


def test_splits_load_no_sklearn():
    import subprocess
    import sys

    code = ("import sys\n"
            "import zenker_audio_detection_tpu_torch.data.splits\n"
            "import zenker_audio_detection_tpu_torch.cli.prepare_two_stage\n"
            "assert 'sklearn' not in sys.modules\n")
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# artifacts against the JAX splitters
# ---------------------------------------------------------------------------


def assert_same_tree(got: Path, want: Path):
    """Every file of the two output directories equal: .npy arrays in dtype
    and values, everything else byte for byte."""
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names
    for name in names:
        g, w = got / name, want / name
        if name.endswith(".npy"):
            ga = np.load(g, allow_pickle=True)
            wa = np.load(w, allow_pickle=True)
            assert ga.dtype == wa.dtype and ga.shape == wa.shape, name
            assert ga.tolist() == wa.tolist(), name
        else:
            assert g.read_bytes() == w.read_bytes(), name


def _trees():
    return ["fixed", 7000, 7001, 7002]


def _build(root: Path, which):
    if which == "fixed":
        return make_tree(root / "swallowset", None)
    return _random_tree(root / "swallowset", np.random.default_rng(which))


@pytest.fixture(scope="module")
def base_dirs(tmp_path_factory):
    """{tree: (port cv dir, JAX cv dir)} over the fixed and the random
    trees, each split by both packages."""
    out = {}
    for which in _trees():
        root = tmp_path_factory.mktemp(f"tree_{which}")
        tree = _build(root, which)
        ours, theirs = root / "ours_cv", root / "jax_cv"
        S.make_base_cv_splits(str(tree), str(ours))
        JS.make_base_cv_splits(str(tree), str(theirs))
        out[which] = ours, theirs
    return out


@pytest.mark.parametrize("which", _trees())
def test_base_cv_equals_jax(base_dirs, which):
    ours, theirs = base_dirs[which]
    assert_same_tree(ours, theirs)
    # every pathology patient is in exactly one test fold
    metas = [json.loads((ours / f"fold{k}_meta.json").read_text())
             for k in range(1, 6)]
    tests = [s for m in metas for s in m["test_pathology_subjects"]]
    assert len(tests) == len(set(tests))


@pytest.mark.parametrize("seed,num_folds", [(0, 3), (123, 5), (7, 2)])
def test_base_cv_other_seeds_and_folds_equal_jax(tmp_path, seed, num_folds):
    tree = _build(tmp_path, 7003)
    S.make_base_cv_splits(str(tree), str(tmp_path / "o"), num_folds, seed)
    JS.make_base_cv_splits(str(tree), str(tmp_path / "j"), num_folds, seed)
    assert_same_tree(tmp_path / "o", tmp_path / "j")


def test_missing_class_dir_and_unmatched_idle_message(tmp_path, capsys):
    """A tree without a Zenker directory proceeds with one-class folds and
    prints the unmatched-Idle message, as the JAX splitter does."""
    for cls, pid in (("Healthy", f"H{i}") for i in range(6)):
        (tmp_path / "t" / cls / pid).mkdir(parents=True)
        (tmp_path / "t" / cls / pid / "a.wav").touch()
    (tmp_path / "t" / "Idle" / "X9").mkdir(parents=True)
    (tmp_path / "t" / "Idle" / "X9" / "i.wav").touch()
    S.make_base_cv_splits(str(tmp_path / "t"), str(tmp_path / "o"))
    ours = capsys.readouterr().out
    JS.make_base_cv_splits(str(tmp_path / "t"), str(tmp_path / "j"))
    assert capsys.readouterr().out == ours
    assert "Ignored 1 idle specimens with no pathology match: ['X9']" in ours
    assert_same_tree(tmp_path / "o", tmp_path / "j")


TWO_STAGE_OPTIONS = [
    dict(),
    dict(val_ratio=0.15, val_mode="random", seed=42),
    dict(val_ratio=0.2, val_mode="per-fold"),
    dict(max_files_per_patient=3),
    dict(max_files_per_patient=2, val_ratio=0.25),
    dict(max_files_per_patient=3, val_ratio=0.25, val_mode="per-fold"),
]


@pytest.mark.parametrize("which", ["fixed", 7001])
@pytest.mark.parametrize("opts", TWO_STAGE_OPTIONS,
                         ids=lambda o: "-".join(f"{k}={v}"
                                                for k, v in o.items())
                         or "default")
def test_two_stage_equals_jax(base_dirs, tmp_path, capsys, which, opts):
    _, cv = base_dirs[which]
    S.derive_two_stage_splits(str(cv), str(tmp_path / "o1"),
                              str(tmp_path / "o2"), S.TwoStageOptions(**opts))
    ours = capsys.readouterr().out
    JS.derive_two_stage_splits(str(cv), str(tmp_path / "j1"),
                               str(tmp_path / "j2"),
                               JS.TwoStageOptions(**opts))
    assert capsys.readouterr().out == ours
    assert_same_tree(tmp_path / "o1", tmp_path / "j1")
    assert_same_tree(tmp_path / "o2", tmp_path / "j2")


def test_prepare_clis_equal_jax(tmp_path, monkeypatch):
    """cli.prepare_training_data, then cli.prepare_two_stage with their
    relative default output directories, in both packages."""
    tree = _build(tmp_path, 7002)
    for name, mod1, mod2 in (("ours", prepare_training_data,
                              prepare_two_stage),
                             ("jax", jprepare_training_data,
                              jprepare_two_stage)):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        mod1.main(["--dataset-root", str(tree)])
        mod2.main(["--val-ratio", "0.25", "--max-files-per-patient", "4"])
    for d in ("data_ast_cv", "data_ast_stage1", "data_ast_stage2"):
        assert_same_tree(tmp_path / "ours" / d, tmp_path / "jax" / d)


def test_two_stage_refusals_equal_jax(tmp_path):
    with pytest.raises(FileNotFoundError, match="class_mapping.json"):
        S.derive_two_stage_splits(str(tmp_path), str(tmp_path / "a"),
                                  str(tmp_path / "b"))
    (tmp_path / "class_mapping.json").write_text('{"Idle": 0}')
    with pytest.raises(ValueError, match="missing the 'Healthy' class"):
        S.derive_two_stage_splits(str(tmp_path), str(tmp_path / "a"),
                                  str(tmp_path / "b"))


@pytest.mark.parametrize("fp", ["/d/Healthy/H01/x.wav", "/d/Idle/Z03/c.wav",
                                "/d/other/x.wav", "Zenker/P1", "Zenker"])
def test_patient_ids_equal_jax(fp):
    assert S.extract_patient_id(fp) == JS.extract_patient_id(fp)
    assert S.extract_patient_id_capped(fp) == \
        JS.extract_patient_id_capped(fp)
    assert S.derive_specimen_ids([fp, fp]) == JS.derive_specimen_ids([fp, fp])


@pytest.mark.parametrize("seed", [0, 5])
def test_cap_and_val_splits_equal_jax(seed):
    r = np.random.default_rng(seed)
    x = np.array([f"/d/{c}/P{p}/f{k}.wav" for c in ("Healthy", "Zenker")
                  for p in range(5) for k in range(int(r.integers(1, 6)))],
                 dtype=object)
    y = np.array([0 if "/Healthy/" in s else 1 for s in x])
    a = S.cap_files_per_patient(x, y, 2, seed)
    b = JS.cap_files_per_patient(x, y, 2, seed)
    assert a[0].tolist() == b[0].tolist() and a[2] == b[2]
    np.testing.assert_array_equal(a[1], b[1])
    for fn, args in (("patient_stratified_split", (0.3, seed)),
                     ("patient_per_fold_split", (0.3, seed + 1))):
        got = getattr(S, fn)(x, y, *args)
        want = getattr(JS, fn)(x, y, *args)
        for g, w in zip(got, want):
            if isinstance(w, set):
                assert g == w
            else:
                assert g.tolist() == w.tolist() and g.dtype == w.dtype
