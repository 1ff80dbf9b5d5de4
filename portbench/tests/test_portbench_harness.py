"""The harness finds every cell's files by the names BENCHMARK.json gives,
refuses a name it cannot find, and takes a new configuration, mix, metric
and cell as new files and new entries alone."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from portbench import harness

CELLS = {"ast1024.recordings_gated": ("recordings", 1024),
         "ast1024.finetune_b16": ("finetune", 1024),
         "ast128.recordings_gated": ("recordings", 128)}
INFER = {"attention_roofline_pct.infer", "mfu.infer",
         "launches_per_window.infer", "device_idle_pct.infer"}
TRAIN = {"mfu.train", "launches_per_step.train", "device_idle_pct.train"}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_each_cell_is_found_with_its_files(name):
    cell = harness.find(name)
    kind, length = CELLS[name]
    assert cell.kind == kind and cell.config["max_length"] == length
    assert cell.chips == 1
    if kind == "recordings":
        assert cell.end_to_end == ["windows_per_s", "setup_s"]
        assert set(cell.per_layer) == INFER
    else:
        assert cell.end_to_end == ["train_step_ms", "setup_s"]
        assert set(cell.per_layer) == TRAIN
    for metric in cell.per_layer:
        assert callable(harness.reader(cell.base, metric))
    assert set(cell.limits) <= {"far", "gate_flips", "gate_set", "summary",
                                "capture", "loss_of_logits", "logit_gap",
                                "change_median"}


def test_the_manifest_keeps_to_the_contract():
    bench = harness.manifest()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(e2e) == {"windows_per_s", "train_step_ms", "setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        reporting = set(e2e[m["moves"]].get("workloads", CELLS))
        assert set(m["workloads"]) <= reporting
    for c in bench["configs"]:
        assert Path(harness.ROOT, c["file"]).is_file()


def test_an_unknown_name_is_refused():
    with pytest.raises(LookupError, match="no workload"):
        harness.find("ast1024.nothing")
    bench = harness.manifest()
    bench["workloads"].append({"name": "x.y", "config": "nope",
                               "traffic": "recordings_gated", "chips": 1,
                               "why": "-"})
    with pytest.raises(LookupError, match="no known config"):
        harness.find("x.y", bench=bench)
    bench["workloads"][-1]["config"] = "ast_audioset_1024"
    bench["workloads"][-1]["traffic"] = "no_such_mix"
    with pytest.raises(LookupError, match="traffic"):
        harness.find("x.y", bench=bench)
    bench["workloads"][-1]["traffic"] = "recordings_gated"
    with pytest.raises(LookupError, match="limits"):
        harness.find("x.y", bench=bench)
    bench["workloads"][-1]["name"] = "ast1024.recordings_gated"
    bench["per_layer"].append({"name": "no_reader.infer", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "engine", "moves": "windows_per_s"})
    with pytest.raises(LookupError, match="lists no workloads"):
        harness.find("ast128.recordings_gated", bench=bench)
    bench["per_layer"][-1]["workloads"] = ["ast128.recordings_gated"]
    with pytest.raises(LookupError, match="no reader"):
        harness.find("ast128.recordings_gated", bench=bench)


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_comes_as_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    before = digests(root / "portbench")
    base = root / "portbench"
    config = json.loads((base / "configs/ast_audioset_1024.json").read_text())
    config.update(max_length=512, reduced={})
    (base / "configs/ast_audioset_512.json").write_text(json.dumps(config))
    mix = json.loads((base / "traffic/recordings_gated.json").read_text())
    mix["patients"] = 4
    (base / "traffic/recordings_four.json").write_text(json.dumps(mix))
    (base / "limits/ast512.recordings_four.json").write_text(
        (base / "limits/ast1024.recordings_gated.json").read_text())
    (base / "metrics/windows_seen.infer.py").write_text(
        "def read(run):\n    return float(run.tally['windows'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ast_audioset_512", "source": "-",
                             "file": "portbench/configs/ast_audioset_512.json",
                             "reduced": [], "why": "-"})
    bench["workloads"].append({"name": "ast512.recordings_four",
                               "config": "ast_audioset_512",
                               "traffic": "recordings_four", "chips": 1,
                               "why": "-"})
    bench["end_to_end"][0]["workloads"].append("ast512.recordings_four")
    bench["per_layer"].append({"name": "windows_seen.infer", "unit": "windows",
                               "better": "higher", "source": "program_counter",
                               "layer": "engine", "moves": "windows_per_s",
                               "workloads": ["ast512.recordings_four"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find("ast512.recordings_four", root=root)
    assert cell.config["max_length"] == 512 and cell.mix["patients"] == 4
    assert cell.per_layer == {"windows_seen.infer": bench["per_layer"][-1]}
    run = harness.Run(cell, None, {"windows": 7}, {})
    assert harness.reader(cell.base, "windows_seen.infer")(run) == 7.0
    assert harness.find("ast1024.recordings_gated", root=root).per_layer \
        .keys() == INFER
    after = digests(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
