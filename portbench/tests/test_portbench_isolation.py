"""What a run loads, and how it ends where it cannot measure."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from portbench import harness

ROOT = str(harness.ROOT)


def python(code: str, cwd: str = ROOT, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_the_harness_and_the_program_load_no_jax():
    out = python("""
        import json, sys
        sys.path.insert(0, ".")
        from portbench import harness, tracing, readings
        from portbench.kinds import recordings, finetune
        from zenker_audio_detection_tpu_torch.infer import cascade
        from zenker_audio_detection_tpu_torch.train import steps, optim, losses
        print(json.dumps(harness.forbidden_modules()))
    """)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_program():
    out = python("""
        import json, sys
        sys.path.insert(0, ".")
        import portbench.reference.ast, portbench.reference.fbank
        import portbench.reference.cascade, portbench.reference.train
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0].startswith("zenker"))))
    """)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_the_look_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "zenker_audio_detection_tpu_torch_x",
                        object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "zenker_audio_detection_tpu.ops",
                        object())
    assert harness.forbidden_modules() == ["jax", "zenker_audio_detection_tpu"]


def run_py(cwd: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ast128.recordings_gated", "--seed", str(2 ** 31 + 12345),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_a_run_fails_and_prints_no_result():
    import torch

    env = dict(os.environ)
    if torch.cuda.is_available():
        env["CUDA_VISIBLE_DEVICES"] = ""
    out = run_py(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_with_only_the_benchmark_a_run_fails(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = run_py(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "No module named 'zenker_audio_detection_tpu_torch'" in out.stderr


def test_an_unknown_workload_fails():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "nothing", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no workload" in out.stderr
