"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, nor optax or sklearn (the machine with the card has neither), and
its entry points do not fall back to the CPU on their own."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import zenker_audio_detection_tpu_torch as port
from zenker_audio_detection_tpu_torch.cli import infer_long_audio as cli
from zenker_audio_detection_tpu_torch.infer import cascade as C
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.ops import attention as A

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the modules of the data preparation, evaluation and analysis slice
SLICE_11 = tuple(f"zenker_audio_detection_tpu_torch.{m}" for m in (
    "data.splits", "data.prepare", "analysis.snippet_eval", "analysis.roc_pr",
    "analysis.validate", "analysis.drift_bench", "cli.prepare_dataset",
    "cli.prepare_training_data", "cli.prepare_two_stage", "cli.test_stage1",
    "cli.test_stage2", "cli.analyze_roc_pr", "cli.adapt_checkpoint",
    "cli.extract_thresholds", "cli.plot_confusion_matrices",
    "cli.validate_real", "cli.drift"))

# the modules of training and serving over several devices
PARALLEL = tuple(f"zenker_audio_detection_tpu_torch.{m}" for m in (
    "parallel", "parallel.mesh", "parallel.launch", "parallel.checks"))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(port.__path__,
                                                       port.__name__ + "."))


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "zenker_audio_detection_tpu_torch.infer.cascade" in mods
    assert "zenker_audio_detection_tpu_torch.ops.attention" in mods
    assert {"zenker_audio_detection_tpu_torch.train.optim",
            "zenker_audio_detection_tpu_torch.train.metrics",
            "zenker_audio_detection_tpu_torch.train.loop",
            "zenker_audio_detection_tpu_torch.data.augment",
            "zenker_audio_detection_tpu_torch.data.stats",
            "zenker_audio_detection_tpu_torch.utils.tracking",
            "zenker_audio_detection_tpu_torch.analysis.cm_plots",
            "zenker_audio_detection_tpu_torch.cli.train_stage1",
            "zenker_audio_detection_tpu_torch.cli.train_stage2",
            "zenker_audio_detection_tpu_torch.cli.compute_stats",
            "zenker_audio_detection_tpu_torch.infer.streaming",
            "zenker_audio_detection_tpu_torch.infer.plotting",
            "zenker_audio_detection_tpu_torch.utils.profiling",
            "zenker_audio_detection_tpu_torch.analysis.thresholds",
            "zenker_audio_detection_tpu_torch.analysis.aggregate",
            "zenker_audio_detection_tpu_torch.data.config",
            "zenker_audio_detection_tpu_torch.cli.serve",
            "zenker_audio_detection_tpu_torch.cli.serve_supervisor",
            "zenker_audio_detection_tpu_torch.cli.run_batch_2stage",
            "zenker_audio_detection_tpu_torch.cli.run_all_folds",
            "zenker_audio_detection_tpu_torch.cli.aggregate_results",
            "zenker_audio_detection_tpu_torch.audio.native",
            "zenker_audio_detection_tpu_torch.train.fold_parallel",
            "zenker_audio_detection_tpu_torch.train.trial_parallel",
            "zenker_audio_detection_tpu_torch.tune.sweep",
            "zenker_audio_detection_tpu_torch.cli.sweep",
            *SLICE_11, *PARALLEL} <= set(mods)
    code = (
        "import importlib, sys\n"
        "assert 'jax' not in sys.modules, 'jax pre-imported at startup'\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'optax', 'sklearn',\n"
        "                                    'zenker_audio_detection_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


# the scripts that run on the card's machine, which has no JAX: every one
# under tools/ but the two that hold the port to the JAX package on the CPU
CPU_ONLY_TOOLS = ("drift_jax_vs_port.py", "first_update_probe.py")


@pytest.mark.parametrize("script", ["chip_smoke.py"] + sorted(
    f"tools/{f}" for f in os.listdir(os.path.join(REPO, "tools"))
    if f.endswith(".py") and f not in CPU_ONLY_TOOLS))
def test_card_scripts_import_no_jax(script):
    """No import statement of a card script, at any depth, names jax,
    optax, sklearn or the JAX package."""
    import ast

    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    bad = sorted(n for n in names if n.split(".")[0] in (
        "jax", "optax", "sklearn", "zenker_audio_detection_tpu"))
    assert not bad, (script, bad)


def _tiny_spec():
    cfg = ast_mod.ASTConfig(hidden_size=16, num_hidden_layers=1,
                            num_attention_heads=2, intermediate_size=32,
                            max_length=128)
    params = ast_mod.init_params(np.random.default_rng(0), cfg)
    return C.StageSpec(params, cfg, 0.0, 1.0, ("Idle", "Swallow"))


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    spec = _tiny_spec()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        C.TwoStageEngine(spec, spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        C.TwoStageEngine(spec, spec, device="cuda")
    engine = C.TwoStageEngine(spec, spec, device="cpu")
    assert engine.device == torch.device("cpu")


def test_cli_without_device_flag_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--file-a", str(a), "--file-b", str(b),
                  "--stage1-model-root", str(tmp_path),
                  "--stage2-model-root", str(tmp_path)])


def _tiny_model_dirs(root):
    """Two tiny stage directories exported by the port."""
    from zenker_audio_detection_tpu_torch.models import convert
    from zenker_audio_detection_tpu_torch.train import loop as train_loop

    spec = _tiny_spec()
    dirs = []
    for name in ("s1", "s2"):
        d = str(root / name)
        convert.save_hf_model_dir(spec.params, spec.config, d)
        train_loop.save_feature_extractor_config(d, 0.0, 1.0,
                                                 max_length=128)
        dirs.append(d)
    return dirs


def test_serve_child_imports_no_jax(tmp_path):
    """A serve process (what the supervisor spawns) streams windows without
    importing jax, optax, sklearn or the JAX package."""
    dirs = _tiny_model_dirs(tmp_path)
    code = (
        "import atexit, runpy, sys\n"
        "def report():\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                 ('jax', 'optax', 'sklearn',\n"
        "                  'zenker_audio_detection_tpu'))\n"
        "    print('BAD', bad, file=sys.stderr)\n"
        "atexit.register(report)\n"
        "sys.argv = ['serve', '--stage1-model-root', sys.argv[1],\n"
        "            '--stage2-model-root', sys.argv[2], '--device', 'cpu',\n"
        "            '--f32', '--chunk-windows', '2']\n"
        "runpy.run_module('zenker_audio_detection_tpu_torch.cli.serve',\n"
        "                 run_name='__main__')\n")
    pcm = (np.sin(np.arange(16000 * 2) / 9.0) * 3000).astype(np.int16)
    proc = subprocess.run([sys.executable, "-c", code, *dirs], cwd=REPO,
                          input=pcm.tobytes(), capture_output=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    lines = proc.stdout.decode().splitlines()
    assert len(lines) == 3 + 1  # 3 windows and the summary
    assert "BAD []" in proc.stderr.decode(), proc.stderr.decode()


def test_serving_entry_points_without_device_need_cuda(tmp_path):
    """serve and run_batch_2stage default to the card: without one they
    raise, never carry on on the CPU."""
    import io

    from zenker_audio_detection_tpu_torch.cli import run_batch_2stage, serve

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    dirs = _tiny_model_dirs(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--stage1-model-root", dirs[0], "--stage2-model-root",
                    dirs[1]], stdin_buffer=io.BytesIO(b""),
                   stdout=io.StringIO())
    (tmp_path / "test_ids_fold1.txt").write_text("Zenker/P1\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_batch_2stage.main(["--fold", "1", "--ids-root", str(tmp_path),
                               "--long-audio-root", str(tmp_path),
                               "--stage1-model-root", dirs[0],
                               "--stage2-model-root", dirs[1],
                               "--output-dir", str(tmp_path / "out")])


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 70, 128))
                                .astype(np.float32)) for _ in range(3))
    before = A.mha_packed.launches
    got = A.mha_packed(q, k, v, num_heads=2)
    assert A.mha_packed.launches == before
    torch.testing.assert_close(got, A.mha_packed_reference(q, k, v, 2),
                               atol=0, rtol=0)


@pytest.mark.parametrize("name", ["mha", "mha_batched_heads", "mha_qblock",
                                  "mha_fused"])
def test_cpu_tensors_take_the_plain_version_4d(name):
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 70, 2, 64))
                                .astype(np.float32)) for _ in range(3))
    fn = getattr(A, name)
    before = fn.launches
    got = fn(q, k, v)
    assert fn.launches == before
    torch.testing.assert_close(got, A.reference_mha(q, k, v), atol=0, rtol=0)


def test_cpu_tensors_take_the_plain_version_pairs():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 70, 256))
                                .astype(np.float32)) for _ in range(3))
    before = (A.mha_pairs.launches, A.mha_packed.launches)
    got = A.mha_pairs(q, k, v, num_heads=4)
    assert (A.mha_pairs.launches, A.mha_packed.launches) == before
    torch.testing.assert_close(got, A.mha_packed_reference(q, k, v, 4),
                               atol=0, rtol=0)


def test_cpu_tensors_take_the_plain_version_trainable():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 70, 128))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    before = A.mha_packed.launches
    got = A.mha_packed_trainable(q, k, v, 2)
    got.sum().backward()
    assert A.mha_packed.launches == before
    assert got.grad_fn is not None and q.grad is not None
    torch.testing.assert_close(got.detach(),
                               A.mha_packed_reference(q, k, v, 2).detach(),
                               atol=0, rtol=0)


def test_parallel_and_sweep_modules_load_no_yaml():
    """The sweep agent, its CLI and the parallel trainers import in a fresh
    interpreter without yaml (the card's machine may have no PyYAML: only
    reading a sweep YAML needs it), jax or the JAX package."""
    mods = ["zenker_audio_detection_tpu_torch.tune.sweep",
            "zenker_audio_detection_tpu_torch.cli.sweep",
            "zenker_audio_detection_tpu_torch.train.fold_parallel",
            "zenker_audio_detection_tpu_torch.train.trial_parallel",
            *PARALLEL]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('yaml', 'jax', 'optax',\n"
        "                                    'zenker_audio_detection_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_native_binding_never_reads_the_make_build(tmp_path):
    """The port's audio/native.py builds its own library under build/native
    and never opens native/libaudioio.so (the JAX package's `make -C
    native` output): every open() and ctypes load of a process that builds
    (or finds) and uses the port's library is recorded."""
    code = (
        "import builtins, ctypes, sys\n"
        "seen = []\n"
        "real_open, real_cdll = builtins.open, ctypes.CDLL.__init__\n"
        "def spy_open(f, *a, **k):\n"
        "    seen.append(str(f))\n"
        "    return real_open(f, *a, **k)\n"
        "def spy_cdll(self, name, *a, **k):\n"
        "    seen.append(str(name))\n"
        "    return real_cdll(self, name, *a, **k)\n"
        "builtins.open, ctypes.CDLL.__init__ = spy_open, spy_cdll\n"
        "from zenker_audio_detection_tpu_torch.audio import native\n"
        "import numpy as np\n"
        "assert native.available()\n"
        "assert native.phase_vocoder_stretch(np.ones(4096), 1.1) is not None\n"
        "libs = [s for s in seen if s.endswith('.so')]\n"
        "assert libs and all('/build/native/' in s for s in libs), libs\n"
        f"make_build = {os.path.join(REPO, 'native', 'libaudioio.so')!r}\n"
        "assert not any(s.endswith('libaudioio.so') or s == make_build\n"
        "               for s in seen), seen\n"
        "print('ok', libs)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_slice_modules_load_no_optional_packages():
    """The data preparation, evaluation and analysis modules import in a
    fresh interpreter without loading sklearn, transformers or matplotlib
    (the card's machine may have none of them: only the converter check
    and the plots need the last two, inside their functions), jax or the
    JAX package."""
    code = (
        "import importlib, sys\n"
        f"for m in {list(SLICE_11 + PARALLEL)!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('sklearn', 'transformers',\n"
        "                                    'matplotlib', 'jax', 'optax',\n"
        "                                    'zenker_audio_detection_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_evaluation_entry_points_without_device_need_cuda(tmp_path):
    """test_stage1 and analyze_roc_pr default to the card: without one
    they raise before they read or write anything."""
    from zenker_audio_detection_tpu_torch.cli import analyze_roc_pr
    from zenker_audio_detection_tpu_torch.cli import test_stage1

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_stage1.main(["--all", "--data-dir", str(tmp_path / "d"),
                          "--model-root", str(tmp_path / "runs"),
                          "--results-dir", str(tmp_path / "results")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analyze_roc_pr.main(["--data-dir", str(tmp_path / "d"),
                             "--model-root-template",
                             str(tmp_path / "runs" / "fold{fold}"),
                             "--output-json", str(tmp_path / "o.json")])
    assert os.listdir(tmp_path) == []
