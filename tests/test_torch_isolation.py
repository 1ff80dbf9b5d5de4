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


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(port.__path__,
                                                       port.__name__ + "."))


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "zenker_audio_detection_tpu_torch.infer.cascade" in mods
    assert "zenker_audio_detection_tpu_torch.ops.attention" in mods
    assert {"zenker_audio_detection_tpu_torch.train.optim",
            "zenker_audio_detection_tpu_torch.train.metrics"} <= set(mods)
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
