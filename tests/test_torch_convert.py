"""The port's checkpoint conversion against the JAX package's converter and
against HF `ASTForAudioClassification`."""

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.models import convert as jconvert
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert

transformers = pytest.importorskip("transformers")

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, patch_size=8, frequency_stride=4,
            time_stride=4, num_mel_bins=16, max_length=64, num_labels=2)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v)


def _assert_same_tree(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_export_loads_in_port_and_back(tmp_path):
    import jax

    jcfg = jast.ASTConfig(**TINY)
    tree = jax.tree.map(np.asarray, jast.init_params(jax.random.PRNGKey(3),
                                                     jcfg))
    jconvert.save_hf_model_dir(tree, jcfg, str(tmp_path / "jax"))
    params, cfg = convert.load_hf_model_dir(str(tmp_path / "jax"))
    assert cfg == ast_mod.ASTConfig(**TINY)
    _assert_same_tree(convert.params_to_numpy(params), tree)

    convert.save_hf_model_dir(params, cfg, str(tmp_path / "port"))
    back, jcfg2 = jconvert.load_hf_model_dir(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    _assert_same_tree(back, tree)
    for name in ("config.json",):
        assert ((tmp_path / "jax" / name).read_text()
                == (tmp_path / "port" / name).read_text())


def test_logits_match_hf_model(rng):
    from transformers import ASTConfig as HFASTConfig
    from transformers import ASTForAudioClassification

    torch.manual_seed(0)
    hf_cfg = HFASTConfig(**{k: v for k, v in TINY.items()},
                         attention_probs_dropout_prob=0.0,
                         hidden_dropout_prob=0.0)
    model = ASTForAudioClassification(hf_cfg).eval()
    cfg = convert.config_from_hf_dict(hf_cfg.to_dict() | {
        "id2label": {i: f"L{i}" for i in range(2)}})
    params = convert.from_hf_state_dict(model.state_dict(), cfg)
    x = torch.from_numpy(rng.standard_normal(
        (3, cfg.max_length, cfg.num_mel_bins)).astype(np.float32))
    with torch.no_grad():
        want = model(x).logits.numpy()
        hidden = model.audio_spectrogram_transformer(x).last_hidden_state
    got = ast_mod.forward(params, x, cfg).numpy()
    # tests/test_ast_model.py's tolerances
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(ast_mod.encode(params, x, cfg).numpy(),
                               hidden.numpy(), atol=2e-5, rtol=1e-5)
    sd = convert.to_hf_state_dict(params)
    ref = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sd.keys() == ref.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)


def test_int8_model_dir_is_refused(tmp_path):
    """A JAX int8 directory loads in the port with JAX's quantized leaves
    (since int8 inference was ported), and the HF export refuses the int8
    tree with JAX's message, in both packages."""
    import jax

    jcfg = jast.ASTConfig(**TINY)
    tree = jast.init_params(jax.random.PRNGKey(0), jcfg)
    jconvert.save_int8_model_dir(tree, jcfg, str(tmp_path))
    params, cfg = convert.load_hf_model_dir(str(tmp_path))
    assert cfg == ast_mod.ASTConfig(**TINY)
    qtree = jax.tree.map(np.asarray, jast.quantize_params(tree))
    _assert_same_tree(convert.params_to_numpy(params), qtree)
    _assert_same_tree(convert.params_to_numpy(convert.params_from_jax(qtree)),
                      qtree)
    assert params["encoder"]["q"]["kernel_int8"].dtype == torch.int8
    with pytest.raises(ValueError, match="int8-quantized"):
        convert.to_hf_state_dict(params)
    with pytest.raises(ValueError, match="int8-quantized"):
        jconvert.to_hf_state_dict(qtree)


def test_safetensors_matches_jax_reader(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"a": rng.standard_normal((3, 4)).astype(np.float32),
               "b": np.arange(5, dtype=np.int16),
               "c": np.array([1, 0, 1], dtype=np.bool_)}
    convert.write_safetensors(tensors, str(tmp_path / "x.safetensors"))
    for reader in (convert.read_safetensors, jconvert.read_safetensors):
        got = reader(str(tmp_path / "x.safetensors"))
        assert got.keys() == tensors.keys()
        for k in tensors:
            assert got[k].dtype == tensors[k].dtype
            np.testing.assert_array_equal(got[k], tensors[k])
    (tmp_path / "bad.safetensors").write_bytes(b"\xff" * 8 + b"{}")
    with pytest.raises(ValueError, match="corrupt"):
        convert.read_safetensors(str(tmp_path / "bad.safetensors"))


@pytest.mark.parametrize("field,value", [("hidden_size", "big"),
                                         ("layer_norm_eps", 0.0),
                                         ("qkv_bias", 1),
                                         ("num_attention_heads", 5)])
def test_config_validation_matches_jax(field, value):
    d = {"hidden_size": 32, "num_attention_heads": 4, field: value}
    with pytest.raises(ValueError) as port_err:
        convert.config_from_hf_dict(d)
    with pytest.raises(ValueError) as jax_err:
        jconvert.config_from_hf_dict(d)
    assert str(port_err.value) == str(jax_err.value)
