"""The port's AST forward against the JAX package's, on the same random
parameter pytree (carried across by `params_from_jax`) and the same seeded
features."""

import dataclasses

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.ops import attention as JA
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert

# tests/test_pallas_attention.py's tiny config
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, patch_size=8, frequency_stride=4,
            time_stride=4, num_mel_bins=16, max_length=64, num_labels=2)


def random_jax_tree(seed, cfg):
    """A JAX-layout pytree with every leaf random — including the LN
    parameters, tokens and position embeddings HF's init leaves at 0/1, so
    that a wrong token or patch order cannot pass."""
    import jax

    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda x: x.shape, jast.init_params(
        jax.random.PRNGKey(0), cfg))

    def leaf(path, shape):
        scale = 0.05 * rng.standard_normal(shape)
        name = jax.tree_util.keystr(path)
        return (scale + (1.0 if "scale" in name else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX "pallas" route in interpret mode on the CPU, as
    tests/test_pallas_attention.py does."""
    orig = JA.mha_packed
    monkeypatch.setattr(JA, "mha_packed", lambda q, k, v, **kw: orig(
        q, k, v, **{**kw, "interpret": True}))


def _features(seed, b, cfg):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.max_length, cfg.num_mel_bins)).astype(
        np.float32)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_forward_f32_matches_jax(pallas_interpret, impl, jax_impl):
    jcfg = jast.ASTConfig(**TINY)
    cfg = ast_mod.ASTConfig(**TINY)
    tree = random_jax_tree(0, jcfg)
    x = _features(1, 3, cfg)
    want = np.asarray(jast.forward(tree, x, jcfg, attention_impl=jax_impl))
    got = ast_mod.forward(convert.params_from_jax(tree), torch.from_numpy(x),
                          cfg, attention_impl=impl)
    assert got.dtype == torch.float32 and got.shape == (3, 2)
    # tests/test_pallas_attention.py's bound for the f32 forward
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_forward_bf16_matches_jax():
    """bf16 compute on both sides: every dense output, the attention
    probabilities and the residual stream are rounded to bf16 (2^-8
    relative), and the two frameworks' kernels round slightly different
    values. Over four seeds the logits (O(0.5)) differed by at most 3.9e-3,
    the size of JAX's own bf16-vs-f32 gap here; the bound is 1e-2."""
    import jax.numpy as jnp

    jcfg = jast.ASTConfig(**TINY)
    cfg = ast_mod.ASTConfig(**TINY)
    tree = random_jax_tree(2, jcfg)
    x = _features(3, 4, cfg)
    want = np.asarray(jast.forward(tree, x, jcfg, dtype=jnp.bfloat16))
    got = ast_mod.forward(convert.params_from_jax(tree), torch.from_numpy(x),
                          cfg, dtype=torch.bfloat16, attention_impl="kernel")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2)


def test_patch_order_is_frequency_major():
    """max_length != num_mel_bins and a non-square patch grid: a time-major
    flatten would pair patches with the wrong position embeddings."""
    over = dict(TINY, num_mel_bins=24, max_length=48, frequency_stride=8,
                time_stride=4)
    jcfg = jast.ASTConfig(**over)
    cfg = ast_mod.ASTConfig(**over)
    assert cfg.frequency_out_dimension != cfg.time_out_dimension
    tree = random_jax_tree(4, jcfg)
    x = _features(5, 2, cfg)
    want = np.asarray(jast.encode(tree, x, jcfg))
    got = ast_mod.encode(convert.params_from_jax(tree), torch.from_numpy(x),
                         cfg).numpy()
    assert got.shape == want.shape == (2, cfg.seq_length, cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=5e-5)
    emb = ast_mod.patch_embed(convert.params_from_jax(tree),
                              torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(
        emb, np.asarray(jast.patch_embed(tree, x, jcfg)), atol=1e-5)


def test_params_roundtrip_through_jax_layout():
    jcfg = jast.ASTConfig(**TINY)
    tree = random_jax_tree(6, jcfg)
    params = convert.params_from_jax(tree)
    assert params["patch_embed"]["kernel"].shape == (32, 1, 8, 8)  # OIHW
    back = convert.params_to_numpy(params)
    flat_want = dict(_flat(tree))
    flat_got = dict(_flat(back))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert flat_got[k].dtype == v.dtype
        np.testing.assert_array_equal(flat_got[k], v, err_msg=k)


def test_init_params_matches_jax_structure_and_scale():
    import jax

    cfg = ast_mod.ASTConfig(**TINY)
    params = ast_mod.init_params(np.random.default_rng(0), cfg)
    got = dict(_flat(convert.params_to_numpy(params)))
    want = dict(_flat(jast.init_params(jax.random.PRNGKey(0),
                                       jast.ASTConfig(**TINY))))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
    # HF's init: N(0, 0.02) kernels, zero tokens and position embeddings
    fc1 = got["encoder.fc1.kernel"]
    assert abs(fc1.std() - 0.02) < 0.002 and abs(fc1.mean()) < 0.002
    assert not got["pos_embed"].any() and not got["cls_token"].any()
    assert (got["encoder.ln1.scale"] == 1).all()
    again = ast_mod.init_params(np.random.default_rng(0), cfg)
    torch.testing.assert_close(again["encoder"]["q"]["kernel"],
                               params["encoder"]["q"]["kernel"], atol=0, rtol=0)


def test_cast_params_keeps_layer_norms_and_head_f32():
    cfg = ast_mod.ASTConfig(**TINY)
    params = ast_mod.init_params(np.random.default_rng(0), cfg)
    cast = ast_mod.cast_params(params, torch.bfloat16, "cpu")
    assert cast["encoder"]["q"]["kernel"].dtype == torch.bfloat16
    assert cast["pos_embed"].dtype == torch.bfloat16
    assert cast["encoder"]["ln1"]["scale"].dtype == torch.float32
    assert cast["ln_final"]["bias"].dtype == torch.float32
    assert cast["head"]["dense"]["kernel"].dtype == torch.float32
    x = torch.from_numpy(_features(7, 2, cfg))
    torch.testing.assert_close(
        ast_mod.forward(cast, x, cfg, dtype=torch.bfloat16),
        ast_mod.forward(params, x, cfg, dtype=torch.bfloat16), atol=0, rtol=0)


def test_forward_rejects_unknown_attention_impl():
    cfg = ast_mod.ASTConfig(**TINY)
    params = ast_mod.init_params(np.random.default_rng(0), cfg)
    with pytest.raises(ValueError, match="attention_impl"):
        ast_mod.forward(params, torch.zeros(1, 64, 16), cfg,
                        attention_impl="xla")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v)


def test_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(ast_mod.ASTConfig)]
            == [f.name for f in dataclasses.fields(jast.ASTConfig)])
    a, b = ast_mod.ASTConfig(), jast.ASTConfig()
    for prop in ("frequency_out_dimension", "time_out_dimension",
                 "num_patches", "seq_length", "head_dim"):
        assert getattr(a, prop) == getattr(b, prop), prop
