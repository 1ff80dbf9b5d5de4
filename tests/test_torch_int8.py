"""The port's int8 inference (models/ast.py quantize_params, _dense_int8,
the "kernel_int8" dispatch; models/convert.py's int8 directories;
CascadeConfig.int8) against the JAX package's, from one seeded tree.

Tolerances: the weight quantization is numpy in both packages, so bit for
bit; `_dense_int8` runs the same f32 elementwise ops and an exact int32
product, so 1 f32 ulp; the tiny int8 forward 1e-4 on the probabilities (a
rint decision of the activation quantization can flip on a 1-ulp
difference upstream, and a flip moves that product by one quantization
step); the int8 engine against the f32 engine 5e-2, the documented drift
band of tests/test_int8.py."""

import json

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.infer import cascade as JC
from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.models import convert as jconvert
from zenker_audio_detection_tpu_torch.infer import cascade as C
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert

SMALL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_length=128, num_labels=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors (and for child
    processes, through OMP_NUM_THREADS): the suite runs in several worker
    processes on a few cores, where each process's thread pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


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
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def tree():
    """A JAX-layout f32 tree with non-zero position embeddings and a
    random head, so the probabilities are away from 0.5."""
    import jax

    cfg = jast.ASTConfig(**SMALL)
    tree = jax.tree.map(np.asarray, jast.init_params(jax.random.PRNGKey(5),
                                                     cfg))
    rng = np.random.default_rng(5)
    tree["pos_embed"] = (0.1 * rng.standard_normal(
        tree["pos_embed"].shape)).astype(np.float32)
    tree["head"]["dense"]["kernel"] = rng.standard_normal(
        tree["head"]["dense"]["kernel"].shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(6)
    return rng.standard_normal((3, SMALL["max_length"], 128)).astype(
        np.float32)


def test_quantize_params_matches_jax_bitwise(tree):
    want = jax_tree = jast.quantize_params(tree)
    got = ast_mod.quantize_params(convert.params_from_jax(tree))
    _assert_same_tree(convert.params_to_numpy(got),
                      {k: v for k, v in jax_tree.items()})
    assert got["encoder"]["q"]["kernel_int8"].dtype == torch.int8
    assert got["encoder"]["fc1"]["scale"].shape == (2, 1, 64)
    # idempotent: a quantized tree passes through unchanged
    again = ast_mod.quantize_params(got)
    for name in ast_mod.INT8_DENSE:
        assert again["encoder"][name] is got["encoder"][name]
    _assert_same_tree(convert.params_to_numpy(again), want)
    # everything but the six dense layers is untouched
    assert "kernel" in got["head"]["dense"]
    assert set(got["encoder"]["ln1"]) == {"scale", "bias"}


@pytest.mark.parametrize("name", ["q", "fc1", "fc2"])
def test_dense_int8_matches_jax(tree, name):
    import jax.numpy as jnp

    q = jast.quantize_params(tree)["encoder"][name]
    leaf = {k: v[1] for k, v in q.items()}  # layer 1
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 50, leaf["kernel_int8"].shape[0]))
         * np.linspace(0.01, 3.0, 50)[:, None]).astype(np.float32)
    want = np.asarray(jast._dense_int8(jnp.asarray(x), {
        k: jnp.asarray(v) for k, v in leaf.items()}))
    got = ast_mod._dense_int8(torch.from_numpy(x), {
        k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_int8_forward_matches_jax(tree, feats, monkeypatch):
    """The tiny int8 forward against JAX's at 1e-4 on the probabilities.
    Both packages' activation quantizations are recorded, and the count of
    int8 activations that differ (rint decisions flipped by a 1-ulp
    difference upstream) is reported in the assertion."""
    import jax
    import jax.numpy as jnp

    flips = {"port": [], "jax": []}
    port_dense, jax_dense = ast_mod._dense_int8, jast._dense_int8

    def port_q(x, p):
        flips["port"].append(ast_mod.quantize_tokens(x)[1].numpy())
        return port_dense(x, p)

    def jax_q(x, p):
        xf = x.astype(jnp.float32)
        s = jnp.maximum(jnp.max(jnp.abs(xf), -1, keepdims=True) / 127.0,
                        1e-12)
        # the JAX forward scans over the layers: read the values out of the
        # trace with a callback
        jax.debug.callback(lambda a: flips["jax"].append(np.asarray(a)),
                           jnp.clip(jnp.rint(xf / s), -127, 127)
                           .astype(jnp.int8), ordered=True)
        return jax_dense(x, p)

    monkeypatch.setattr(ast_mod, "_dense_int8", port_q)
    monkeypatch.setattr(jast, "_dense_int8", jax_q)
    cfg = ast_mod.ASTConfig(**SMALL)
    jcfg = jast.ASTConfig(**SMALL)
    got = torch.softmax(ast_mod.forward(
        ast_mod.quantize_params(convert.params_from_jax(tree)),
        torch.from_numpy(feats), cfg), -1).numpy()
    want = np.asarray(jax.nn.softmax(jast.forward(
        jast.quantize_params(tree), jnp.asarray(feats), jcfg,
        dtype=jnp.float32), -1))
    assert len(flips["port"]) == len(flips["jax"]) == 6 * 2
    n_flipped = sum(int((a != b).sum()) for a, b in zip(flips["port"],
                                                       flips["jax"]))
    n_total = sum(a.size for a in flips["port"])
    err = np.abs(got - want).max()
    assert err < 1e-4, (err, f"{n_flipped} of {n_total} int8 activations "
                             f"flipped")
    print(f"int8 forward: {n_flipped} of {n_total} int8 activations "
          f"flipped between the packages, max prob err {err:.3g}")
    # a flip needs a value within 1 ulp of a rounding boundary: rare
    assert n_flipped <= n_total // 1000, (n_flipped, n_total)


def test_engine_int8_close_to_f32(tree):
    """CascadeConfig(int8=True): the engine quantizes at construction, its
    committed stage params hold int8 leaves, and its probabilities stay
    within the documented band of the f32 engine; it also agrees with the
    JAX int8 engine on the same tree."""
    import jax.numpy as jnp

    cfg = ast_mod.ASTConfig(**SMALL)
    params = convert.params_from_jax(tree)
    s1 = C.StageSpec(params, cfg, -1.15, 3.53, ("Idle", "Swallow"))
    s2 = C.StageSpec(params, cfg, -0.9, 2.8, ("Healthy", "Zenker"))
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal(16000 * 3) * 0.1).astype(np.float32)
    kw = dict(batch_size=8, dtype=torch.float32, stage2_mode="all")
    exact = C.TwoStageEngine(s1, s2, C.CascadeConfig(**kw), device="cpu")
    fast = C.TwoStageEngine(s1, s2, C.CascadeConfig(int8=True, **kw),
                            device="cpu")
    p1e, p2e = exact.window_probs(audio)
    p1q, p2q = fast.window_probs(audio)
    assert p1e.shape == p1q.shape == (5, 2)
    assert max(np.abs(p1e - p1q).max(), np.abs(p2e - p2q).max()) < 5e-2
    for committed in (fast._params1, fast._params2):
        for name in ast_mod.INT8_DENSE:
            leaf = committed["encoder"][name]
            assert set(leaf) == {"kernel_int8", "scale", "bias"}
            assert leaf["kernel_int8"].dtype == torch.int8
    assert "kernel_int8" in fast.stage1.params["encoder"]["q"]

    jcfg = jast.ASTConfig(**SMALL)
    jengine = JC.TwoStageEngine(
        JC.StageSpec(tree, jcfg, -1.15, 3.53, ("Idle", "Swallow")),
        JC.StageSpec(tree, jcfg, -0.9, 2.8, ("Healthy", "Zenker")),
        JC.CascadeConfig(batch_size=8, dtype=jnp.float32, stage2_mode="all",
                         int8=True))
    # the front ends agree to f32 rounding, and a 1-ulp difference can flip
    # one rint decision of the activation quantization (one quantization
    # step in one product): tests/test_torch_serve.py's INT8_TOL
    w1, w2 = jengine.window_probs(audio)
    np.testing.assert_allclose(p1q, w1, atol=1e-3)
    np.testing.assert_allclose(p2q, w2, atol=1e-3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_int8_model_dir_round_trips_between_packages(tree, feats, tmp_path,
                                                     writer):
    """An int8 directory written by either package loads in both, with
    JAX's quantized leaves bit for bit; the port's forward of the loaded
    params equals its forward of the in-memory quantized params exactly."""
    cfg = ast_mod.ASTConfig(**SMALL)
    labels = {0: "Idle", 1: "Swallow"}
    d = str(tmp_path / writer)
    if writer == "jax":
        jconvert.save_int8_model_dir(tree, jast.ASTConfig(**SMALL), d,
                                     id2label=labels)
    else:
        convert.save_int8_model_dir(convert.params_from_jax(tree), cfg, d,
                                    id2label=labels)
    with open(f"{d}/config.json") as f:
        meta = json.load(f)
    assert meta["zenker_int8"] is True
    assert meta["id2label"] == {"0": "Idle", "1": "Swallow"}
    want = jast.quantize_params(tree)
    jloaded, jcfg = jconvert.load_hf_model_dir(d)
    loaded, lcfg = convert.load_hf_model_dir(d)
    assert lcfg == cfg and jcfg == jast.ASTConfig(**SMALL)
    _assert_same_tree(jloaded, want)
    _assert_same_tree(convert.params_to_numpy(loaded), want)
    x = torch.from_numpy(feats)
    torch.testing.assert_close(
        ast_mod.forward(loaded, x, cfg),
        ast_mod.forward(ast_mod.quantize_params(
            convert.params_from_jax(tree)), x, cfg), atol=0, rtol=0)


def test_hf_export_refuses_int8_params(tree, tmp_path):
    q = ast_mod.quantize_params(convert.params_from_jax(tree))
    with pytest.raises(ValueError, match="int8-quantized"):
        convert.to_hf_state_dict(q)
    with pytest.raises(ValueError, match="save_int8_model_dir"):
        convert.save_hf_model_dir(q, ast_mod.ASTConfig(**SMALL),
                                  str(tmp_path / "hf"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cast_params_keeps_int8_and_f32_leaves(tree, feats, dtype):
    """cast_params casts the compute leaves to the compute dtype but keeps
    each int8 leaf's kernel int8 (column-major per layer, same values) and
    its scale and bias f32; the forward does not change."""
    cfg = ast_mod.ASTConfig(**SMALL)
    q = ast_mod.quantize_params(convert.params_from_jax(tree))
    cast = ast_mod.cast_params(q, dtype, "cpu")
    for name in ast_mod.INT8_DENSE:
        leaf = cast["encoder"][name]
        assert leaf["kernel_int8"].dtype == torch.int8
        assert leaf["scale"].dtype == leaf["bias"].dtype == torch.float32
        assert torch.equal(leaf["kernel_int8"], q["encoder"][name]
                           ["kernel_int8"])
        assert leaf["kernel_int8"][0].stride() == (1, leaf["kernel_int8"]
                                                   .shape[1])
    assert cast["pos_embed"].dtype == dtype
    assert cast["encoder"]["ln1"]["scale"].dtype == torch.float32
    x = torch.from_numpy(feats)
    torch.testing.assert_close(ast_mod.forward(cast, x, cfg, dtype=dtype),
                               ast_mod.forward(q, x, cfg, dtype=dtype),
                               atol=0, rtol=0)
