"""The port's `utils/prng.py` (JAX's threefry2x32 generator in numpy)
against `jax.random`, and the initial trees that the port draws from it
against the JAX package's.

Keys, splits, bits and uniforms are compared bit for bit at seeds 0, 3, 7,
2**31 - 1 and 2**40 + 5 (which JAX, with 64-bit types off, wraps to 5);
normals and truncated normals bit for bit too: `utils/prng.py` repeats
XLA-CPU's compiled f32 erf_inv, log1p, log and erf step by step, with its
fused multiply-adds. Then `models/ast.py:init_params(prng.key(s))` against
`jast.init_params(jax.random.PRNGKey(s))` at a tiny config (in both
branches of `_trunc_normal`), and `train/loop.py:init_model` against the
JAX `init_model` with a pretrained directory (the fresh head) and without
one (the random init, at the tiny widths in both packages), at seeds 0, 3
and 42: every leaf bit for bit. A numpy `Generator` keeps the port's
earlier draws."""

import functools

import jax
import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.train import loop as JL
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert
from zenker_audio_detection_tpu_torch.train import loop as L
from zenker_audio_detection_tpu_torch.utils import prng

from test_torch_ast import TINY
from test_train_loop import tiny_pretrained_dir

SEEDS = (0, 3, 7, 2**31 - 1, 2**40 + 5)
SHAPES = ((7,), (3, 5), (64, 33))
WIDTHS = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _assert_trees_equal(got: dict, want: dict) -> None:
    """Every leaf of two JAX-layout trees equal bit for bit."""
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_got) == len(flat_want)
    for path, w in flat_want:
        g = flat_got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert np.array_equal(_bits(g), _bits(w)), (
            jax.tree_util.keystr(path),
            int((_bits(g) != _bits(w)).sum()), g.size)


def _port_tree(params) -> dict:
    return convert.params_to_numpy(params)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_bits_uniform_match_jax(seed, shape):
    jkey, key = jax.random.PRNGKey(seed), prng.key(seed)
    assert prng.is_key(key)
    assert np.array_equal(np.asarray(jax.random.key_data(jkey)), key)
    assert np.array_equal(np.asarray(jax.random.split(jkey, 8)),
                          prng.split(key, 8))
    assert np.array_equal(np.asarray(jax.random.bits(jkey, shape)),
                          prng.bits(key, shape))
    for lo, hi in ((0.0, 1.0), (-0.3, 2.7)):
        want = np.asarray(jax.random.uniform(jkey, shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(key, shape, lo, hi)
        assert got.dtype == np.float32
        assert np.array_equal(_bits(got), _bits(want)), (lo, hi)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed):
    """200,000 draws, both branches of erf_inv (w < 5 and w >= 5) and both
    of log1p (|u^2| below and above sqrt(2) - 1)."""
    jkey, key = jax.random.PRNGKey(seed), prng.key(seed)
    want = np.asarray(jax.random.normal(jkey, (200_000,)))
    got = prng.normal(key, (200_000,))
    assert np.array_equal(_bits(got), _bits(want))
    assert np.abs(got).max() > 4.0  # the w >= 5 branch was drawn


@pytest.mark.parametrize("seed", (0, 3, 42))
def test_normal_scale_folds_as_under_jit(seed):
    """`normal(k, shape, scale)` is `scale * jax.random.normal` inside a
    jitted function, where XLA folds the constant factors; outside jit JAX
    rounds twice."""
    jkey, key = jax.random.PRNGKey(seed), prng.key(seed)
    jitted = jax.jit(lambda k: 0.02 * jax.random.normal(k, (4096,)))(jkey)
    assert np.array_equal(_bits(prng.normal(key, (4096,), 0.02)),
                          _bits(np.asarray(jitted)))
    eager = 0.02 * jax.random.normal(jkey, (4096,))
    assert np.array_equal(
        _bits(np.float32(0.02) * prng.normal(key, (4096,))),
        _bits(np.asarray(eager)))


@pytest.mark.parametrize("bounds", ((-1.5, 2.0), (-2.0, 2.0), (-0.5, 9.0)))
@pytest.mark.parametrize("seed", (0, 7, 2**40 + 5))
def test_truncated_normal_matches_jax(seed, bounds):
    jkey, key = jax.random.PRNGKey(seed), prng.key(seed)
    want = np.asarray(jax.random.truncated_normal(jkey, *bounds, (50_000,)))
    got = prng.truncated_normal(key, *bounds, (50_000,))
    assert np.array_equal(_bits(got), _bits(want))
    assert bounds[0] < got.min() and got.max() < bounds[1]


@pytest.mark.parametrize("std", (0.02, 0.5))
@pytest.mark.parametrize("seed", (0, 3, 42))
def test_init_params_matches_jax(seed, std):
    """std 0.02 draws `normal` (bounds beyond 10 sigma), 0.5 draws
    `truncated_normal`; the patch kernel is drawn (p, p, 1, h) and laid out
    (h, 1, p, p)."""
    over = {**TINY, "initializer_range": std}
    want = jax.tree.map(np.asarray, jast.init_params(
        jax.random.PRNGKey(seed), jast.ASTConfig(**over)))
    got = ast_mod.init_params(prng.key(seed), ast_mod.ASTConfig(**over))
    assert got["patch_embed"]["kernel"].shape == (32, 1, 8, 8)
    _assert_trees_equal(_port_tree(got), want)


def test_generator_keeps_its_draws():
    """With a numpy Generator the draws are the port's earlier ones: the
    tensors in order, each std times standard normals."""
    cfg = ast_mod.ASTConfig(**TINY)
    params = ast_mod.init_params(np.random.default_rng(5), cfg)
    rng = np.random.default_rng(5)
    h, p = cfg.hidden_size, cfg.patch_size
    want_patch = (0.02 * rng.standard_normal((h, 1, p, p))).astype(np.float32)
    want_q = (0.02 * rng.standard_normal(
        (cfg.num_hidden_layers, h, h))).astype(np.float32)
    assert np.array_equal(params["patch_embed"]["kernel"].numpy(), want_patch)
    assert np.array_equal(params["encoder"]["q"]["kernel"].numpy(), want_q)
    head = ast_mod.reinit_head(np.random.default_rng(9), params, cfg)
    want_head = (0.02 * np.random.default_rng(9).standard_normal(
        (h, 2))).astype(np.float32)
    assert np.array_equal(head["head"]["dense"]["kernel"].numpy(), want_head)


@pytest.mark.parametrize("pretrained", (True, False),
                         ids=("pretrained", "random"))
@pytest.mark.parametrize("seed", (0, 3, 42))
def test_init_model_matches_jax(tmp_path, monkeypatch, seed, pretrained):
    """Both trainers' `init_model` at one seed give one tree. With a
    pretrained dir (a 527-class head) the trunk is the dir's and the fresh
    2-class head comes from the key; without one, `init_params` of the
    key, at the tiny widths in both packages (each loop's `ASTConfig`
    patched to them)."""
    common = dict(seed=seed, max_length=64 if not pretrained else None)
    if pretrained:
        common["pretrained_model_dir"] = tiny_pretrained_dir(tmp_path)
    else:
        monkeypatch.setattr(JL.ast_mod, "ASTConfig",
                            functools.partial(jast.ASTConfig, **WIDTHS))
        monkeypatch.setattr(L.ast_mod, "ASTConfig",
                            functools.partial(ast_mod.ASTConfig, **WIDTHS))
    jparams, jcfg = JL.init_model(JL.TrainFoldConfig(**common))
    params, cfg = L.init_model(L.TrainFoldConfig(device="cpu", **common))
    assert cfg.hidden_size == jcfg.hidden_size == 32
    assert cfg.num_labels == jcfg.num_labels == 2
    want = jax.tree.map(np.asarray, jparams)
    got = _port_tree(params)
    _assert_trees_equal(got["head"], want["head"])
    _assert_trees_equal(got, want)
    if pretrained:  # the head is fresh, not the dir's 527-class one
        assert got["head"]["dense"]["kernel"].shape == (32, 2)
        assert got["head"]["dense"]["kernel"].std() > 0.01
