"""The port's checkpoint/resume (`train/loop.py`), as tests/test_resume.py
holds the JAX package's: N epochs with an interruption equal N epochs
straight through, here bit for bit (parameters, optimizer state, the epoch
order's RNG stream and the best-model tracking are all restored); the
checkpoint round trip with the optimizer's scalar count; a crash while
saving keeps the previous checkpoint; staging dirs are ignored; a corrupt
train state raises a typed error. The checkpoints keep the JAX layout, so
each package reads the other's (checked both ways)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.train import loop as JL
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert
from zenker_audio_detection_tpu_torch.train import loop as L
from zenker_audio_detection_tpu_torch.train import optim

from test_train_loop import make_dataset, tiny_pretrained_dir

SMALL = dict(hidden_size=8, num_hidden_layers=1, num_attention_heads=2,
             intermediate_size=16, num_mel_bins=16, max_length=32,
             patch_size=8, frequency_stride=4, time_stride=4)


class StopAfter:
    def __init__(self, at):
        self.at = at

    def __call__(self, epoch, metrics):
        return epoch >= self.at


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("resume")
    data_dir = make_dataset(tmp_path, np.random.default_rng(1), n_per_class=6)
    base = L.TrainFoldConfig(
        stage="stage1", data_dir=data_dir, output_root="",  # set per test
        pretrained_model_dir=tiny_pretrained_dir(tmp_path), num_epochs=4,
        batch_size=4, learning_rate=5e-4, enable_early_stopping=False,
        augment=False, dtype=torch.float32, device="cpu")
    return tmp_path, base


def _best(output_root):
    return convert.read_safetensors(str(Path(output_root) / "fold1" / "best"
                                        / "model.safetensors"))


def test_interrupted_equals_straight(env):
    tmp_path, base = env
    straight = dataclasses.replace(base, output_root=str(tmp_path / "straight"))
    m_straight = L.train_fold(1, straight)
    resumed = str(tmp_path / "resumed")
    L.train_fold(1, dataclasses.replace(base, output_root=resumed,
                                        on_epoch_end=StopAfter(2)))
    m_resumed = L.train_fold(1, dataclasses.replace(
        base, output_root=resumed, resume=True))
    for k in m_straight:
        if not ("runtime" in k or "per_second" in k):
            assert m_straight[k] == m_resumed[k], k
    history = [json.loads((Path(root) / "fold1" / "history.json").read_text())
               for root in (straight.output_root, resumed)]
    assert history[0] == history[1] and len(history[0]) == 4
    a, b = _best(straight.output_root), _best(resumed)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_resume_without_checkpoint_starts_fresh(env):
    tmp_path, base = env
    m = L.train_fold(1, dataclasses.replace(
        base, output_root=str(tmp_path / "fresh"), resume=True, num_epochs=1))
    assert any(k.endswith("_f1") for k in m)


def _small_state(seed=0):
    """A small model's parameters and its AdamW state after one update."""
    cfg = ast_mod.ASTConfig(**SMALL)
    params = ast_mod.init_params(np.random.default_rng(seed), cfg)
    tx = optim.make_optimizer(1e-4, 10, 0.1, 0.01)
    grads = optim.tree_map(torch.ones_like, params)
    updates, opt_state = tx.update(grads, tx.init(params), params)
    return optim.apply_updates(params, updates), opt_state, tx


def _full_state(epoch):
    return {"epoch": epoch, "best_f1": 0.0, "best_epoch": 0,
            "patience_left": 2,
            "rng_state": np.random.default_rng(0).bit_generator.state}


def _assert_tree_equal(a, b):
    for (pa, x), (pb, y) in zip(sorted(optim.tree_items(a)),
                                sorted(optim.tree_items(b))):
        assert pa == pb and x.dtype == y.dtype and torch.equal(x, y), pa


def test_checkpoint_roundtrip_primitives(tmp_path):
    params, opt_state, tx = _small_state()
    ck = str(tmp_path / "ck")
    state = {"epoch": 3, "best_f1": 0.5, "best_epoch": 2, "patience_left": 1,
             "rng_state": np.random.default_rng(7).bit_generator.state,
             "history": [{"epoch": 1, "f1": 0.4}]}
    L.save_checkpoint(ck, params, opt_state, state)
    p2, o2, s2 = L.load_checkpoint(ck, params, tx.init(params))
    _assert_tree_equal(params, p2)
    _assert_tree_equal(opt_state["mu"], o2["mu"])
    _assert_tree_equal(opt_state["nu"], o2["nu"])
    assert s2["epoch"] == 3 and s2["best_epoch"] == 2
    assert s2["rng_state"] == state["rng_state"]
    assert s2["history"] == state["history"]


def test_checkpoint_roundtrip_with_scalar_leaf(tmp_path):
    """The optimizer's step count, a Python int in the port's state and an
    int32 scalar leaf of the JAX state, is written as leaf_0000 and as the
    last leaf (the schedule's count), with no gap in the leaf_NNNN
    numbering, and comes back as an int."""
    params, opt_state, tx = _small_state()
    opt_state = dict(opt_state, count=7)
    ck = tmp_path / "ck"
    L.save_checkpoint(str(ck), params, opt_state, _full_state(1))
    leaves = convert.read_safetensors(str(ck / "opt_state.safetensors"))
    n = len(list(optim.tree_items(params)))
    assert sorted(leaves) == [f"leaf_{i:04d}" for i in range(2 + 2 * n)]
    assert leaves["leaf_0000"].dtype == np.int32
    assert int(leaves["leaf_0000"][0]) == int(
        leaves[f"leaf_{1 + 2 * n:04d}"][0]) == 7
    _, o2, _ = L.load_checkpoint(str(ck), params, tx.init(params))
    assert o2["count"] == 7 and type(o2["count"]) is int


def test_loaded_trees_keep_the_template_order(tmp_path):
    """A checkpoint comes back in the template's key order, not the
    file's: `optim.global_norm` sums the leaves in that order, so a resumed
    run in another order clipped its gradients by a norm an ulp apart from
    the straight run's and left bitwise resume."""
    params, opt_state, tx = _small_state()
    # the template's keys in reverse, at every level
    def reverse(tree):
        return {k: reverse(v) if isinstance(v, dict) else v
                for k, v in reversed(list(tree.items()))}

    params = reverse(params)
    opt_state = dict(opt_state, mu=reverse(opt_state["mu"]),
                     nu=reverse(opt_state["nu"]))
    ck = str(tmp_path / "ck")
    L.save_checkpoint(ck, params, opt_state, _full_state(1))
    p2, o2, _ = L.load_checkpoint(ck, params, tx.init(params))
    for want, got in ((params, p2), (opt_state["mu"], o2["mu"]),
                      (opt_state["nu"], o2["nu"])):
        assert [k for k, _ in optim.tree_items(got)] == \
            [k for k, _ in optim.tree_items(want)]
        assert torch.equal(optim.global_norm(got), optim.global_norm(want))


def test_checkpoint_layout_mismatch_raises(tmp_path):
    params, opt_state, tx = _small_state()
    ck = tmp_path / "ck"
    L.save_checkpoint(str(ck), params, opt_state, _full_state(1))
    leaves = convert.read_safetensors(str(ck / "opt_state.safetensors"))
    del leaves[max(leaves)]
    convert.write_safetensors(leaves, str(ck / "opt_state.safetensors"))
    with pytest.raises(ValueError, match="layout mismatch"):
        L.load_checkpoint(str(ck), params, tx.init(params))


def _jax_small_state():
    import jax
    import jax.numpy as jnp
    import optax

    from zenker_audio_detection_tpu.train import optim as joptim

    cfg = jast.ASTConfig(**SMALL)
    params = jast.init_params(jax.random.PRNGKey(0), cfg)
    tx = joptim.make_optimizer(1e-4, 10, 0.1, 0.01)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.5), params)
    updates, opt_state = tx.update(grads, tx.init(params), params)
    params = optax.apply_updates(params, updates)
    adam = next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    return params, opt_state, tx, adam


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    import jax

    params, opt_state, _, adam = _jax_small_state()
    ck = str(tmp_path / "ck")
    JL.save_checkpoint(ck, params, opt_state, _full_state(2))
    template = convert.params_from_jax(jax.tree.map(np.asarray, params))
    tx = optim.make_optimizer(1e-4, 10, 0.1, 0.01)
    p2, o2, s2 = L.load_checkpoint(ck, template, tx.init(template))
    _assert_tree_equal(template, p2)
    for key in ("mu", "nu"):
        want = convert.params_from_jax(jax.tree.map(np.asarray,
                                                    getattr(adam, key)))
        _assert_tree_equal(want, o2[key])
    assert o2["count"] == int(adam.count) == 1 and s2["epoch"] == 2


def test_a_port_checkpoint_resumes_in_jax(tmp_path):
    import jax

    jparams, _, jtx, _ = _jax_small_state()
    params, opt_state, _ = _small_state()
    ck = str(tmp_path / "ck")
    L.save_checkpoint(ck, params, opt_state, _full_state(2))
    p2, o2, _ = JL.load_checkpoint(ck, jparams, jtx.init(jparams))
    want = convert.params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(a, np.asarray(b))
    import optax

    adam = next(s for s in jax.tree.leaves(
        o2, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    assert int(adam.count) == opt_state["count"] == 1
    for key in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(convert.params_to_numpy(
                opt_state[key])), jax.tree.leaves(getattr(adam, key))):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_corrupt_train_state_raises_typed(tmp_path):
    params, opt_state, tx = _small_state()
    good = _full_state(3)
    ck = str(tmp_path / "ck")
    L.save_checkpoint(ck, params, opt_state, good)
    state_path = Path(ck) / "train_state.json"

    state_path.write_text("{truncated")
    with pytest.raises(ValueError, match="train_state.json.*not valid JSON"):
        L.load_checkpoint(ck, params, tx.init(params))
    state_path.write_text("[1, 2]")
    with pytest.raises(ValueError, match="JSON object"):
        L.load_checkpoint(ck, params, tx.init(params))
    for key in ("epoch", "best_f1", "best_epoch", "patience_left",
                "rng_state"):
        bad = {k: v for k, v in good.items() if k != key}
        state_path.write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=f"missing required key '{key}'"):
            L.load_checkpoint(ck, params, tx.init(params))
        state_path.write_text(json.dumps(dict(good, **{key: "nope"})))
        with pytest.raises(ValueError, match=f"key '{key}'"):
            L.load_checkpoint(ck, params, tx.init(params))
    state_path.write_text(json.dumps(dict(good, epoch=True)))
    with pytest.raises(ValueError, match="key 'epoch'"):
        L.load_checkpoint(ck, params, tx.init(params))


def test_checkpoint_save_crash_preserves_previous(tmp_path, monkeypatch):
    params, opt_state, tx = _small_state()
    fold_dir = tmp_path / "fold1"
    ck10 = str(fold_dir / "checkpoint-10")
    L.save_checkpoint(ck10, params, opt_state, _full_state(1))

    calls = {"n": 0}
    real = convert.write_safetensors

    def crashing(tensors, path):
        calls["n"] += 1
        if calls["n"] == 2:  # params written, die before opt_state lands
            raise RuntimeError("simulated crash mid-checkpoint")
        real(tensors, path)

    monkeypatch.setattr(L.convert, "write_safetensors", crashing)
    with pytest.raises(RuntimeError):
        L.save_checkpoint(str(fold_dir / "checkpoint-20"), params, opt_state,
                          _full_state(2))
    monkeypatch.undo()

    assert not (fold_dir / "checkpoint-20").exists()  # nothing partial
    assert L.latest_checkpoint(str(fold_dir)) == ck10  # intact one wins
    _, _, s2 = L.load_checkpoint(ck10, params, tx.init(params))
    assert s2["epoch"] == 1
    # a retry with the stale .tmp staging dir still present succeeds
    L.save_checkpoint(str(fold_dir / "checkpoint-20"), params, opt_state,
                      _full_state(2))
    assert L.latest_checkpoint(str(fold_dir)).endswith("checkpoint-20")


def test_latest_checkpoint_ignores_staging_dirs(tmp_path):
    params, opt_state, _ = _small_state()
    fold_dir = tmp_path / "fold1"
    L.save_checkpoint(str(fold_dir / "checkpoint-10"), params, opt_state,
                      _full_state(1))
    (fold_dir / "checkpoint-20.tmp").mkdir()  # crashed save's leftover
    (fold_dir / "checkpoint-x").mkdir()
    assert L.latest_checkpoint(str(fold_dir)).endswith("checkpoint-10")
    assert L.latest_checkpoint(str(tmp_path / "none")) is None


def test_resume_rotates_prior_runs_checkpoints(env):
    tmp_path, base = env
    root = str(tmp_path / "rotate")
    L.train_fold(1, dataclasses.replace(base, output_root=root,
                                        on_epoch_end=StopAfter(2)))
    fold_dir = Path(root) / "fold1"
    before = sorted(p.name for p in fold_dir.glob("checkpoint-*"))
    assert len(before) == 2  # limit = max(2, (4+1)//2) = 2
    L.train_fold(1, dataclasses.replace(base, output_root=root, resume=True))
    after = sorted(p.name for p in fold_dir.glob("checkpoint-*"))
    assert len(after) == 2, after
    assert after != before
