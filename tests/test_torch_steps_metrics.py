"""The port's train/eval steps against the JAX package's, and its numpy
metrics against the JAX package's sklearn-backed ones, on the same seeded
inputs and the same parameter tree (carried across by
`models.convert.params_from_jax`).

Steps in f32: loss and logits within 1e-5, parameters atol 5e-6, rtol 1e-5
(tests/test_grad_accum.py:74). Metrics: equal to sklearn's
(average="binary", zero_division=0) and its report text."""

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.train import losses as JL
from zenker_audio_detection_tpu.train import metrics as JM
from zenker_audio_detection_tpu.train import optim as JO
from zenker_audio_detection_tpu.train import steps as JS
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert
from zenker_audio_detection_tpu_torch.train import losses, metrics, optim
from zenker_audio_detection_tpu_torch.train import steps

from test_torch_ast import random_jax_tree

# tests/test_pallas_vjp.py:57-60
SMALL = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
             intermediate_size=64, patch_size=8, frequency_stride=4,
             time_stride=4, num_mel_bins=16, max_length=64, num_labels=2)


def _data(seed, n, cfg):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, cfg.max_length, cfg.num_mel_bins)).astype(
        np.float32)
    return feats, rng.integers(0, 2, n).astype(np.int32)


# The key bias's gradient is 0 in exact arithmetic (adding q . b_k to every
# score of a row leaves the softmax as it is), so both sides hold ~1e-10 of
# rounding noise there, and Adam turns noise into steps of up to
# lr * |g| / eps = 5e-3 * 1e-9 / 1e-8 = 5e-4: that leaf is held to three
# such steps. Every other leaf is held to the stated tolerance.
NOISE_LEAF, NOISE_ATOL = ("encoder", "k", "bias"), 3 * 5e-4


def _close_trees(got_torch, want_jax, atol, rtol):
    import jax

    got = convert.params_to_numpy(got_torch)
    for path, want in jax.tree_util.tree_leaves_with_path(want_jax):
        keys = tuple(part.key for part in path)
        node = got
        for k in keys:
            node = node[k]
        tol = ((NOISE_ATOL, 0.0) if keys == NOISE_LEAF else (atol, rtol))
        np.testing.assert_allclose(node, np.asarray(want), atol=tol[0],
                                   rtol=tol[1], err_msg=str(keys))


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "dots_no_batch")])
def test_train_step_matches_jax(remat, policy):
    import jax
    import jax.numpy as jnp

    jcfg = jast.ASTConfig(**SMALL)
    cfg = ast_mod.ASTConfig(**SMALL)
    tree = random_jax_tree(0, jcfg)
    loss = lambda lib: (lambda lg, y: lib.stage1_loss(lg, y, 2.0, 0.07))
    jtx = JO.make_optimizer(5e-3, 10, 0.1, 0.01, beta2=0.97)
    tx = optim.make_optimizer(5e-3, 10, 0.1, 0.01, beta2=0.97)
    jstep = JS.make_train_step(jtx, jcfg, loss(JL), dtype=jnp.float32,
                               remat=remat, remat_policy=policy)
    step = steps.make_train_step(tx, cfg, loss(losses), dtype=torch.float32,
                                 remat=remat, remat_policy=policy)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jtx.init(jparams)
    params = convert.params_from_jax(tree)
    state = tx.init(params)
    first = convert.params_to_numpy(params)
    for s in range(3):
        feats, labels = _data(10 + s, 6, cfg)
        jparams, jstate, jloss, jlogits = jstep(
            jparams, jstate, jnp.asarray(feats), jnp.asarray(labels))
        params, state, loss_val, logits = step(
            params, state, torch.from_numpy(feats),
            torch.from_numpy(labels).long())
        assert loss_val.shape == () and logits.shape == (6, 2)
        np.testing.assert_allclose(float(loss_val), float(jloss), atol=1e-5)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-5)
        _close_trees(params, jparams, atol=5e-6, rtol=1e-5)
    assert not np.allclose(convert.params_to_numpy(params)["encoder"]["q"][
        "kernel"], first["encoder"]["q"]["kernel"])


def test_train_step_leaves_its_arguments():
    cfg = ast_mod.ASTConfig(**SMALL)
    params = ast_mod.init_params(np.random.default_rng(0), cfg)
    before = convert.params_to_numpy(params)
    tx = optim.make_optimizer(1e-3, 10, 0.0, 0.01)
    state = tx.init(params)
    feats, labels = _data(1, 4, cfg)
    new, new_state, _, _ = steps.make_train_step(
        tx, cfg, losses.stage1_loss, dtype=torch.float32)(
            params, state, torch.from_numpy(feats),
            torch.from_numpy(labels).long())
    assert state["count"] == 0 and new_state["count"] == 1
    after = convert.params_to_numpy(params)
    for k in ("pos_embed", "cls_token"):
        np.testing.assert_array_equal(after[k], before[k])
    assert not new["encoder"]["q"]["kernel"].requires_grad


def _accum_setup(seed=0, n=8):
    """tests/test_grad_accum.py's setup."""
    cfg = ast_mod.ASTConfig(hidden_size=32, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=64,
                            num_labels=2, max_length=64, num_mel_bins=128)
    params = ast_mod.init_params(np.random.default_rng(seed), cfg)
    feats, labels = _data(seed, n, cfg)
    tx = optim.make_optimizer(1e-3, 10, 0.1, 0.01)
    return (cfg, params, torch.from_numpy(feats),
            torch.from_numpy(labels).long(), tx)


def test_accum_step_matches_monolithic_update():
    """Two accumulated micro-batches of 4 equal one batch-8 train step."""
    cfg, params, feats, labels, tx = _accum_setup()
    loss = losses.stage1_loss
    mono = steps.make_train_step(tx, cfg, loss, dtype=torch.float32)
    p_mono, _, loss_mono, _ = mono(params, tx.init(params), feats, labels)

    grad_step, apply_step = steps.make_accum_steps(tx, cfg, loss,
                                                   dtype=torch.float32)
    buf = optim.tree_map(torch.zeros_like, params)
    buf, l1, _ = grad_step(params, buf, feats[:4], labels[:4])
    buf, l2, _ = grad_step(params, buf, feats[4:], labels[4:])
    p_acc, _, buf = apply_step(params, tx.init(params), buf, 2.0)

    assert np.isclose(float(loss_mono), (float(l1) + float(l2)) / 2,
                      atol=1e-6)
    for (_, m), (_, a) in zip(optim.tree_items(p_mono), optim.tree_items(p_acc)):
        torch.testing.assert_close(a, m, atol=5e-6, rtol=1e-5)
    assert all(not x.any() for _, x in optim.tree_items(buf))


def test_accum_tail_group_equal_weights_micros():
    """A short trailing micro-batch weighs like the full ones: the applied
    gradient is the mean of the micro-mean gradients."""
    cfg, params, feats, labels, tx = _accum_setup()
    loss = losses.stage1_loss
    loss_fn = steps.make_loss_fn(cfg, loss, torch.float32)
    grad_step, apply_step = steps.make_accum_steps(tx, cfg, loss,
                                                   dtype=torch.float32)
    buf = optim.tree_map(torch.zeros_like, params)
    buf, _, _ = grad_step(params, buf, feats[:4], labels[:4])
    buf, _, _ = grad_step(params, buf, feats[4:6], labels[4:6])  # tail of 2
    p_acc, _, _ = apply_step(params, tx.init(params), buf, 2.0)

    _, g1 = steps.value_and_grad(loss_fn, params, feats[:4], labels[:4])
    _, g2 = steps.value_and_grad(loss_fn, params, feats[4:6], labels[4:6])
    g = optim.tree_map(lambda a, b: (a + b) / 2, g1, g2)
    updates, _ = tx.update(g, tx.init(params), params)
    p_ref = optim.apply_updates(params, updates)
    for (_, m), (_, a) in zip(optim.tree_items(p_ref), optim.tree_items(p_acc)):
        torch.testing.assert_close(a, m, atol=5e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 5e-5),
                                        ("bfloat16", 1e-2)])
def test_eval_step_matches_jax_forward(dtype, atol):
    """f32 at tests/test_pallas_attention.py's forward bound; bf16 at the
    bf16 forward bound of tests/test_torch_ast.py."""
    import jax.numpy as jnp

    jcfg = jast.ASTConfig(**SMALL)
    cfg = ast_mod.ASTConfig(**SMALL)
    tree = random_jax_tree(3, jcfg)
    feats, _ = _data(4, 5, cfg)
    want = np.asarray(jast.forward(tree, feats, jcfg,
                                   dtype=getattr(jnp, dtype)))
    got = steps.make_eval_step(cfg, getattr(torch, dtype))(
        convert.params_from_jax(tree), torch.from_numpy(feats))
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


def test_value_and_grad_gives_unreached_leaves_zeros():
    params = {"a": torch.tensor([1.0, 2.0]), "b": {"c": torch.ones(3)}}
    (loss, aux), grads = steps.value_and_grad(
        lambda p: ((p["a"] ** 2).sum(), "aux"), params)
    assert float(loss) == 5.0 and aux == "aux"
    torch.testing.assert_close(grads["a"], torch.tensor([2.0, 4.0]))
    torch.testing.assert_close(grads["b"]["c"], torch.zeros(3))


METRIC_CASES = [
    (np.random.default_rng(0).integers(0, 2, 50),
     np.random.default_rng(1).integers(0, 2, 50)),
    (np.zeros(7, int), np.zeros(7, int)),           # one class only
    (np.ones(6, int), np.ones(6, int)),             # one class only
    (np.array([0, 1, 1, 0]), np.zeros(4, int)),     # no positive predicted
    (np.array([1, 1, 0]), np.array([1, 0, 1])),
]


@pytest.mark.parametrize("y_true,y_pred", METRIC_CASES)
def test_binary_metrics_match_sklearn(y_true, y_pred):
    assert metrics.binary_metrics(y_true, y_pred) == JM.binary_metrics(
        y_true, y_pred)


@pytest.mark.parametrize("names", [["Healthy", "Zenker"], ["Idle", "Swallow"],
                                   ["a", "a-very-long-class-name"]])
@pytest.mark.parametrize("y_true,y_pred", METRIC_CASES
                         + [(np.array([0, 2, 1, 2]), np.array([0, 1, 1, 2]))])
def test_confusion_and_report_match_sklearn(y_true, y_pred, names):
    cm, report = metrics.confusion_and_report(y_true, y_pred, names)
    want_cm, want_report = JM.confusion_and_report(y_true, y_pred, names)
    np.testing.assert_array_equal(cm, want_cm)
    assert cm.dtype == want_cm.dtype
    assert report == want_report


@pytest.mark.parametrize("n,batch,runtime", [(23, 4, 0.123456789),
                                             (8, 8, 1e-12), (1, 4, 2.0)])
def test_hf_eval_metrics_match_jax(n, batch, runtime):
    rng = np.random.default_rng(n)
    logits = rng.standard_normal((n, 2)).astype(np.float32)
    labels = rng.integers(0, 2, n)
    kw = dict(loss=0.4242, runtime=runtime, batch_size=batch, epoch=3)
    got = metrics.hf_eval_metrics(logits, labels, **kw)
    want = JM.hf_eval_metrics(logits, labels, **kw)
    assert list(got) == list(want)
    assert got == want


def test_metrics_refuse_no_samples():
    """sklearn refuses empty inputs; so does the port."""
    with pytest.raises(ValueError):
        JM.binary_metrics([], [])
    with pytest.raises(ValueError, match="sample"):
        metrics.binary_metrics([], [])
