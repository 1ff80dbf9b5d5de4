"""The port's losses and optimizer against the JAX package's, on the same
seeded inputs.

Losses: tests/test_losses.py's tolerances (rtol 2e-5, atol 1e-6), values and
gradients with respect to the logits (against jax.grad). Optimizer: the
optax chain of JAX `make_optimizer` over several steps at atol 1e-7
(tests/test_optim_parity.py:101), with gradient norms above and below
max_grad_norm; the schedule at rtol 1e-6; the decay mask on the full AST
tree."""

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.train import losses as JL
from zenker_audio_detection_tpu.train import optim as JO
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.train import losses, optim

RTOL, ATOL = 2e-5, 1e-6


def _batch(seed, n=16, majority=None):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, 2)) * 2).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    if majority is not None:  # most rows of one class: flips the stage-2 α
        labels = (rng.random(n) < (0.8 if majority else 0.2)).astype(np.int32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    return logits, labels, mask


LOSS_CASES = (
    [("stage1_loss", dict(focal_gamma=g, label_smoothing=ls))
     for g in (0.0, 2.0) for ls in (0.0, 0.1)]
    + [("stage2_focal_loss", dict(class_weights=w, focal_alpha=a,
                                  focal_gamma=g, label_smoothing=ls))
       for w in (None, [0.7, 1.9]) for a in (None, 0.25)
       for g, ls in ((2.0, 0.1), (0.0, 0.0), (1.5, 0.2))]
    + [("stage2_weighted_ce", dict(class_weights=w, label_smoothing=ls))
       for w in (None, [0.7, 1.9]) for ls in (0.0, 0.1)])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("majority", [None, True, False])
@pytest.mark.parametrize("name,kw", LOSS_CASES)
def test_loss_matches_jax(name, kw, majority, masked):
    import jax
    import jax.numpy as jnp

    logits, labels, mask = _batch(len(kw) + 7 * (majority is True), 16,
                                  majority)
    extra = {"sample_mask": mask} if masked else {}
    jfn = getattr(JL, name)
    want, want_g = jax.value_and_grad(lambda lg: jfn(
        lg, jnp.asarray(labels), **kw,
        **{k: jnp.asarray(v) for k, v in extra.items()}))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = getattr(losses, name)(x, torch.from_numpy(labels).long(), **kw,
                                **{k: torch.from_numpy(v)
                                   for k, v in extra.items()})
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=RTOL,
                               atol=ATOL)


def test_stage2_alpha_flips_with_the_batch_majority():
    """α_t = α when fewer than half the labels are 1, else 1 - α: the same
    rows weigh 3x more in a batch whose majority is positive."""
    logits = torch.tensor([[0.3, -0.2], [1.0, 0.5], [-0.4, 0.9]])
    pos = torch.tensor([1, 1, 0])
    neg = torch.tensor([1, 0, 0])
    kw = dict(focal_alpha=0.25, focal_gamma=0.0, label_smoothing=0.0)
    for labels, alpha in ((pos, 0.75), (neg, 0.25)):
        plain = losses.stage2_focal_loss(logits, labels, **{**kw,
                                                            "focal_alpha": None})
        got = losses.stage2_focal_loss(logits, labels, **kw)
        torch.testing.assert_close(got, plain * alpha)
    # the masked label mean decides: only the last row (label 0) kept, so
    # the positive batch takes α, not 1 - α
    masked = losses.stage2_focal_loss(logits, pos, **kw,
                                      sample_mask=torch.tensor([0., 0., 1.]))
    last = losses.stage2_focal_loss(logits[2:], pos[2:],
                                    **{**kw, "focal_alpha": None})
    torch.testing.assert_close(masked, last * 0.25)


def test_loss_takes_bf16_logits_in_f32():
    logits, labels, _ = _batch(3)
    x = torch.from_numpy(logits).bfloat16()
    got = losses.stage1_loss(x, torch.from_numpy(labels), 2.0, 0.1)
    want = losses.stage1_loss(x.float(), torch.from_numpy(labels), 2.0, 0.1)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("labels", [[0, 1, 1, 1, 0], [0, 0, 0], [1]])
def test_inverse_frequency_weights_match_jax(labels):
    got = losses.inverse_frequency_weights(labels)
    want = JL.inverse_frequency_weights(labels)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch_size", [1, 4, 5, 16, 64])
@pytest.mark.parametrize("name", ["stage1_loss", "stage2_focal_loss"])
def test_hf_eval_loss_matches_jax(name, batch_size):
    logits, labels, _ = _batch(9, n=23)
    got = losses.hf_eval_loss(getattr(losses, name), logits, labels,
                              batch_size)
    want = JL.hf_eval_loss(getattr(JL, name), logits, labels, batch_size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_hf_eval_loss_of_nothing_is_nan():
    assert np.isnan(losses.hf_eval_loss(losses.stage1_loss,
                                        np.zeros((0, 2)), [], 4))


def _tree(rng):
    """Every decay-mask case: a kernel (decays), a bias (excluded), a
    LayerNorm's scale and bias (excluded), position embeddings (decay)."""
    return {
        "dense": {"kernel": rng.standard_normal((8, 8)).astype(np.float32),
                  "bias": rng.standard_normal(8).astype(np.float32)},
        "ln1": {"scale": rng.standard_normal(8).astype(np.float32),
                "bias": rng.standard_normal(8).astype(np.float32)},
        "pos_embed": rng.standard_normal((1, 3, 8)).astype(np.float32),
    }


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _grad_seq(tree, seed, steps, big):
    rng = np.random.default_rng(seed)
    return [{k: ({kk: (rng.standard_normal(vv.shape)
                       * (10.0 if s in big else 0.01)).astype(np.float32)
                  for kk, vv in v.items()} if isinstance(v, dict)
                 else (rng.standard_normal(v.shape)
                       * (10.0 if s in big else 0.01)).astype(np.float32))
             for k, v in tree.items()}
            for s in range(steps)]


@pytest.mark.parametrize("lr,total,warmup,wd,b2,max_norm", [
    (3.7e-5, 10, 0.2, 0.013, 0.97, 1.0),
    (1e-3, 8, 0.0, 0.0, 0.999, 1.0),
    (5e-3, 6, 1.0, 0.1, 0.95, 1.0),
    (2e-3, 7, 0.3, 0.05, 0.98, None),
])
def test_make_optimizer_matches_optax(lr, total, warmup, wd, b2, max_norm):
    import jax
    import jax.numpy as jnp
    import optax

    tree = _tree(np.random.default_rng(42))
    # steps 1 and 4 have norms far above max_grad_norm (clipped), the
    # others far below (not clipped)
    grads = _grad_seq(tree, total, total, big={1, 4})
    jtx = JO.make_optimizer(lr, total, warmup, wd, beta2=b2,
                            max_grad_norm=max_norm)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jtx.init(jparams)
    tx = optim.make_optimizer(lr, total, warmup, wd, beta2=b2,
                              max_grad_norm=max_norm)
    params = _torch(tree)
    state = tx.init(params)
    for s, g in enumerate(grads):
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, upd)
        upd, state = tx.update(_torch(g), state, params)
        params = optim.apply_updates(params, upd)
        got = _numpy(params)
        for k, want in jax.tree_util.tree_leaves_with_path(jparams):
            node = got
            for part in k:
                node = node[part.key]
            np.testing.assert_allclose(node, np.asarray(want), atol=1e-7,
                                       err_msg=f"step {s} {k}")
    assert state["count"] == total
    assert not np.allclose(got["dense"]["kernel"], tree["dense"]["kernel"])


def test_schedule_matches_jax():
    for lr, total, warmup in ((3.7e-5, 10, 0.2), (1e-3, 7, 0.0),
                              (5e-4, 9, 1.0)):
        want = JO.linear_schedule(lr, total, warmup)
        got = optim.linear_schedule(lr, total, warmup)
        for step in range(total + 3):
            np.testing.assert_allclose(got(step), float(want(step)),
                                       rtol=1e-6, err_msg=f"{step}")
    assert optim.linear_schedule(1e-3, 10, 0.2)(0) == 0.0  # lr(0) first


def test_decay_mask_matches_jax_on_the_ast_tree():
    import jax

    cfg = ast_mod.ASTConfig()
    jtree = jax.eval_shape(lambda: jast.init_params(jax.random.PRNGKey(0),
                                                    jast.ASTConfig()))
    want = JO.decay_mask(jtree)
    got = optim.decay_mask(ast_mod.init_params(np.random.default_rng(0), cfg))
    assert got == want
    assert got["pos_embed"] and got["cls_token"] and got["dist_token"]
    assert not got["encoder"]["ln1"]["scale"] and not got["head"]["ln"]["scale"]
    assert got["head"]["dense"]["kernel"] and not got["head"]["dense"]["bias"]


@pytest.mark.parametrize("g,clipped", [
    ([3.0, 4.0], [0.6, 0.8]),    # norm 5: scaled by 1 / 5
    ([0.6, 0.8], [0.6, 0.8]),    # norm 1: scaled by 1 / 1
    ([0.3, 0.4], [0.3, 0.4]),    # norm 0.5: kept
])
def test_clip_scales_exactly_at_the_norm(g, clipped):
    """optax clips when the norm is at least max_norm and then scales by
    max_norm / norm with no epsilon; the first moment shows the clipped
    gradient: (1 - b1) g'."""
    tx = optim.make_optimizer(1e-3, 10, 0.0, 0.0, max_grad_norm=1.0)
    p = {"w": torch.zeros(2)}
    _, state = tx.update({"w": torch.tensor(g)}, tx.init(p), p)
    torch.testing.assert_close(state["mu"]["w"],
                               (1 - 0.9) * torch.tensor(clipped),
                               atol=1e-8, rtol=1e-7)
