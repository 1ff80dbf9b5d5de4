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


# ---------------------------------------------------------------------------
# the traced losses and the tensor-hyperparameter AdamW (the fold- and
# trial-parallel steps)
# ---------------------------------------------------------------------------

TRACED = ("stage1_loss", "stage2_focal_loss", "stage2_weighted_ce")


def _traced_call(mod, name, logits, labels, gamma, ls, mask, weights):
    """`mod`'s <name>_traced with (γ, ls) traced, and its branchy twin's
    keyword arguments."""
    if name == "stage1_loss":
        return (mod.stage1_loss_traced(logits, labels, gamma, ls,
                                       sample_mask=mask),
                dict(focal_gamma=gamma, label_smoothing=ls))
    if name == "stage2_focal_loss":
        return (mod.stage2_focal_loss_traced(logits, labels, weights, 0.25,
                                             gamma, ls, sample_mask=mask),
                dict(class_weights=weights, focal_alpha=0.25,
                     focal_gamma=gamma, label_smoothing=ls))
    return (mod.stage2_weighted_ce_traced(logits, labels, weights, ls,
                                          sample_mask=mask),
            dict(class_weights=weights, label_smoothing=ls))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ls", [0.0, 0.07])
@pytest.mark.parametrize("gamma", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("name", TRACED)
def test_traced_loss_matches_jax_and_the_branchy_loss(name, gamma, ls,
                                                      masked):
    """*_traced with 0-d tensor (γ, ls) against the JAX *_traced (traced
    scalars) and against the port's branchy loss at the same point:
    values and gradients at 1e-6, finite gradients at γ = 0 (where the
    traced form must not take 0**-1)."""
    import jax
    import jax.numpy as jnp

    logits, labels, mask = _batch(int(gamma * 10 + ls * 100), 16)
    # one row pinned to p_t = 1 in f32: the focal base 1 - p_t is 0 there
    logits[0] = [60.0, -60.0]
    labels[0] = 0
    weights = None if name == "stage1_loss" else [0.7, 1.9]
    jmask = jnp.asarray(mask) if masked else None
    want, want_g = jax.value_and_grad(lambda lg: _traced_call(
        JL, name, lg, jnp.asarray(labels), jnp.float32(gamma),
        jnp.float32(ls), jmask, weights)[0])(jnp.asarray(logits))

    def port(fn_args):
        x = torch.from_numpy(logits).requires_grad_()
        out = fn_args(x)
        out.backward()
        return out.detach(), x.grad.numpy()

    tmask = torch.from_numpy(mask) if masked else None
    tlabels = torch.from_numpy(labels).long()
    got, got_g = port(lambda x: _traced_call(
        losses, name, x, tlabels, torch.tensor(gamma), torch.tensor(ls),
        tmask, weights)[0])
    _, kw = _traced_call(losses, name, torch.from_numpy(logits), tlabels,
                         gamma, ls, tmask, weights)
    plain, plain_g = port(lambda x: getattr(losses, name)(
        x, tlabels, **kw, sample_mask=tmask))
    assert np.isfinite(got_g).all()
    for value, grad in ((float(want), np.asarray(want_g)),
                        (float(plain), plain_g)):
        np.testing.assert_allclose(float(got), value, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_g, grad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", TRACED)
def test_traced_loss_vmaps_over_trials(name):
    """One vmapped call with per-trial (γ, ls) equals each trial's own
    call, on a batch the trials share."""
    logits, labels, mask = _batch(5, 16)
    gammas = torch.tensor([0.0, 1.0, 2.5])
    lss = torch.tensor([0.0, 0.07, 0.12])
    weights = None if name == "stage1_loss" else torch.tensor([0.7, 1.9])
    tl = torch.from_numpy(labels).long()
    tm = torch.from_numpy(mask)
    stacked = torch.from_numpy(np.stack([logits, logits * 0.5, -logits]))

    def one(lg, g, ls):
        return _traced_call(losses, name, lg, tl, g, ls, tm, weights)[0]

    got = torch.func.vmap(one)(stacked, gammas, lss)
    for t in range(3):
        torch.testing.assert_close(got[t], one(stacked[t], gammas[t], lss[t]),
                                   atol=0, rtol=0)


@pytest.mark.parametrize("lr,wd,b2,warmup", [
    (3.7e-5, 0.013, 0.97, 0.2),
    (1e-3, 0.0, 0.999, 0.05),
    (5e-4, 0.1, 0.95, 0.0),
])
def test_adamw_apply_matches_jax_and_make_optimizer(lr, wd, b2, warmup):
    """optim.adamw_apply over 5 steps (the second far above max_grad_norm)
    against the JAX adamw_apply at 1e-7, with the hyperparameters as 0-d
    f32 tensors on both sides, and against the port's make_optimizer chain
    with the same schedule read as a step-indexed lr (1e-7)."""
    import jax
    import jax.numpy as jnp

    tree = _tree(np.random.default_rng(0))
    total = 5
    sched = optim.linear_schedule(lr, total, warmup)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = JO.adamw_init(jparams)
    params = _torch(tree)
    state = optim.adamw_init(params)
    ref = _torch(tree)
    tx = optim.make_optimizer(lr, total, warmup, wd, beta2=b2)
    ref_state = tx.init(ref)
    mask = optim.decay_mask(params)
    for step in range(total):
        scale = 50.0 if step == 1 else 1.0
        g = jax.tree.map(lambda p: (np.random.default_rng(100 + step)
                                    .standard_normal(p.shape) * scale)
                         .astype(np.float32), tree)
        jparams, jstate = JO.adamw_apply(
            jparams, jstate, jax.tree.map(jnp.asarray, g),
            lr=jnp.float32(sched(step)), weight_decay=jnp.float32(wd),
            beta2=jnp.float32(b2), mask_tree=JO.decay_mask(jparams))
        params, state = optim.adamw_apply(
            params, state, _torch(g), lr=torch.tensor(sched(step)),
            weight_decay=torch.tensor(wd, dtype=torch.float32),
            beta2=torch.tensor(b2, dtype=torch.float32), mask_tree=mask)
        upd, ref_state = tx.update(_torch(g), ref_state, ref)
        ref = optim.apply_updates(ref, upd)
        got = _numpy(params)
        for k, want in jax.tree_util.tree_leaves_with_path(jparams):
            node, other = got, _numpy(ref)
            for part in k:
                node, other = node[part.key], other[part.key]
            np.testing.assert_allclose(node, np.asarray(want), atol=1e-7,
                                       err_msg=f"step {step} {k}")
            np.testing.assert_allclose(node, other, atol=1e-7,
                                       err_msg=f"step {step} {k} chain")
    assert int(state["count"]) == int(jstate["count"]) == total
    assert state["count"].dtype == torch.int32


def test_adamw_apply_vmapped_clips_each_member_alone():
    """Under vmap the global norm is each member's own: a member with
    gradients far above max_grad_norm beside one far below comes out as
    each would alone (a norm over both would couple them)."""
    trees = [_torch(_tree(np.random.default_rng(s))) for s in (1, 2)]
    grads = [_torch(g) for g in _grad_seq(_tree(np.random.default_rng(1)),
                                          3, 2, big={0})][:2]
    assert float(optim.global_norm(grads[0])) > 1.0 > float(
        optim.global_norm(grads[1]))

    def stacked(*xs):
        return optim.tree_map(lambda *a: torch.stack(a), *xs)

    mask = optim.decay_mask(trees[0])
    lr = torch.tensor([1e-2, 3e-3])
    wd = torch.tensor([0.01, 0.1])

    def one(p, s, g, lr, wd):
        return optim.adamw_apply(p, s, g, lr=lr, weight_decay=wd, beta2=0.98,
                                 mask_tree=mask)

    got, got_state = torch.func.vmap(one)(
        stacked(*trees), torch.func.vmap(optim.adamw_init)(stacked(*trees)),
        stacked(*grads), lr, wd)
    for i in range(2):
        want, want_state = one(trees[i], optim.adamw_init(trees[i]),
                               grads[i], lr[i], wd[i])
        for (_, a), (_, b) in zip(optim.tree_items(got),
                                  optim.tree_items(want)):
            torch.testing.assert_close(a[i], b, atol=1e-7, rtol=0)
        assert int(got_state["count"][i]) == int(want_state["count"]) == 1
