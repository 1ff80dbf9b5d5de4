"""The training parts of the port's AST: the "kernel" attention route under
autograd, remat and its policies, `adapt_max_length` and `reinit_head`,
against the JAX package where it has a counterpart."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert
from zenker_audio_detection_tpu_torch.ops import attention as A
from zenker_audio_detection_tpu_torch.train import losses, optim, steps

from test_torch_ast import TINY, random_jax_tree


def _params(seed=0, **over):
    cfg = ast_mod.ASTConfig(**{**TINY, **over})
    tree = random_jax_tree(seed, jast.ASTConfig(**{**TINY, **over}))
    return cfg, convert.params_from_jax(tree)


def _features(seed, b, cfg):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (b, cfg.max_length, cfg.num_mel_bins)).astype(np.float32))


def _grads(params, x, cfg, **kw):
    labels = torch.tensor([0, 1, 1])

    def loss_fn(p, x):
        logits = ast_mod.forward(p, x, cfg, **kw)
        return losses.stage1_loss(logits, labels), logits

    return steps.value_and_grad(loss_fn, params, x)


def test_kernel_route_keeps_the_qkv_gradients(monkeypatch):
    """On the card `mha_packed_lse`, the forward that runs when a gradient
    is needed, fills its tensors through a ctypes call, which has no
    grad_fn. A stand-in that does the same on the CPU: the "kernel" route
    must still give the q, k and v projections the gradients of the
    "torch" route (f32, 1e-5), as the JAX "pallas" route does through its
    custom VJP."""
    calls = []

    def opaque(q, k, v, *, num_heads):
        calls.append(num_heads)
        with torch.no_grad():
            return A.mha_packed_lse_reference(q, k, v, num_heads)

    monkeypatch.setattr(A, "mha_packed_lse", opaque)
    cfg, params = _params(1)
    x = _features(2, 3, cfg)
    (want_loss, _), want = _grads(params, x, cfg, attention_impl="torch")
    (got_loss, _), got = _grads(params, x, cfg, attention_impl="kernel")
    assert calls == [cfg.num_attention_heads] * cfg.num_hidden_layers
    assert abs(float(got_loss) - float(want_loss)) < 1e-6
    for name in ("q", "k", "v"):
        g, w = got["encoder"][name]["kernel"], want["encoder"][name]["kernel"]
        assert float(w.abs().max()) > 0
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _backward_mms(params, x, cfg, **kw):
    """Loss, gradients and the `mm` calls the backward made (recomputed
    forward products included)."""
    paths = [path for path, _ in optim.tree_items(params)]
    leaves = [leaf.detach().requires_grad_()
              for _, leaf in optim.tree_items(params)]
    p = optim.tree_from_items(zip(paths, leaves))
    loss = ast_mod.forward(p, x, cfg, **kw).square().sum()
    with _CountMM() as count:
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, count.mm


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_remat_changes_no_number(impl):
    """remat off, "full" and "dots_no_batch" give the same loss and
    gradients. "full" recomputes the weight products of every block in the
    backward: five of the six, since the recompute stops once the last
    tensor the backward needs is back, and nothing keeps fc2's product.
    "dots_no_batch" keeps them, as the JAX
    checkpoint_dots_with_no_batch_dims policy does, and recomputes the
    attention instead."""
    cfg, params = _params(3)
    x = _features(4, 2, cfg)
    base = _backward_mms(params, x, cfg, attention_impl=impl)
    runs = {pol: _backward_mms(params, x, cfg, attention_impl=impl,
                               remat=True, remat_policy=pol)
            for pol in ast_mod.REMAT_POLICIES}
    for loss, grads, _ in runs.values():
        torch.testing.assert_close(loss, base[0], atol=0, rtol=0)
        for g, w in zip(grads, base[1]):
            torch.testing.assert_close(g, w, atol=1e-7, rtol=1e-6)
    layers = cfg.num_hidden_layers
    assert runs["full"][2] == base[2] + 5 * layers
    assert runs["dots_no_batch"][2] == base[2]


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_remat_matches_jax_gradients(impl, monkeypatch):
    """The f32 gradient of the remat'd forward against jax.grad of the JAX
    remat'd forward, on the same tree (the JAX "pallas" route in interpret
    mode)."""
    import jax
    import jax.numpy as jnp

    from zenker_audio_detection_tpu.ops import attention as JA

    orig = JA.mha_packed
    monkeypatch.setattr(JA, "mha_packed", lambda q, k, v, **kw: orig(
        q, k, v, **{**kw, "interpret": True}))
    jcfg = jast.ASTConfig(**TINY)
    cfg = ast_mod.ASTConfig(**TINY)
    tree = random_jax_tree(5, jcfg)
    x = _features(6, 2, cfg)
    jimpl = {"torch": "xla", "kernel": "pallas"}[impl]
    jgrad = jax.grad(lambda p: jnp.sum(jnp.square(jast.forward(
        p, x.numpy(), jcfg, remat=True, attention_impl=jimpl))))(tree)
    params = convert.params_from_jax(tree)
    _, grads, _ = _backward_mms(params, x, cfg, remat=True,
                                attention_impl=impl)
    paths = [path for path, _ in optim.tree_items(params)]
    got = dict(optim.tree_items(convert.params_to_numpy(
        optim.tree_from_items(zip(paths, grads)))))
    want = dict(optim.tree_items(jax.tree.map(np.asarray, jgrad)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=str(k))


def test_forward_rejects_unknown_remat_policy():
    cfg, params = _params(0)
    with pytest.raises(ValueError, match="remat_policy"):
        ast_mod.forward(params, _features(0, 1, cfg), cfg, remat=True,
                        remat_policy="dots")


@pytest.mark.parametrize("new_len", [128, 2048, 64, 32])
def test_adapt_max_length_matches_jax(new_len):
    """Exactly the JAX function's position embeddings and config, on a
    random pos_embed (full AST width, 1024 frames)."""
    jcfg = jast.ASTConfig()
    cfg = ast_mod.ASTConfig()
    pe = np.random.default_rng(new_len).standard_normal(
        (1, cfg.seq_length, cfg.hidden_size)).astype(np.float32)
    jparams, jnew = jast.adapt_max_length({"pos_embed": pe, "x": 1}, jcfg,
                                          new_len)
    params, new = ast_mod.adapt_max_length(
        {"pos_embed": torch.from_numpy(pe), "x": 1}, cfg, new_len)
    assert new == ast_mod.ASTConfig(**vars(jnew))
    assert params["x"] == 1
    got = params["pos_embed"].numpy()
    assert got.shape == (1, new.seq_length, cfg.hidden_size)
    np.testing.assert_array_equal(got, np.asarray(jparams["pos_embed"]))


def test_adapted_model_runs_at_its_length():
    cfg, params = _params(7)
    short, scfg = ast_mod.adapt_max_length(params, cfg, 32)
    logits = ast_mod.forward(short, _features(8, 2, scfg), scfg)
    assert logits.shape == (2, 2) and torch.isfinite(logits).all()


def test_reinit_head():
    """The trunk is kept (the same tensors), the head is HF's fresh one:
    unit/zero LayerNorm, zero bias, N(0, 0.02) kernel. The kernel's draws
    come from a numpy Generator and differ from the JAX function's, which
    takes a jax.random key; only their distribution is compared."""
    cfg = ast_mod.ASTConfig()
    params = ast_mod.init_params(np.random.default_rng(0), cfg)
    params["head"]["ln"]["scale"] = params["head"]["ln"]["scale"] * 3.0
    new = ast_mod.reinit_head(np.random.default_rng(1), params, cfg,
                              num_labels=5)
    for k in params:
        if k != "head":
            assert new[k] is params[k]
    head = new["head"]
    assert (head["ln"]["scale"] == 1).all() and not head["ln"]["bias"].any()
    assert not head["dense"]["bias"].any()
    kernel = head["dense"]["kernel"]
    assert kernel.shape == (768, 5) and kernel.dtype == torch.float32
    assert abs(float(kernel.std()) - 0.02) < 0.001
    assert abs(float(kernel.mean())) < 0.001
    again = ast_mod.reinit_head(np.random.default_rng(1), params, cfg)
    assert again["head"]["dense"]["kernel"].shape == (768, 2)
    assert (params["head"]["ln"]["scale"] == 3).all()  # input untouched


def test_model_trains_with_kernel_attention():
    """tests/test_pallas_vjp.py:44-83 in the port: ten steps of
    make_optimizer(3e-3, 20, 0.0, 0.0) on attention_impl="kernel" lower
    the stage-1 loss of a fixed batch."""
    cfg = ast_mod.ASTConfig(hidden_size=32, num_hidden_layers=1,
                            num_attention_heads=4, intermediate_size=64,
                            patch_size=8, frequency_stride=4, time_stride=4,
                            num_mel_bins=16, max_length=64, num_labels=2)
    params = ast_mod.init_params(np.random.default_rng(0), cfg)
    rng = np.random.default_rng(42)
    feats = torch.from_numpy(np.repeat(
        rng.standard_normal((2, 1, cfg.max_length, cfg.num_mel_bins)), 4,
        axis=1).reshape(8, cfg.max_length, cfg.num_mel_bins).astype(
            np.float32))
    labels = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1])
    tx = optim.make_optimizer(3e-3, 20, 0.0, 0.0)
    opt = tx.init(params)

    def loss_fn(p):
        logits = ast_mod.forward(p, feats, cfg, attention_impl="kernel")
        return losses.stage1_loss(logits, labels), logits

    first = None
    for _ in range(10):
        (lv, _), grads = steps.value_and_grad(loss_fn, params)
        updates, opt = tx.update(grads, opt, params)
        params = optim.apply_updates(params, updates)
        first = float(lv) if first is None else first
    assert float(lv) < first, (first, float(lv))
