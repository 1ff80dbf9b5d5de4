"""Which attention the train step runs (`train.steps.train_attention_impl`).

The rule is a pure function of the device type, the compute dtype and the
config: "kernel" (`mha_packed_trainable`) for bf16 on a CUDA device at a
head width in `ops.attention.KERNEL_HEAD_DIMS`, "torch" otherwise, and a
route the caller names wins. On the CPU `make_train_step(attention_impl=
"kernel")` runs the kernels' plain versions and agrees with the "torch"
step at tests/test_torch_route_check.py's size in f32 within that file's
tolerances (loss 1e-5, gradients' relative norm 1e-4). The fold- and
trial-parallel steps and `parallel.checks.train_step` keep "torch"."""

import inspect
import math

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.ops import attention as attn_ops
from zenker_audio_detection_tpu_torch.parallel import checks
from zenker_audio_detection_tpu_torch.train import fold_parallel as FP
from zenker_audio_detection_tpu_torch.train import losses, optim, steps

# tests/test_torch_route_check.py's size
CFG = ast_mod.ASTConfig(hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_length=128)
LOSS_TOL, GRAD_REL_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def heads_of(d: int, heads: int = 12) -> ast_mod.ASTConfig:
    return ast_mod.ASTConfig(hidden_size=d * heads, num_attention_heads=heads)


# the drift bench's model (analysis/drift_bench.py:build_pretrained): head
# width 8, which the kernels refuse; it trains in f32
DRIFT = ast_mod.ASTConfig(hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64)


@pytest.mark.parametrize("device, dtype, cfg, named, want", [
    ("cpu", torch.bfloat16, heads_of(64), None, "torch"),
    ("cuda", torch.bfloat16, heads_of(64), None, "kernel"),
    ("cuda", torch.bfloat16, heads_of(32), None, "kernel"),
    ("cuda", torch.float32, heads_of(64), None, "torch"),
    ("cuda", torch.bfloat16, heads_of(8), None, "torch"),
    ("cuda", torch.float16, heads_of(64), None, "torch"),
    ("cuda", torch.bfloat16, ast_mod.ASTConfig(), None, "kernel"),
    ("cuda", torch.float32, DRIFT, None, "torch"),
    ("cuda", torch.bfloat16, DRIFT, None, "torch"),
    ("cuda", torch.bfloat16, heads_of(64), "torch", "torch"),
    ("cpu", torch.float32, heads_of(8), "kernel", "kernel"),
], ids=["cpu-bf16-d64", "cuda-bf16-d64", "cuda-bf16-d32", "cuda-f32-d64",
        "cuda-bf16-d8", "cuda-f16-d64", "cuda-bf16-ast", "drift-f32",
        "drift-bf16", "named-torch-wins", "named-kernel-wins"])
def test_route_rule(device, dtype, cfg, named, want):
    assert steps.train_attention_impl(device, dtype, cfg, named) == want


def test_rule_reads_the_kernels_head_widths():
    """The rule takes exactly the widths the kernels are built for."""
    for d in range(1, 129):
        got = steps.train_attention_impl("cuda", torch.bfloat16, heads_of(d))
        assert (got == "kernel") == (d in attn_ops.KERNEL_HEAD_DIMS), d


def _inputs(seed: int = 7, batch: int = 4):
    params = ast_mod.init_params(np.random.default_rng(seed), CFG)
    rng = np.random.default_rng(seed + 1)
    feats = torch.from_numpy(rng.standard_normal(
        (batch, CFG.max_length, CFG.num_mel_bins)).astype(np.float32))
    labels = torch.from_numpy(rng.permutation(np.arange(batch) % 2))
    return params, feats, labels


def _loss(logits, y):
    return losses.stage1_loss(logits, y, 2.0, 0.07)


def _rel(a, b) -> float:
    num = sum(float((x - y).square().sum())
              for (_, x), (_, y) in zip(optim.tree_items(a),
                                        optim.tree_items(b)))
    den = sum(float(y.square().sum()) for _, y in optim.tree_items(b))
    return math.sqrt(num / den)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of the kernels' plain versions (the CPU form of
    mha_packed_lse and of the two backward kernels)."""
    seen = {"lse": 0, "bwd": 0}

    def counted(key, fn):
        def run(*args, **kw):
            seen[key] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(attn_ops, "mha_packed_lse_reference",
                        counted("lse", attn_ops.mha_packed_lse_reference))
    monkeypatch.setattr(attn_ops, "mha_packed_bwd_reference",
                        counted("bwd", attn_ops.mha_packed_bwd_reference))
    return seen


@pytest.mark.parametrize("make", ["train_step", "accum_steps"])
def test_kernel_route_on_cpu_matches_torch(make, plain_calls):
    """A step named "kernel" runs the plain versions of the kernels (per
    step under remat "full": two lse forwards and one backward a layer)
    and reads the "torch" step's loss, logits and gradients."""
    params, feats, labels = _inputs()
    tx = optim.make_optimizer(1e-5, 5, 0.1, 0.01)
    kw = dict(dtype=torch.float32, remat=True)
    out = {}
    for impl in ("kernel", "torch"):
        before = dict(plain_calls)
        if make == "train_step":
            step = steps.make_train_step(tx, CFG, _loss, attention_impl=impl,
                                         **kw)
            _, _, lv, logits = step(params, tx.init(params), feats, labels)
        else:
            grad_step, _ = steps.make_accum_steps(tx, CFG, _loss,
                                                  attention_impl=impl, **kw)
            zero = optim.tree_map(torch.zeros_like, params)
            _, lv, logits = grad_step(params, zero, feats, labels)
        calls = {k: plain_calls[k] - before[k] for k in plain_calls}
        layers = CFG.num_hidden_layers
        assert calls == ({"lse": 2 * layers, "bwd": layers}
                         if impl == "kernel" else {"lse": 0, "bwd": 0})
        vg = steps.make_value_and_grad(CFG, _loss, attention_impl=impl, **kw)
        (_, _), grads = vg(params, feats, labels)
        out[impl] = (float(lv), logits, grads)
    (lk, logits_k, gk), (lt, logits_t, gt) = out["kernel"], out["torch"]
    assert abs(lk - lt) <= LOSS_TOL
    assert float((logits_k - logits_t).abs().max()) <= LOSS_TOL
    assert _rel(gk, gt) <= GRAD_REL_TOL


def test_unnamed_route_on_cpu_is_torch(plain_calls):
    """With no route named, a CPU step runs "torch" in bf16 at a head
    width the kernels take, and in f32: no plain kernel version runs, and
    the step equals the one named "torch" bit for bit."""
    cfg = ast_mod.ASTConfig(hidden_size=64, num_hidden_layers=1,
                            num_attention_heads=2, intermediate_size=128,
                            max_length=128)
    params = ast_mod.init_params(np.random.default_rng(3), cfg)
    _, feats, labels = _inputs(3, 2)
    tx = optim.make_optimizer(1e-5, 5, 0.1, 0.01)
    for dtype in (torch.bfloat16, torch.float32):
        got = {}
        for impl in (None, "torch"):
            step = steps.make_train_step(tx, cfg, _loss, dtype=dtype,
                                         attention_impl=impl)
            new, _, lv, _ = step(params, tx.init(params), feats, labels)
            got[impl] = (float(lv), new)
        assert got[None][0] == got["torch"][0]
        for (_, a), (_, b) in zip(optim.tree_items(got[None][1]),
                                  optim.tree_items(got["torch"][1])):
            assert torch.equal(a, b)
    assert plain_calls == {"lse": 0, "bwd": 0}


def test_fold_and_trial_parallel_keep_torch(monkeypatch):
    """The vmapped forward of the fold- and trial-parallel steps names
    "torch" for every block (the trainable kernel has no vmap rule)."""
    seen = []
    block = ast_mod._block

    def recording(x, lp, config, impl):
        seen.append(impl)
        return block(x, lp, config, impl)

    monkeypatch.setattr(ast_mod, "_block", recording)
    cfg = ast_mod.ASTConfig(hidden_size=64, num_hidden_layers=1,
                            num_attention_heads=1, intermediate_size=128,
                            max_length=128)
    tree = ast_mod.init_params(np.random.default_rng(5), cfg)
    stacked = optim.tree_map(lambda t: torch.stack([t, t]), tree)
    feats = torch.zeros(2, 1, cfg.max_length, cfg.num_mel_bins)
    FP.stacked_forward(stacked, feats, cfg, dtype=torch.bfloat16)
    assert seen and set(seen) == {"torch"}


def test_parallel_checks_name_torch():
    """parallel.checks.train_step passes its route on, "torch" unless
    named."""
    sig = inspect.signature(checks.train_step)
    assert sig.parameters["attention_impl"].default == "torch"
