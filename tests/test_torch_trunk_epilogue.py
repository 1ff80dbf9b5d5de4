"""The AST trunk's elementwise epilogues (`ops/epilogue.py`): their plain
versions bit for bit the composition of `models/ast.py` (`_dense`,
`_layer_norm`, the GELU line), the fused route of a no-grad forward bit for
bit the grad-enabled route, the rule that picks it, the calls it makes and
the wrappers' refusals. The tests marked `cuda` hold the kernels of
`csrc/trunk_epilogue.cu` to the plain versions on an NVIDIA GPU, with
their launch counts, and skip without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_trunk_epilogue.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as nnf

from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.ops import epilogue as epi

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, patch_size=8, frequency_stride=4,
            time_stride=4, num_mel_bins=16, max_length=64, num_labels=2)
EPS = 1e-12
DTYPES = (torch.bfloat16, torch.float32)
COUNTED = (epi.qkv_bias, epi.bias_gelu, epi.residual_layer_norm)


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs test files in parallel
    workers, which more threads would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(gen, shape, dtype=torch.float32, scale=1.0, shift=0.0):
    x = shift + scale * gen.standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _dense_leaf(gen, fan_in, width, dtype):
    return {"kernel": _randn(gen, (fan_in, width), dtype, 0.25),
            "bias": _randn(gen, (width,), dtype)}


def _norm_leaf(gen, width):
    return (_randn(gen, (width,), scale=0.1, shift=1.0),
            _randn(gen, (width,), scale=0.1))


# ---------------------------------------------------------------- plain


@pytest.mark.parametrize("width", [768, 3072])
@pytest.mark.parametrize("rows", [1, 7, 146, 1214])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_are_the_composition(dtype, rows, width):
    """Each plain version, and each wrapper on CPU tensors, is the
    composition bit for bit: `_dense`'s bias add after the rounded product,
    the residual add, `_layer_norm`, and `_block`'s GELU line."""
    gen = np.random.default_rng(rows * width)
    a = _randn(gen, (rows, 16), dtype)
    dense = {n: _dense_leaf(gen, 16, width, dtype) for n in "qkv"}
    products = {n: torch.matmul(a, dense[n]["kernel"]) for n in "qkv"}
    want = [ast_mod._dense(a, dense[n]) for n in "qkv"]
    biases = [dense[n]["bias"] for n in "qkv"]
    plain = epi.qkv_bias_reference(*products.values(), *biases)
    ins = [p.clone() for p in products.values()]
    got = epi.qkv_bias(*ins, *biases)
    for w, p, g, i in zip(want, plain, got, ins):
        assert torch.equal(p, w) and torch.equal(g, w) and g is i

    # the residual add of a dense output and the LayerNorm after it
    x = _randn(gen, (rows, width), dtype)
    out = dense["q"]
    scale, shift = _norm_leaf(gen, width)
    want_x = x + ast_mod._dense(a, out)
    want_h = ast_mod._layer_norm(want_x, scale, shift, EPS)
    for fn in (epi.residual_layer_norm_reference, epi.residual_layer_norm):
        got_x, got_h = fn(x, scale, shift, EPS, products["q"], out["bias"])
        assert torch.equal(got_x, want_x) and torch.equal(got_h, want_h)
        # without a product: the first block's ln1
        got_x, got_h = fn(x, scale, shift, EPS)
        assert got_x is x and torch.equal(
            got_h, ast_mod._layer_norm(x, scale, shift, EPS))

    # fc1's bias and GELU
    want = nnf.gelu(ast_mod._dense(a, out).float(),
                    approximate="none").to(dtype)
    assert torch.equal(epi.bias_gelu_reference(products["q"], out["bias"]),
                       want)
    p = products["q"].clone()
    got = epi.bias_gelu(p, out["bias"])
    assert got is p and torch.equal(got, want)


# ---------------------------------------------------------- the forward


def _random_params(seed, cfg):
    """`init_params`' tree with every leaf random, the LayerNorm scales
    about 1: zero biases or unit scales would hide a bias or scale left
    out."""
    gen = np.random.default_rng(seed)
    tree = ast_mod.init_params(gen, cfg)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k if k in ("scale", "bias") else name)
                    for k, v in node.items()}
        return _randn(gen, tuple(node.shape), scale=0.1,
                      shift=1.0 if name == "scale" else 0.0)

    return walk(tree)


def _features(seed, batch, cfg):
    gen = np.random.default_rng(seed)
    return _randn(gen, (batch, cfg.max_length, cfg.num_mel_bins))


def _leaves(params, kind):
    """The tree as a caller holds it: f32 leaves, the engine's bf16 leaves
    (`cast_params`) or int8 dense leaves (`quantize_params`)."""
    if kind == "bf16":
        return ast_mod.cast_params(params, torch.bfloat16, "cpu")
    if kind == "int8":
        return ast_mod.quantize_params(params)
    return params


def _counts():
    return [fn.launches for fn in COUNTED]


@pytest.fixture
def calls(monkeypatch):
    """The epilogue calls a forward makes, in order, by name: each wrapper
    stood in for by one that records its name and runs it."""
    made = []

    def recording(fn):
        def call(*args, **kwargs):
            made.append(fn.__name__)
            return fn(*args, **kwargs)
        return call

    for fn in COUNTED:
        monkeypatch.setattr(epi, fn.__name__, recording(fn))
    return made


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("leaves,dtype", [("f32", torch.float32),
                                          ("bf16", torch.bfloat16),
                                          ("f32", torch.bfloat16)])
def test_no_grad_forward_is_the_grad_route(leaves, dtype, impl):
    """The fused route of a no-grad forward (ops.epilogue's plain
    versions on the CPU) gives the grad-enabled route's logits and hidden
    states bit for bit: every rounding in the same place."""
    cfg = ast_mod.ASTConfig(**TINY)
    params = _leaves(_random_params(0, cfg), leaves)
    x = _features(1, 3, cfg)
    kw = dict(dtype=dtype, attention_impl=impl)
    want = ast_mod.encode(params, x, cfg, **kw)
    want_logits = ast_mod.forward(params, x, cfg, **kw)
    with torch.no_grad():
        assert ast_mod.fused_trunk(params)
        got = ast_mod.encode(params, x, cfg, **kw)
        got_logits = ast_mod.forward(params, x, cfg, **kw)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(got_logits, want_logits)


@pytest.mark.parametrize("layers", [2, 12])
@pytest.mark.parametrize("mode,leaves,fused", [
    ("inference_mode", "f32", True), ("inference_mode", "bf16", True),
    ("no_grad", "f32", True), ("no_grad", "bf16", True),
    ("grad", "f32", False), ("grad", "bf16", False),
    ("no_grad", "int8", False), ("inference_mode", "int8", False)])
def test_the_rule_and_its_launch_counts(mode, leaves, fused, layers, calls):
    """`fused_trunk`: the fused route where autograd records nothing and no
    dense leaf is int8, else the composition. A fused forward calls
    residual_layer_norm on the embeddings, then per block qkv_bias,
    residual_layer_norm, bias_gelu and residual_layer_norm (on the card
    12, 12 and 25 launches at 12 layers, which the card test and
    chip_smoke.py count); the composition calls none of them. On the CPU
    no kernel launches: the counters stay at 0."""
    cfg = ast_mod.ASTConfig(**{**TINY, "num_hidden_layers": layers})
    params = _leaves(_random_params(2, cfg), leaves)
    dtype = torch.float32 if leaves == "f32" else torch.bfloat16
    ctx = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad,
           "grad": torch.enable_grad}[mode]
    before = _counts()
    with ctx():
        assert ast_mod.fused_trunk(params) == fused
        ast_mod.forward(params, _features(3, 2, cfg), cfg, dtype=dtype)
    block = ["qkv_bias", "residual_layer_norm", "bias_gelu",
             "residual_layer_norm"]
    assert calls == (["residual_layer_norm"] + block * layers if fused
                     else [])
    assert _counts() == before


def test_grad_forward_keeps_the_composition_under_remat(calls):
    """Training's forward (remat, grad enabled) differentiates through
    `_block`: no epilogue is called and the gradient reaches every leaf."""
    cfg = ast_mod.ASTConfig(**TINY)
    params = _random_params(4, cfg)
    for leaf in (params["encoder"]["fc1"]["bias"],
                 params["encoder"]["ln2"]["scale"]):
        leaf.requires_grad_(True)
    logits = ast_mod.forward(params, _features(5, 2, cfg), cfg, remat=True)
    logits.sum().backward()
    assert calls == []
    assert params["encoder"]["fc1"]["bias"].grad.abs().sum() > 0
    assert params["encoder"]["ln2"]["scale"].grad.abs().sum() > 0


# ------------------------------------------------------------- refusals


def _refusal_cases():
    gen = np.random.default_rng(6)
    x = _randn(gen, (4, 32), torch.bfloat16)
    b = _randn(gen, (32,), torch.bfloat16)
    scale, shift = _norm_leaf(gen, 32)
    wide = _randn(gen, (4, 64), torch.bfloat16)
    return {
        "qkv_bias f16": (TypeError, lambda: epi.qkv_bias(
            x.half(), x.half(), x.half(), b.half(), b.half(), b.half())),
        "qkv_bias dtypes differ": (ValueError, lambda: epi.qkv_bias(
            x, x.float(), x, b, b, b)),
        "qkv_bias bias shape": (ValueError, lambda: epi.qkv_bias(
            x, x, x, b, b[:16], b)),
        "qkv_bias non-contiguous": (ValueError, lambda: epi.qkv_bias(
            x, wide[:, ::2], x, b, b, b)),
        "residual_layer_norm bf16 scale": (ValueError,
                                           lambda: epi.residual_layer_norm(
            x, scale.bfloat16(), shift, EPS, x, b)),
        "residual_layer_norm product shape": (ValueError,
                                              lambda: epi.residual_layer_norm(
            x, scale, shift, EPS, x[:2], b)),
        "residual_layer_norm p without b": (ValueError,
                                            lambda: epi.residual_layer_norm(
            x, scale, shift, EPS, x)),
        "residual_layer_norm non-contiguous": (ValueError,
                                               lambda: epi.residual_layer_norm(
            wide[:, ::2], scale, shift, EPS)),
        "bias_gelu bias dtype": (ValueError, lambda: epi.bias_gelu(
            x, b.float())),
        "bias_gelu non-contiguous": (ValueError, lambda: epi.bias_gelu(
            x.t(), _randn(gen, (4,), torch.bfloat16))),
        "bias_gelu int": (TypeError, lambda: epi.bias_gelu(
            x.to(torch.int32), b.to(torch.int32))),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_refusals(case):
    """A wrong dtype or shape, a non-contiguous tensor or a product without
    its bias raises."""
    error, call = _refusal_cases()[case]
    with pytest.raises(error):
        call()


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    return torch.device("cuda")


def require_close(what, got, want):
    """`chip_smoke.require_epilogue`: within one bf16 ulp of max(|want|,
    2^-8) of the plain version; in f32, where LayerNorm and GELU round
    nothing to bf16, within EPILOGUE_F32_TOL of max(|want|, 1)."""
    import chip_smoke

    chip_smoke.require_epilogue(torch, what, got, want, exact=False)


def poisoned(gen, rows, width, dtype, device, pad=5):
    """(rows, width) activations, the first rows of a buffer whose last
    `pad` rows hold NaN: a kernel that reads or writes past its rows shows
    there."""
    buf = _randn(gen, (rows + pad, width), dtype).to(device)
    buf[rows:] = float("nan")
    return buf, buf[:rows]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8 * 146, 128 * 1214, 7])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_against_plain_on_the_card(cuda_device, dtype, rows):
    """Each kernel against its plain version on the card: the bias and
    residual adds bit for bit, LayerNorm and GELU within one bf16 ulp (f32:
    1e-5), on the first rows of buffers whose tails hold NaN, which stay as
    they were."""
    gen = np.random.default_rng(rows)
    dev = cuda_device
    H, I = 768, 3072
    bufs, acts = zip(*(poisoned(gen, rows, H, dtype, dev) for _ in range(3)))
    biases = [_randn(gen, (H,), dtype).to(dev) for _ in range(3)]
    want = epi.qkv_bias_reference(*acts, *biases)
    got = epi.qkv_bias(*acts, *biases)
    torch.cuda.synchronize()
    for buf, g, w in zip(bufs, got, want):
        assert torch.equal(g, w) and bool(buf[rows:].isnan().all())

    scale, shift = (t.to(dev) for t in _norm_leaf(gen, H))
    _, x = poisoned(gen, rows, H, dtype, dev)
    _, p = poisoned(gen, rows, H, dtype, dev)
    want_x, want_h = epi.residual_layer_norm_reference(x, scale, shift, EPS,
                                                       p, biases[0])
    got_x, got_h = epi.residual_layer_norm(x, scale, shift, EPS, p, biases[0])
    assert torch.equal(got_x, want_x)
    require_close("residual_layer_norm", got_h, want_h)
    _, first = epi.residual_layer_norm(x, scale, shift, EPS)
    require_close("layer_norm", first,
                  epi.residual_layer_norm_reference(x, scale, shift, EPS)[1])

    buf, p = poisoned(gen, rows, I, dtype, dev)
    b = _randn(gen, (I,), dtype).to(dev)
    want = epi.bias_gelu_reference(p, b)
    got = epi.bias_gelu(p, b)
    torch.cuda.synchronize()
    require_close("bias_gelu", got, want)
    assert bool(buf[rows:].isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_forward_on_the_card(cuda_device, dtype):
    """A no-grad forward of a small model on the card (the fused route,
    its launches counted) against the grad-enabled composition on the
    card, which launches none."""
    cfg = ast_mod.ASTConfig(**{**TINY, "hidden_size": 64,
                               "intermediate_size": 128})
    params = ast_mod.cast_params(_random_params(7, cfg), dtype, cuda_device)
    x = _features(8, 3, cfg).to(cuda_device)
    before = _counts()
    want = ast_mod.encode(params, x, cfg, dtype=dtype, attention_impl="torch")
    assert _counts() == before
    with torch.inference_mode():
        got = ast_mod.encode(params, x, cfg, dtype=dtype,
                             attention_impl="torch")
    L = cfg.num_hidden_layers
    assert [a - b for a, b in zip(_counts(), before)] == [L, L, 2 * L + 1]
    # bf16: a LayerNorm or GELU output one ulp off moves the next layers'
    # by about as much; a bias left out moves them by 0.1 and more
    tol = 2.0 ** -4 if dtype == torch.bfloat16 else 1e-4
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err
