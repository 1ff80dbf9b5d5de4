"""BEATs's elementwise epilogues (`ops/epilogue.py`: post_residual_layer_norm,
relpos_gates): their plain versions bit for bit the composition of
`models/beats.py` (`_block`'s scaled residual add and `_layer_norm`,
`relpos_gates`), the no-grad forward bit for bit the composition's
logits, the rule that picks the epilogues and the calls it makes, the
wrappers' refusals, and the benchmark's two BEATs faults through them. The
tests marked `cuda` hold the kernels of `csrc/trunk_epilogue.cu` to the
plain versions on an NVIDIA GPU, with their launch counts, and skip
without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_beats_epilogue.py
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as nnf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.kinds import recordings_beats as RB  # noqa: E402
from portbench.reference import beats as ref_beats  # noqa: E402
from zenker_audio_detection_tpu_torch.models import ast as ast_mod  # noqa: E402
from zenker_audio_detection_tpu_torch.models import beats  # noqa: E402
from zenker_audio_detection_tpu_torch.ops import epilogue as epi  # noqa: E402

CPU = torch.device("cpu")
DTYPES = (torch.bfloat16, torch.float32)
EPS = 1e-5
ALPHAS = (24 ** 0.25, 1.0)  # DeepNorm's at 12 layers; without DeepNorm
COUNTED = (epi.post_residual_layer_norm, epi.relpos_gates)
# hidden 64, 2 heads of 32, 2 layers (tests/test_torch_beats.py's TINY)
TINY = dict(embed_dim=32, encoder_layers=2, encoder_embed_dim=64,
            encoder_ffn_embed_dim=128, encoder_attention_heads=2,
            conv_pos=16, conv_pos_groups=4, max_length=64)


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


def _norm_leaf(gen, width):
    return (_randn(gen, (width,), scale=0.1, shift=1.0),
            _randn(gen, (width,), scale=0.1))


def _gate_leaves(gen, head, heads):
    return (_randn(gen, (head, epi.GATE_OUT), scale=0.2),
            _randn(gen, (epi.GATE_OUT,), scale=0.5),
            _randn(gen, (heads,), scale=0.5, shift=1.0))


def parent_relpos_gates(q, lp, config):
    """`models/beats.py:relpos_gates` as the composition computes it."""
    B, S, H = q.shape
    NH = config.encoder_attention_heads
    z = torch.matmul(q.float().view(B, S, NH, H // NH), lp["grep"]["kernel"]
                     .float()) + lp["grep"]["bias"].float()
    ab = torch.sigmoid(z.view(B, S, NH, 2, 4).sum(-1))
    g = ab[..., 0] * (ab[..., 1] * lp["grep_a"].float() - 1.0) + 2.0
    return g.transpose(1, 2).contiguous()


def parent_block(x, lp, rel, config, impl):
    """`models/beats.py:_block` as the composition computes it."""
    eps, alpha = config.layer_norm_eps, config.deep_norm_alpha
    a = beats._attention(x, lp, rel, config, impl)
    x = ast_mod._layer_norm(torch.add(a, x, alpha=alpha), lp["ln1"]["scale"],
                            lp["ln1"]["bias"], eps)
    h = nnf.gelu(beats._linear(x, lp["fc1"]), approximate="none")
    return ast_mod._layer_norm(
        torch.add(beats._linear(h, lp["fc2"]), x, alpha=alpha),
        lp["ln2"]["scale"], lp["ln2"]["bias"], eps)


# ---------------------------------------------------------------- plain


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("rows", [1, 7, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_are_the_composition(dtype, rows, alpha):
    """Each plain version, and each wrapper on CPU tensors, is the
    composition bit for bit: `_block`'s `torch.add(p, x, alpha)` and
    `_layer_norm`, and `relpos_gates`' lines, at heads of 64 and 32."""
    gen = np.random.default_rng(rows)
    H = 768
    p, x = (_randn(gen, (rows, H), dtype) for _ in range(2))
    scale, shift = _norm_leaf(gen, H)
    want = ast_mod._layer_norm(torch.add(p, x, alpha=alpha), scale, shift,
                               EPS)
    for fn in (epi.post_residual_layer_norm_reference,
               epi.post_residual_layer_norm):
        got = fn(p, x, scale, shift, EPS, alpha)
        assert got.dtype == dtype and torch.equal(got, want)

    for heads in (12, 24):
        q = _randn(gen, (2, rows, H), dtype, 2.0)
        w, b, grep_a = _gate_leaves(gen, H // heads, heads)
        cfg = beats.BEATsConfig(encoder_attention_heads=heads)
        want = parent_relpos_gates(
            q, {"grep": {"kernel": w, "bias": b}, "grep_a": grep_a}, cfg)
        for fn in (epi.relpos_gates_reference, epi.relpos_gates):
            got = fn(q, w, b, grep_a, heads)
            assert got.shape == (2, heads, rows)
            assert torch.equal(got, want)


# ---------------------------------------------------------- the forward


def _tiny(seed=7, **over):
    config = {**harness.find("beats1024.recordings_gated").config, **TINY,
              **over}
    fields = {f.name for f in dataclasses.fields(beats.BEATsConfig)}
    cfg = beats.BEATsConfig(**{k: v for k, v in config.items()
                               if k in fields})
    return config, cfg, RB.weights(config, seed, "stage1", CPU)


def _feats(n=3, frames=64, seed=1):
    return torch.randn(n, frames, 128,
                       generator=torch.Generator().manual_seed(seed))


def _leaves(params, kind):
    if kind == "bf16":
        return beats.cast_params(params, torch.bfloat16, CPU)
    return params


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("leaves,dtype", [("f32", torch.float32),
                                          ("bf16", torch.bfloat16),
                                          ("f32", torch.bfloat16)])
def test_no_grad_forward_is_the_composition(leaves, dtype, impl,
                                            monkeypatch):
    """A no-grad forward on the CPU (the epilogues' plain versions) gives
    the logits and hidden states of the composition as `_block` and
    `relpos_gates` computed it before the epilogues, and of the
    grad-enabled route, bit for bit."""
    _, cfg, params = _tiny()
    params = _leaves(params, leaves)
    x = _feats()
    kw = dict(dtype=dtype, attention_impl=impl)
    grad_logits = beats.forward(params, x, cfg, **kw)
    with torch.no_grad():
        assert beats.fused_trunk()
        got = beats.encode(params, x, cfg, **kw)
        got_logits = beats.forward(params, x, cfg, **kw)
    with monkeypatch.context() as m:
        m.setattr(beats, "_block", parent_block)
        m.setattr(beats, "relpos_gates", parent_relpos_gates)
        with torch.no_grad():
            want = beats.encode(params, x, cfg, **kw)
            want_logits = beats.forward(params, x, cfg, **kw)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(got_logits, want_logits)
    assert torch.equal(grad_logits, want_logits)


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


@pytest.mark.parametrize("layers", [2, 12])
@pytest.mark.parametrize("mode,fused", [("inference_mode", True),
                                        ("no_grad", True), ("grad", False)])
def test_the_rule_and_its_calls(mode, fused, layers, calls):
    """`fused_trunk`: the epilogues where autograd records nothing, else
    the composition. A fused forward calls, per block, relpos_gates and
    post_residual_layer_norm twice (on the card 12 and 24 launches at 12
    layers, which the card test and chip_smoke.py count); the composition
    calls neither. On the CPU no kernel launches: the counters stay 0."""
    _, cfg, params = _tiny(encoder_layers=layers)
    ctx = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad,
           "grad": torch.enable_grad}[mode]
    before = [fn.launches for fn in COUNTED]
    with ctx():
        assert beats.fused_trunk() == fused
        beats.forward(params, _feats(2), cfg, dtype=torch.bfloat16)
    block = ["relpos_gates", "post_residual_layer_norm",
             "post_residual_layer_norm"]
    assert calls == (block * layers if fused else [])
    assert [fn.launches for fn in COUNTED] == before


def test_both_faults_change_the_fused_result(monkeypatch, calls):
    """The benchmark's faults reach the fused route: `gate_const`
    (`portbench/kinds/recordings_beats.py:_gate_const`, each layer's gates
    held at their mean) and `alpha1` (DeepNorm's alpha taken as 1) each
    move a no-grad forward's logits by far more than its distance from the
    reference, as they move the composition's."""
    config, cfg, params = _tiny()
    x = _feats()
    want, _ = ref_beats.forward(params, x, config)
    with torch.no_grad():
        sound = float((beats.forward(params, x, cfg) - want).abs().max())
        alpha1 = beats.forward(params, x, dataclasses.replace(
            cfg, deep_norm=False))
        monkeypatch.setattr(beats, "relpos_gates", beats.relpos_gates)
        monkeypatch.setattr(RB, "_GATES", {})
        RB._gate_const(None)
        held = beats.forward(params, x, cfg)
    assert calls.count("relpos_gates") == 3 * cfg.encoder_layers
    for faulty in (alpha1, held):
        assert float((faulty - want).abs().max()) > 100 * max(sound, 1e-8)


# ------------------------------------------------------------- refusals


def _refusal_cases():
    gen = np.random.default_rng(6)
    x = _randn(gen, (4, 64), torch.bfloat16)
    scale, shift = _norm_leaf(gen, 64)
    wide = _randn(gen, (4, 1032), torch.bfloat16)
    wide_norm = _norm_leaf(gen, 1032)
    flat = _randn(gen, (4 * 64 + 8,), torch.bfloat16)
    shifted = flat[1: 1 + 4 * 64].view(4, 64)  # contiguous, 2 bytes off
    odd = _randn(gen, (4, 12), torch.bfloat16)
    odd_norm = _norm_leaf(gen, 12)
    q = _randn(gen, (2, 5, 128), torch.bfloat16)
    w, b, grep_a = _gate_leaves(gen, 64, 2)
    q_flat = _randn(gen, (2 * 5 * 128 + 8,), torch.bfloat16)
    q_shifted = q_flat[1: 1 + 2 * 5 * 128].view(2, 5, 128)
    q_wide = _randn(gen, (2, 5, 17 * 64), torch.bfloat16)
    post = epi.post_residual_layer_norm
    gates = epi.relpos_gates
    return {
        "post f16": (TypeError, lambda: post(
            x.half(), x.half(), scale, shift, EPS, 1.5)),
        "post int": (TypeError, lambda: post(
            x.to(torch.int32), x.to(torch.int32), scale, shift, EPS, 1.5)),
        "post dtypes differ": (ValueError, lambda: post(
            x, x.float(), scale, shift, EPS, 1.5)),
        "post shapes differ": (ValueError, lambda: post(
            x, x[:2], scale, shift, EPS, 1.5)),
        "post bf16 scale": (ValueError, lambda: post(
            x, x, scale.bfloat16(), shift, EPS, 1.5)),
        "post scale shape": (ValueError, lambda: post(
            x, x, scale[:32], shift, EPS, 1.5)),
        "post non-contiguous": (ValueError, lambda: post(
            x, wide[:, :128:2], scale, shift, EPS, 1.5)),
        "post unaligned": (ValueError, lambda: post(
            shifted, x, scale, shift, EPS, 1.5)),
        "post width over 1024": (ValueError, lambda: post(
            wide, wide, *wide_norm, EPS, 1.5)),
        "post width of part of a vector": (ValueError, lambda: post(
            odd, odd, *odd_norm, EPS, 1.5)),
        "gates 2-D q": (ValueError, lambda: gates(q[0], w, b, grep_a, 2)),
        "gates f16 q": (TypeError, lambda: gates(q.half(), w, b, grep_a, 2)),
        "gates heads do not split": (ValueError, lambda: gates(
            q, w, b, grep_a, 3)),
        "gates w shape": (ValueError, lambda: gates(
            q, w[:, :4].contiguous(), b, grep_a, 2)),
        "gates bf16 w": (ValueError, lambda: gates(
            q, w.bfloat16(), b, grep_a, 2)),
        "gates b shape": (ValueError, lambda: gates(q, w, b[:4], grep_a, 2)),
        "gates grep_a shape": (ValueError, lambda: gates(
            q, w, b, grep_a[:1], 2)),
        "gates non-contiguous q": (ValueError, lambda: gates(
            q.transpose(0, 1), w, b, grep_a, 2)),
        "gates unaligned q": (ValueError, lambda: gates(
            q_shifted, w, b, grep_a, 2)),
        "gates width over 1024": (ValueError, lambda: gates(
            q_wide, w, b, torch.ones(17), 17)),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_refusals(case):
    """A wrong dtype or shape, a non-contiguous or unaligned tensor, a row
    of part of a 16-byte vector or wider than 1024 elements raises, on the
    CPU as on the card."""
    error, call = _refusal_cases()[case]
    with pytest.raises(error):
        call()


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    return torch.device("cuda")


def poisoned(gen, shape, dtype, device, pad=5):
    """Activations of `shape`, the first rows of a buffer whose last `pad`
    rows hold NaN: a kernel that reads past its rows shows there."""
    buf = _randn(gen, (shape[0] + pad, *shape[1:]), dtype).to(device)
    buf[shape[0]:] = float("nan")
    return buf[:shape[0]]


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("rows", [128 * 512, 8 * 146, 7])
@pytest.mark.parametrize("dtype", DTYPES)
def test_post_residual_layer_norm_on_the_card(cuda_device, dtype, rows,
                                              alpha):
    """The kernel's sum is `torch.add(p, x, alpha=alpha)`'s bit for bit:
    its h equals, bit for bit, the AST's layer_norm kernel (the same
    LayerNorm body) on torch.add's sum. Its h is within one bf16 ulp of
    the plain version (f32: EPILOGUE_F32_TOL), one launch counted."""
    import chip_smoke

    gen = np.random.default_rng(rows)
    dev, H = cuda_device, 768
    p, x = (poisoned(gen, (rows, H), dtype, dev) for _ in range(2))
    scale, shift = (t.to(dev) for t in _norm_leaf(gen, H))
    before = epi.post_residual_layer_norm.launches
    got = epi.post_residual_layer_norm(p, x, scale, shift, EPS, alpha)
    assert epi.post_residual_layer_norm.launches == before + 1
    _, same_body = epi.residual_layer_norm(torch.add(p, x, alpha=alpha),
                                           scale, shift, EPS)
    torch.cuda.synchronize()
    assert torch.equal(got, same_body)
    chip_smoke.require_epilogue(
        torch, "post_residual_layer_norm", got,
        epi.post_residual_layer_norm_reference(p, x, scale, shift, EPS,
                                               alpha), exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,heads", [(128, 512, 12), (3, 77, 12),
                                             (1, 5, 16), (2, 33, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_relpos_gates_on_the_card(cuda_device, dtype, batch, seq, heads):
    """The gates' kernel within GATE_TOL of max(|plain|, 1) of the plain
    version, on q the first rows of a NaN-tailed buffer, one launch
    counted."""
    gen = np.random.default_rng(batch * seq + heads)
    dev = cuda_device
    q = poisoned(gen, (batch, seq, heads * epi.GATE_HEAD), dtype, dev)
    w, b, grep_a = (t.to(dev) for t in _gate_leaves(gen, epi.GATE_HEAD,
                                                    heads))
    before = epi.relpos_gates.launches
    got = epi.relpos_gates(q, w, b, grep_a, heads)
    assert epi.relpos_gates.launches == before + 1
    want = epi.relpos_gates_reference(q, w, b, grep_a, heads)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert err <= epi.GATE_TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_beats_forward_counts_its_launches_on_the_card(cuda_device, dtype):
    """A no-grad forward of a 12-layer BEATs with heads of 64 on the card
    launches 24 post_residual_layer_norm and 12 relpos_gates kernels, and
    its hidden states are the grad-enabled composition's on the card
    (which launches none) within the noise of one-ulp LayerNorms."""
    _, cfg, params = _tiny(encoder_embed_dim=128, encoder_ffn_embed_dim=256,
                           encoder_layers=12)
    params = beats.cast_params(params, dtype, cuda_device)
    x = _feats().to(cuda_device)
    before = [fn.launches for fn in COUNTED]
    want = beats.encode(params, x, cfg, dtype=dtype)
    assert [fn.launches for fn in COUNTED] == before
    with torch.inference_mode():
        got = beats.encode(params, x, cfg, dtype=dtype)
    assert [a - b for a, b in zip((fn.launches for fn in COUNTED),
                                  before)] == [24, 12]
    tol = 2.0 ** -4 if dtype == torch.bfloat16 else 1e-4
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err
