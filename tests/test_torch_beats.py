"""The port's BEATs stage (`models/beats.py`, `ops/attention.py:
mha_packed_relpos`, the povey front end) on the CPU: against the
benchmark's plain float32 reference (`portbench/reference/beats.py`) at a
small size, the bias's plain version against a softmax written out, the
bucket rule against `transformers`' WavLM, the gate's input, the two
faults' mathematics, the engine's BEATs cascade, the entries that refuse
BEATs, the checkpoint loader, and the AST front end kept bit for bit."""

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.kinds import recordings_beats as RB  # noqa: E402
from portbench.reference import beats as ref_beats  # noqa: E402
from portbench.reference import cascade as ref_cascade  # noqa: E402
from zenker_audio_detection_tpu_torch import models  # noqa: E402
from zenker_audio_detection_tpu_torch.infer import cascade as C  # noqa: E402
from zenker_audio_detection_tpu_torch.models import ast as ast_mod  # noqa: E402
from zenker_audio_detection_tpu_torch.models import beats  # noqa: E402
from zenker_audio_detection_tpu_torch.models import convert  # noqa: E402
from zenker_audio_detection_tpu_torch.ops import attention as A  # noqa: E402
from zenker_audio_detection_tpu_torch.ops import fbank as F  # noqa: E402
from zenker_audio_detection_tpu_torch.train import losses, optim, steps  # noqa: E402

CPU = torch.device("cpu")
# hidden 64, 2 heads of 32, 2 layers, FFN 128, embed 32, position
# convolution 16 wide in 4 groups, 64 frames: S = 4 x 8 = 32 tokens; the
# buckets stay 320 / 800
TINY = dict(embed_dim=32, encoder_layers=2, encoder_embed_dim=64,
            encoder_ffn_embed_dim=128, encoder_attention_heads=2,
            conv_pos=16, conv_pos_groups=4, max_length=64)
# port against reference in f32: the same operations, summed in other
# orders (the gates' product on (B, S, NH, D) against (B, NH, S, D), the
# predictor on the mean against the mean of the predictor's outputs);
# read 9.3e-9 on logits of 0.07 and 1.2e-7 on pooled tokens of 1
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs test files in parallel
    workers, which more threads would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_dict(**over):
    return {**harness.find("beats1024.recordings_gated").config, **TINY,
            **over}


def port_config(config: dict) -> beats.BEATsConfig:
    fields = {f.name for f in dataclasses.fields(beats.BEATsConfig)}
    return beats.BEATsConfig(**{k: v for k, v in config.items()
                                if k in fields})


def tiny(seed=7, **over):
    config = tiny_dict(**over)
    return config, port_config(config), RB.weights(config, seed, "stage1",
                                                   CPU)


def feats(n=3, frames=64, seed=1):
    return torch.randn(n, frames, 128,
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_forward_matches_the_reference(impl):
    config, cfg, params = tiny()
    x = feats()
    want, pooled = ref_beats.forward(params, x, config)
    got = beats.forward(params, x, cfg, attention_impl=impl)
    torch.testing.assert_close(got, want, **LOGIT_TOL)
    torch.testing.assert_close(beats.pool(beats.encode(params, x, cfg)),
                               pooled, rtol=1e-5, atol=1e-5)


def test_the_published_sizes_give_512_tokens_and_alpha():
    cfg = port_config(harness.find("beats1024.recordings_gated").config)
    assert cfg.seq_length == 512 and cfg.head_dim == 64
    assert cfg.deep_norm_alpha == pytest.approx(24 ** 0.25)
    assert dataclasses.replace(cfg, deep_norm=False).deep_norm_alpha == 1.0
    assert models.module_for(cfg) is beats
    assert models.module_for(ast_mod.ASTConfig()) is ast_mod
    with pytest.raises(TypeError, match="ASTConfig or a BEATsConfig"):
        models.module_for(object())


@pytest.mark.parametrize("over", [dict(layer_norm_first=True),
                                  dict(gru_rel_pos=False),
                                  dict(relative_position_embedding=False),
                                  dict(conv_bias=True), dict(max_length=100)])
def test_other_forms_of_the_published_code_are_refused(over):
    with pytest.raises(ValueError):
        beats.BEATsConfig(**over)


def _softmax_written_out(q, k, v, gate, rel, nh):
    """Each head's scores with the bias built element by element."""
    B, S, H = q.shape
    D = H // nh
    out = torch.empty(B, S, H, dtype=torch.float32)
    for b in range(B):
        for h in range(nh):
            lanes = slice(h * D, (h + 1) * D)
            qh, kh, vh = (x[b, :, lanes].float() for x in (q, k, v))
            bias = torch.empty(S, S)
            for i in range(S):
                for j in range(S):
                    bias[i, j] = gate[b, h, i] * rel[h, j - i + S - 1]
            p = torch.softmax(qh @ kh.T / math.sqrt(D) + bias, -1)
            out[b, :, lanes] = p.to(q.dtype).float() @ vh
    return out.to(q.dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 0.0)])
def test_relpos_reference_is_a_softmax_with_the_bias_written_out(dtype, tol):
    """f32: the same sums in another order; bf16: p rounded, then products
    of bf16 values exact in f32 and the output rounded, in both."""
    g = torch.Generator().manual_seed(3)
    B, S, NH, D = 2, 9, 3, 4
    q, k, v = (torch.randn(B, S, NH * D, generator=g).to(dtype)
               for _ in range(3))
    gate = 1 + torch.rand(B, NH, S, generator=g)
    rel = torch.randn(NH, 2 * S - 1, generator=g)
    want = _softmax_written_out(q, k, v, gate, rel, NH)
    got = A.mha_packed_relpos_reference(q, k, v, gate, rel, NH)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol if dtype == torch.float32 else 8e-3)
    # the CPU entry point is the plain version
    torch.testing.assert_close(
        A.mha_packed_relpos(q, k, v, gate, rel, num_heads=NH), got,
        rtol=0, atol=0)
    # a zero gate is mha_packed's function
    torch.testing.assert_close(
        A.mha_packed_relpos_reference(q, k, v, torch.zeros_like(gate), rel,
                                      NH).float(),
        A.mha_packed_reference(q, k, v, NH).float(), rtol=0, atol=1e-6)


def test_relpos_entry_checks_its_operands():
    q = torch.zeros(2, 5, 8)
    good = (torch.zeros(2, 2, 5), torch.zeros(2, 9))
    for gate, rel in ((torch.zeros(2, 2, 4), good[1]),
                      (good[0], torch.zeros(2, 10)),
                      (good[0].double(), good[1])):
        with pytest.raises(ValueError, match="mha_packed_relpos"):
            A.mha_packed_relpos(q, q, q, gate, rel, num_heads=2)
    geo = A.launch_geometry("mha_packed_relpos", 128, 512, 12, 64, 2)
    assert geo == A.launch_geometry("mha_packed", 128, 512, 12, 64, 2)
    with pytest.raises(ValueError, match="bf16 only"):
        A.launch_geometry("mha_packed_relpos", 128, 512, 12, 64, 4)
    assert A.mha_packed_relpos.launches == 0  # the CPU runs no kernel


@pytest.mark.parametrize("S", [1, 2, 32, 146, 511, 512])
def test_the_bucket_vector_matches_wavlms_bucket_rule(S):
    """`transformers`' WavLM computes the same T5 bucket (its own code):
    the port's vector r[h, j - i + S - 1] is its bias P[bucket(j - i), h]."""
    from transformers.models.wavlm.modeling_wavlm import WavLMAttention

    attn = WavLMAttention(8, 2, num_buckets=320, max_distance=800)
    table = torch.randn(320, 2, generator=torch.Generator().manual_seed(S))
    with torch.no_grad():
        attn.rel_attn_embed.weight.copy_(table)
        want = attn.compute_bias(S, S)
    cfg = beats.BEATsConfig()
    rel = beats.relpos_vector({"rel_bias": table}, cfg, S)
    pos = torch.arange(S)
    assert torch.equal(rel[:, pos[None, :] - pos[:, None] + S - 1], want)
    d = pos[None, :] - pos[:, None]
    assert torch.equal(beats.relative_position_bucket(d, 320, 800),
                       attn._relative_positions_bucket(d))


def test_the_gate_reads_the_projected_q_not_the_layer_input(monkeypatch):
    """Each layer's gates come from its q projection (bias included): the
    first layer's gate input is the projection of the embedded tokens, and
    a q bias alone moves the gates."""
    config, cfg, params = tiny()
    x = feats(2)
    seen = []
    gates = beats.relpos_gates

    def record(q, lp, c):
        seen.append(q.clone())
        return gates(q, lp, c)

    monkeypatch.setattr(beats, "relpos_gates", record)
    beats.forward(params, x, cfg)
    h = beats.embed(params, x, cfg)
    lp0 = {n: ({k: v[0] for k, v in g.items()} if isinstance(g, dict)
               else g[0]) for n, g in params["encoder"].items()}
    torch.testing.assert_close(seen[0], beats._linear(h, lp0["q"]), rtol=0, atol=0)
    assert len(seen) == cfg.encoder_layers
    assert not torch.allclose(gates(h, lp0, cfg), gates(seen[0], lp0, cfg))
    shifted = dict(lp0, q={"kernel": lp0["q"]["kernel"],
                           "bias": lp0["q"]["bias"] + 0.5})
    assert not torch.allclose(gates(beats._linear(h, shifted["q"]), lp0, cfg),
                              gates(seen[0], lp0, cfg))


def test_both_faults_change_the_result(monkeypatch):
    """The check's faults move the logits at the test size by far more than
    the port's distance from the reference: `alpha1` (no DeepNorm) and
    `gate_const` (each layer's gates at their mean)."""
    config, cfg, params = tiny()
    x = feats()
    want, _ = ref_beats.forward(params, x, config)
    sound = float((beats.forward(params, x, cfg) - want).abs().max())
    alpha1 = beats.forward(params, x, dataclasses.replace(cfg,
                                                          deep_norm=False))
    want1, _ = ref_beats.forward(params, x, dict(config, deep_norm=False))
    torch.testing.assert_close(alpha1, want1, **LOGIT_TOL)
    gates = beats.relpos_gates
    monkeypatch.setattr(beats, "relpos_gates", lambda q, lp, c: (
        lambda g: g.mean().expand_as(g).contiguous())(gates(q, lp, c)))
    held = beats.forward(params, x, cfg)
    for faulty in (alpha1, held):
        assert float((faulty - want).abs().max()) > 100 * max(sound, 1e-8)


def _audios():
    rng = np.random.default_rng(5)
    return [(3000 * rng.standard_normal(int(s * 16000))).astype(np.int16)
            for s in (3.0, 4.5)]


def _engine_specs():
    """Two tiny BEATs stages whose heads the benchmark's rule calibrates on
    the reference over the first recording: stage 1 passes about 0.4 of
    its windows."""
    config = tiny_dict(max_length=128)
    cfg = port_config(config)
    audio = _audios()[0]
    f = ref_beats.window_features(
        audio, ref_cascade.window_starts(len(audio), 16000, 8000), 16000,
        128, 15.41663, 6.55582, CPU)
    specs = []
    for seed, labels in ((1, ("Idle", "Swallow")), (2, ("Healthy",
                                                        "Zenker"))):
        params = RB.weights(config, seed, f"stage{seed}", CPU)
        pooled = ref_beats.forward(params, f, config)[1]
        params["head"]["dense"] = RB.calibrate_head(pooled, 0.4, 0.1, 2.0)
        specs.append(C.StageSpec(params, cfg, 15.41663, 6.55582, labels))
    return config, specs


def test_the_engine_runs_a_beats_cascade_as_the_reference_does():
    """`run_patient` with two BEATs stages on the CPU (f32, kernel route):
    every window's probabilities against the reference's (the povey front
    end on each window's own samples, the reference forward, the softmax),
    and the summaries against the reference's summary of them."""
    config, specs = _engine_specs()
    engine = C.TwoStageEngine(*specs, C.CascadeConfig(
        batch_size=8, dtype=torch.float32), device="cpu")
    assert engine.front_end == beats.FRONT_END
    audios = _audios()
    p1s = [engine.window_probs(a)[0] for a in audios]
    out = engine.run_patient(["a.wav", "b.wav"], audios)
    files = []
    for j, (audio, p1) in enumerate(zip(audios, p1s)):
        starts = ref_cascade.window_starts(len(audio), 16000, 8000)
        f = ref_beats.window_features(audio, starts, 16000, 128, 15.41663,
                                      6.55582, CPU)
        want1 = torch.softmax(ref_beats.forward(specs[0].params, f,
                                                config)[0], -1).double()
        np.testing.assert_allclose(p1, want1.numpy(), rtol=0, atol=2e-5)
        want2 = torch.softmax(ref_beats.forward(specs[1].params, f,
                                                config)[0], -1).double()
        p2 = np.zeros_like(p1)
        gated = ref_cascade.gate(p1, 0.5)
        p2[gated] = want2.numpy()[gated]
        files.append(ref_cascade.file_summary(p1, p2, 0.5, 0.5))
        assert ref_cascade.mismatches(out["per_file"][f"file_{j}"],
                                      files[-1], rel=1e-6) == []
    assert ref_cascade.mismatches(out["aggregate"],
                                  ref_cascade.patient_totals(files),
                                  rel=1e-6) == []
    assert 0 < sum(f["stage2_swallow_windows_evaluated"] for f in files) \
        < sum(f["num_windows"] for f in files)


def test_streaming_runs_beats_stages_as_the_offline_engine():
    from zenker_audio_detection_tpu_torch.infer.streaming import \
        StreamingCascade

    _, specs = _engine_specs()
    engine = C.TwoStageEngine(*specs, C.CascadeConfig(
        batch_size=8, dtype=torch.float32), device="cpu")
    audio = (3000 * np.random.default_rng(6).standard_normal(48000)) \
        .astype(np.int16)
    stream = StreamingCascade(engine, chunk_windows=4, capacity_frames=512)
    for i in range(0, len(audio), 7000):
        stream.feed(audio[i: i + 7000])
    stream.flush()
    p1, p2 = engine.window_probs(audio)
    np.testing.assert_allclose(stream.stage1_probs(), p1, rtol=0, atol=1e-5)
    np.testing.assert_allclose(stream.stage2_probs(), p2, rtol=0, atol=1e-5)


def test_int8_mixed_front_ends_the_cache_and_training_refuse_beats(tmp_path):
    _, specs = _engine_specs()
    with pytest.raises(ValueError, match="int8 takes AST stages only"):
        C.TwoStageEngine(*specs, C.CascadeConfig(int8=True), device="cpu")
    with pytest.raises(ValueError, match="raw-frame cache"):
        C.TwoStageEngine(*specs, C.CascadeConfig(cache_dir=str(tmp_path)),
                         device="cpu")
    ast_cfg = ast_mod.ASTConfig(hidden_size=32, num_hidden_layers=1,
                                num_attention_heads=4, intermediate_size=64,
                                max_length=128)
    ast_spec = C.StageSpec(ast_mod.init_params(np.random.default_rng(0),
                                               ast_cfg), ast_cfg, -4.0, 4.0,
                           ("Idle", "Swallow"))
    for pair in ((ast_spec, specs[1]), (specs[0], ast_spec)):
        with pytest.raises(ValueError, match="one front end"):
            C.TwoStageEngine(*pair, device="cpu")
    cfg = specs[0].config
    tx = optim.make_optimizer(1e-4, 10, 0.1, 0.01)
    loss = losses.torch_smoothed_ce
    for make in (lambda: steps.make_train_step(tx, cfg, loss),
                 lambda: steps.make_value_and_grad(cfg, loss),
                 lambda: steps.make_loss_fn(cfg, loss),
                 lambda: steps.make_eval_step(cfg)):
        with pytest.raises(TypeError, match="training takes an ASTConfig"):
            make()


def _old_ast_logmel(waveform, n_frames):
    """`ops/fbank.py:logmel_frames` as it was before front ends were named
    (the matmul DFT): the AST path must stay this, bit for bit."""
    window, mel, cos_m, sin_m = (torch.from_numpy(a) for a in (
        F.hann_window_symmetric().astype(np.float32),
        F.mel_filter_bank_kaldi().astype(np.float32), *F._dft_matrices()))
    if waveform.dtype == torch.int16:
        waveform = waveform.float() * (1.0 / 32768.0)
    frames = F._preprocess_frames(F._frames_by_hop_slices(waveform,
                                                          n_frames), window)
    re_, im = frames @ cos_m, frames @ sin_m
    return torch.log(torch.clamp_min((re_ * re_ + im * im) @ mel,
                                     F.MEL_FLOOR))


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_the_ast_front_end_is_bitwise_unchanged(dtype):
    rng = np.random.default_rng(9)
    x = rng.standard_normal(24000) * (3000 if dtype == np.int16 else 0.1)
    x = torch.from_numpy(x.astype(dtype))
    n = F.num_frames(len(x))
    want = _old_ast_logmel(x, n)
    assert torch.equal(F.logmel_frames(x, n), want)
    assert torch.equal(F.logmel_frames(x, n, front_end=ast_mod.FRONT_END),
                       want)


def test_the_beats_front_end_matches_the_reference_povey_fbank():
    """The port's matmul DFT against the reference's rfft on the same int16
    windows: f32 sums in other orders, magnified by the log near the floor
    (the AST front end's test holds the same 1e-3)."""
    mix = harness.find("beats1024.recordings_gated").mix
    pcm = (3000 * np.random.default_rng(4).standard_normal(40000)) \
        .astype(np.int16)
    starts = np.array([0, 8000, 16000])
    want = ref_beats.window_features(pcm, starts, 16000, 128,
                                     mix["feature_mean"], mix["feature_std"],
                                     CPU)
    wav = torch.as_tensor(pcm[starts[:, None] + np.arange(16000)])
    raw = F.logmel_frames(wav, F.num_frames(16000),
                          front_end=beats.FRONT_END)
    got = (torch.nn.functional.pad(raw, (0, 0, 0, 128 - raw.shape[-2]))
           - mix["feature_mean"]) / (2 * mix["feature_std"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    # float audio in [-1, 1] gives the int16 PCM's frames
    torch.testing.assert_close(
        F.logmel_frames(wav.float() / 32768.0, F.num_frames(16000),
                        front_end=beats.FRONT_END), raw, rtol=0, atol=1e-4)
    np.testing.assert_allclose(F.frame_window("povey"),
                               F.hann_window_symmetric() ** 0.85)
    with pytest.raises(ValueError, match="window_type"):
        F.frame_window("hamming")


def test_fold_weight_norm_is_torchs_weight_norm():
    conv = torch.nn.Conv1d(8, 8, 6, padding=3, groups=2)
    torch.nn.init.normal_(conv.weight)
    wn = torch.nn.utils.weight_norm(conv, name="weight", dim=2)
    with torch.no_grad():
        wn.weight_g.mul_(1.7)
        wn(torch.zeros(1, 8, 10))  # recomputes weight from g and v
    np.testing.assert_allclose(
        convert.fold_weight_norm(wn.weight_g, wn.weight_v),
        wn.weight.detach().numpy(), rtol=1e-6, atol=1e-7)


def _published_state_dict(params, cfg):
    """The port's params under the public BEATs.py names, the position
    kernel split into a weight norm's g and v."""
    sd = {"patch_embedding.weight": params["patch_embed"]["kernel"],
          "layer_norm.weight": params["ln_patch"]["scale"],
          "layer_norm.bias": params["ln_patch"]["bias"],
          "post_extract_proj.weight": params["proj"]["kernel"].T,
          "post_extract_proj.bias": params["proj"]["bias"],
          "encoder.layer_norm.weight": params["ln_pos"]["scale"],
          "encoder.layer_norm.bias": params["ln_pos"]["bias"],
          "encoder.pos_conv.0.bias": params["pos_conv"]["bias"],
          "predictor.weight": params["head"]["dense"]["kernel"].T,
          "predictor.bias": params["head"]["dense"]["bias"]}
    w = params["pos_conv"]["kernel"]
    v = w * 3.0
    sd["encoder.pos_conv.0.weight_v"] = v
    sd["encoder.pos_conv.0.weight_g"] = w.pow(2).sum((0, 1), keepdim=True) \
        .sqrt()
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "attn_out": "self_attn.out_proj",
             "grep": "self_attn.grep_linear", "fc1": "fc1", "fc2": "fc2"}
    enc = params["encoder"]
    for i in range(cfg.encoder_layers):
        pre = f"encoder.layers.{i}."
        for ours, theirs in names.items():
            sd[pre + theirs + ".weight"] = enc[ours]["kernel"][i].T
            sd[pre + theirs + ".bias"] = enc[ours]["bias"][i]
        for ours, theirs in (("ln1", "self_attn_layer_norm"),
                             ("ln2", "final_layer_norm")):
            sd[pre + theirs + ".weight"] = enc[ours]["scale"][i]
            sd[pre + theirs + ".bias"] = enc[ours]["bias"][i]
        sd[pre + "self_attn.grep_a"] = enc["grep_a"][i].view(1, -1, 1, 1)
        # every layer's view of layer 0's shared table
        sd[pre + "self_attn.relative_attention_bias.weight"] = \
            params["rel_bias"]
    return sd


def test_the_published_state_dict_loads_into_the_ports_params():
    config, cfg, params = tiny()
    loaded = convert.beats_params_from_state_dict(
        _published_state_dict(params, cfg), cfg)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, v

    want, got = dict(flat(params)), dict(flat(loaded))
    assert sorted(got) == sorted(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-6,
                                   atol=1e-7, msg=key)
    x = feats()
    torch.testing.assert_close(beats.forward(loaded, x, cfg),
                               beats.forward(params, x, cfg), **LOGIT_TOL)
    sd = _published_state_dict(params, cfg)
    del sd["encoder.layers.1.fc2.bias"]
    with pytest.raises(KeyError):
        convert.beats_params_from_state_dict(sd, cfg)


def test_cast_params_keeps_the_bias_table_gates_norms_and_head_f32():
    _, cfg, params = tiny()
    cast = beats.cast_params(params, torch.bfloat16, CPU)
    assert cast["encoder"]["q"]["kernel"].dtype == torch.bfloat16
    assert cast["pos_conv"]["kernel"].dtype == torch.bfloat16
    for leaf in (cast["rel_bias"], cast["encoder"]["grep"]["kernel"],
                 cast["encoder"]["grep_a"], cast["encoder"]["ln1"]["scale"],
                 cast["ln_patch"]["scale"], cast["head"]["dense"]["kernel"]):
        assert leaf.dtype == torch.float32
    logits = beats.forward(cast, feats(), cfg, dtype=torch.bfloat16)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
