"""chip_smoke.py's stage-1 gate calibration (phases 4, 8 and 11) on a
small TwoStageEngine on the CPU: the calibrated head gates about a third
of the windows of the smoke run's seeded audio (GATE_RATE, within 0.05)
and leaves at most GATE_NEAR_MAX of them within ENGINE_TOL of the gate's
boundaries, so that comparing two engines' gates compares nearly every
decision. The bias shift of bench.py alone leaves (nearly) every window in
that band at random weights; that is checked too."""

import numpy as np
import pytest
import torch

import chip_smoke
from zenker_audio_detection_tpu_torch.infer import cascade as C
from zenker_audio_detection_tpu_torch.models import ast as ast_mod

SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_length=128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def calibrated():
    cfg = ast_mod.ASTConfig(**SMALL)
    audio = chip_smoke.seeded_audio(60.0, seed=3)
    kw = dict(batch_size=32, dtype=torch.float32, attention_impl="kernel")
    s1, s2 = chip_smoke.full_size_specs(C, ast_mod, cfg=cfg)
    engine_all = C.TwoStageEngine(s1, s2, C.CascadeConfig(
        stage2_mode="all", **kw), device="cpu")
    gate = chip_smoke.calibrate_gate(ast_mod, engine_all, audio)
    g1, g2 = chip_smoke.full_size_specs(C, ast_mod, gate, cfg=cfg)
    engine = C.TwoStageEngine(g1, g2, C.CascadeConfig(
        stage2_mode="gated", stage1_threshold=gate["threshold"], **kw),
        device="cpu")
    p1, p2 = engine.window_probs(audio)
    return {"engine_all": engine_all, "engine": engine, "gate": gate,
            "audio": audio, "p1": p1, "p2": p2}


def test_calibrated_gate_rate_and_margin(calibrated):
    engine, p1 = calibrated["engine"], calibrated["p1"]
    W = len(p1)
    assert W == 119
    rate = len(engine._gate_indices(p1)) / W
    near = chip_smoke.near_gate(p1, engine.config.stage1_threshold,
                                chip_smoke.ENGINE_TOL)
    assert abs(rate - chip_smoke.GATE_RATE) <= 0.05, rate
    assert near.sum() <= chip_smoke.GATE_NEAR_MAX * W, int(near.sum())
    chip_smoke.check_gate("small engine", engine, p1)  # the phases' check
    # the gated windows are the ones stage 2 ran on
    gated = np.abs(calibrated["p2"]).sum(1) > 0
    assert np.array_equal(np.flatnonzero(gated), engine._gate_indices(p1))


def test_check_gate_refuses_a_gate_in_its_band(calibrated):
    """bench.py's calibration (the class-1 bias shift alone) on the same
    engine: the gate passes windows whose probabilities all lie close
    together, and check_gate refuses it."""
    p_all = calibrated["engine_all"].window_probs(calibrated["audio"])[0]
    p = np.clip(p_all[:, 1], 1e-9, 1 - 1e-9)
    d = np.log((1 - p) / p)
    delta = float(np.quantile(d, 0.995))
    shifted = 1.0 / (1.0 + np.exp(d - delta))
    thr = max(0.5, float(np.quantile(shifted, 1.0 - chip_smoke.GATE_RATE)))
    p1 = np.stack([1 - shifted, shifted], 1)
    engine = C.TwoStageEngine(*chip_smoke.full_size_specs(
        C, ast_mod, cfg=ast_mod.ASTConfig(**SMALL)), C.CascadeConfig(
        stage2_mode="gated", stage1_threshold=thr, batch_size=32,
        dtype=torch.float32), device="cpu")
    near = chip_smoke.near_gate(p1, thr, chip_smoke.ENGINE_TOL).sum()
    assert near > chip_smoke.GATE_NEAR_MAX * len(p1)
    with pytest.raises(AssertionError, match="calibrated gate"):
        chip_smoke.check_gate("bias shift alone", engine, p1)


def test_gate_head_reaches_the_mesh_ranks(calibrated):
    """parallel/checks.seeded_spec builds the calibrated stage 1 in a rank
    from the gate's head: the same parameters as full_size_specs'."""
    from zenker_audio_detection_tpu_torch.parallel import checks

    cfg = ast_mod.ASTConfig(**SMALL)
    spec = checks.seeded_spec(1, cfg, head=calibrated["gate"]["head"])
    want = chip_smoke.full_size_specs(C, ast_mod, calibrated["gate"],
                                      cfg=cfg)[0]
    for k in ("kernel", "bias"):
        assert torch.equal(spec.params["head"]["dense"][k],
                           want.params["head"]["dense"][k])
    assert torch.equal(spec.params["encoder"]["q"]["kernel"],
                       want.params["encoder"]["q"]["kernel"])
