"""The reference against the program's plain ("torch") route on the CPU,
at widths a test holds; and whole runs of each kind of cell there."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from portbench import harness, inputs
from portbench.reference import ast as ref_ast
from portbench.reference import cascade as ref_cascade
from portbench.reference import fbank as ref_fbank
from portbench.reference import train as ref_train
from zenker_audio_detection_tpu_torch.infer import cascade as C
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.ops import fbank as F
from zenker_audio_detection_tpu_torch.train import losses, optim, steps

from conftest import TINY, tiny_cell

CPU = torch.device("cpu")


def tiny_config(max_length=128):
    config = dict(harness.find("ast128.recordings_gated").config, **TINY)
    config["max_length"] = max_length
    return config


def port_config(config):
    fields = {f.name for f in dataclasses.fields(ast_mod.ASTConfig)}
    return ast_mod.ASTConfig(**{k: v for k, v in config.items()
                                if k in fields})


@pytest.mark.parametrize("max_length", [128, 256])
def test_forward_matches_the_programs_plain_route(max_length):
    config = tiny_config(max_length)
    params = inputs.weights(config, 7, "stage1", CPU)
    feats = torch.randn(3, max_length, 128, generator=torch.Generator()
                        .manual_seed(1))
    want, _ = ref_ast.forward(params, feats, config)
    got = ast_mod.forward(params, feats, port_config(config),
                          attention_impl="torch")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_front_end_matches_the_programs():
    mix = harness.find("ast128.recordings_gated").mix
    pcm = inputs.audio([3.0], mix, 5, "clip", CPU)[0]
    starts = np.array([0, 8000, 16000])
    want = ref_fbank.window_features(pcm, starts, 16000, 128,
                                     mix["feature_mean"], mix["feature_std"],
                                     CPU)
    wav = torch.as_tensor(pcm[starts[:, None] + np.arange(16000)])
    got = F.ast_features(wav, F.FbankConfig(max_length=128,
                                            mean=mix["feature_mean"],
                                            std=mix["feature_std"]))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


def test_gate_and_summary_match_the_programs():
    rng = np.random.default_rng(3)
    p1 = rng.dirichlet([1, 1], size=41)
    p2 = rng.dirichlet([1, 1], size=41)
    cfg = C.CascadeConfig()
    gated = ref_cascade.gate(p1, cfg.stage1_threshold)
    p2[np.setdiff1d(np.arange(41), gated)] = 0.0
    got = C.summarize_stage_outputs(p1, [(int(g), p2[g]) for g in gated],
                                    ["Idle", "Swallow"], ["Healthy", "Zenker"],
                                    cfg.stage2_threshold)
    want = ref_cascade.file_summary(p1, p2, cfg.stage1_threshold,
                                    cfg.stage2_threshold)
    assert ref_cascade.mismatches(got, want) == []
    patient = C.build_patient_output(cfg, ["a", "b"],
                                     {"file_0": got, "file_1": got})
    assert ref_cascade.mismatches(
        patient["aggregate"], ref_cascade.patient_totals([want, want])) == []
    got["stage2_zenker_windows"] += 1
    assert ref_cascade.mismatches(got, want) == ["stage2_zenker_windows"]


def test_a_training_step_matches_the_programs():
    config = dict(tiny_config(128), num_labels=2)
    params = inputs.weights(config, 11, "model", CPU)
    gen = torch.Generator().manual_seed(2)
    feats = torch.randn(4, 128, 128, generator=gen)
    labels = torch.tensor([0, 1, 1, 0])
    opt = {"learning_rate": 1e-3, "weight_decay": 0.01, "warmup_ratio": 0.0,
           "beta2": 0.98, "total_steps": 10, "beta1": 0.9, "eps": 1e-8,
           "max_grad_norm": 1.0}
    tx = optim.make_optimizer(1e-3, 10, 0.0, 0.01, beta2=0.98)
    step = steps.make_train_step(
        tx, port_config(config), lambda lg, lb: losses.stage1_loss(lg, lb),
        dtype=torch.float32)
    got_p, _, got_loss, _ = step(params, tx.init(params), feats, labels)
    loss, grads, _ = ref_train.loss_and_grads(params, feats, labels, config,
                                              2)
    want_p, _ = ref_train.adamw_step(params, ref_train.init_state(params),
                                     grads, opt)
    assert float(got_loss) == pytest.approx(loss, rel=1e-5)
    for (n, a), (_, b) in zip(ref_train.leaves(got_p),
                              ref_train.leaves(want_p)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=n)


@pytest.mark.parametrize("name", ["ast128.recordings_gated",
                                  "ast1024.finetune_b16"])
def test_a_sound_run_is_correct(name):
    out = harness.run_cell(tiny_cell(name), 2 ** 31 + 77, 0.5, False,
                           time.perf_counter(), device="cpu",
                           log=lambda m: None)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == set(tiny_cell(name).end_to_end)
