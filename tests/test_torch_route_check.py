"""chip_smoke.py phase 6's route check at the same parameters, on the CPU:
`same_point_readings` steps the "kernel" route (its plain version on CPU
tensors) and reads both routes' loss and gradients at every parameter
point it visits; `check_same_points` holds them to TRAIN_LOSS_TOL and
TRAIN_GRAD_REL_TOL. Small config (2 layers, width 64, 4 heads, 146
tokens, batch 4) in f32, where the two routes agree to rounding: the check
passes them, and refuses a kernel route whose gradient of one leaf is
scaled by 1.1 or whose loss is shifted by 1e-2."""

import pytest
import torch

import chip_smoke
from zenker_audio_detection_tpu_torch.models import ast as ast_mod

CFG = ast_mod.ASTConfig(hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_length=128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    routes = chip_smoke.train_routes(ast_mod, CFG, torch.float32)
    inputs = chip_smoke.route_inputs(ast_mod, CFG, 7, 4, "cpu")
    return routes, inputs


def test_route_inputs_are_the_noise_tools():
    """Weights from numpy seed s, the batch from s + 1, on the device."""
    import numpy as np

    params, feats, labels = chip_smoke.route_inputs(ast_mod, CFG, 17, 4,
                                                    "cpu")
    want = ast_mod.init_params(np.random.default_rng(17), CFG)
    assert torch.equal(params["encoder"]["q"]["kernel"],
                       want["encoder"]["q"]["kernel"])
    rng = np.random.default_rng(18)
    assert np.array_equal(feats.numpy(), rng.standard_normal(
        (4, CFG.max_length, CFG.num_mel_bins)).astype(np.float32))
    assert sorted(labels.tolist()) == [0, 0, 1, 1]
    assert CFG.seq_length == 146


def test_same_points_pass(setup):
    routes, inputs = setup
    readings = chip_smoke.same_point_readings(routes, *inputs)
    assert len(readings) == chip_smoke.TRAIN_STEPS + 1
    chip_smoke.check_same_points("small f32", readings)
    # the points are the kernel route's trajectory: its loss falls
    losses = [r["loss_kernel"] for r in readings]
    assert losses[-1] < losses[0]
    for r in readings:
        assert r["loss_diff"] <= 1e-5 and r["grad_rel"] <= 1e-4, r


@pytest.mark.parametrize("fault", ["grad_leaf_x1.1", "loss+1e-2"])
def test_same_points_refuse_a_faulty_route(setup, fault):
    routes, inputs = setup
    leaf = "pos_embed"  # the largest gradient at these points

    def faulty(p, f, y):
        lv, g = routes["kernel"](p, f, y)
        if fault == "loss+1e-2":
            return lv + 1e-2, g
        g = dict(g)
        g[leaf] = g[leaf] * 1.1
        return lv, g

    readings = chip_smoke.same_point_readings(
        {"kernel": faulty, "torch": routes["torch"]}, *inputs)
    with pytest.raises(AssertionError, match="disagree"):
        chip_smoke.check_same_points(fault, readings)
