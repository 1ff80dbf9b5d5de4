"""The work the benchmark counts, against values worked by hand."""

import pytest

from portbench import harness, work


def shape(name):
    return work.Shape.of(harness.find(name).config)


@pytest.mark.parametrize("cell,gflop,seq", [
    ("ast1024.recordings_gated", 261.0, 1214),
    ("ast128.recordings_gated", 25.6, 146)])
def test_forward_flops_per_window_and_stage(cell, gflop, seq):
    s = shape(cell)
    assert s.seq_length == seq
    assert work.forward_flops(s) / 1e9 == pytest.approx(gflop, abs=0.05)


def test_forward_flops_by_part_at_1214_tokens():
    s = shape("ast1024.recordings_gated")
    # 12 layers of 2 S (4 H^2 + 2 H I), 12 of 4 S^2 H, the patch conv
    dense = 12 * 2 * 1214 * (4 * 768 ** 2 + 2 * 768 * 3072)
    attention = 12 * 4 * 1214 ** 2 * 768
    patch = 2 * 1212 * 768 * 256
    head = 2 * 768 * 2
    assert work.forward_flops(s) == dense + attention + patch + head
    assert 12 * work.attention_flops(s, 1) == attention


def test_train_step_is_three_forwards_a_row():
    s = shape("ast1024.finetune_b16")
    assert work.train_step_flops(s, 16) == 48 * work.forward_flops(s)


@pytest.mark.parametrize("n,want", [(0, []), (5, [8]), (8, [8]), (9, [16]),
                                    (128, [128]), (300, [128, 128, 64]),
                                    (250, [128, 128])])
def test_buckets_are_the_engines(n, want):
    assert work.buckets(n, 128) == want


def test_attention_work_of_a_launch_is_4_b_nh_s2_d():
    s = shape("ast1024.recordings_gated")
    assert work.attention_flops(s, 128) == 4 * 128 * 12 * 1214 ** 2 * 64
