"""The port's fold-parallel trainer (`train/fold_parallel.py`) against the
JAX package's and against the port's own sequential trainer.

Two folds with unequal train sets (10 and 13 clips at batch 4: other
steps_per_epoch, tail batches and LR schedules, and masked no-op steps for
the shorter fold), 4 epochs, early stopping on, hidden 32, 2 layers, 128
frames, f32, on the CPU. Both packages start from ONE parameter tree (each
`init_model` returns the JAX `init_params` tree, as
tests/test_torch_train_loop.py does). Histories and fold metrics agree at
1e-4: port fold-parallel against JAX fold-parallel, and against the port's
sequential `train_fold` of each fold, whose first-step gradient norms are
above 1.0 (so the clip is each fold's own: a norm over both folds would
show). Also: a fold-parallel checkpoint resumes in the sequential trainer
of both packages, the masked no-op step, the stacked forward against the
model's, the refusals and the CLI's --parallel-folds."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.audio import io as jaio
from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.train import loop as JL
from zenker_audio_detection_tpu_torch.cli import train_stage1 as cli_s1
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert
from zenker_audio_detection_tpu_torch.train import fold_parallel as FP
from zenker_audio_detection_tpu_torch.train import loop as L
from zenker_audio_detection_tpu_torch.train import optim

TOL = 1e-4
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, num_labels=2, max_length=128)
COMMON = dict(stage="stage1", num_epochs=4, batch_size=4, eval_batch_size=4,
              learning_rate=1e-3, warmup_ratio=0.25,
              enable_early_stopping=True, augment=False, seed=42)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors (and for child
    processes, through OMP_NUM_THREADS): the suite runs in several worker
    processes on a few cores, where each process's thread pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


def _speed(key: str) -> bool:
    return "runtime" in key or "per_second" in key


def make_folds(root, sizes=((1, 10), (2, 13))):
    """Folds of seeded one-second clips (label i % 2: quiet or loud noise)
    with their own train sizes, 6 val and 6 test clips each."""
    rng = np.random.default_rng(7)
    data = root / "data"
    data.mkdir()
    for fold, n_train in sizes:
        for name, n in (("train", n_train), ("val", 6), ("test", 6)):
            xs, ys = [], []
            for i in range(n):
                label = i % 2
                d = root / "wavs" / f"f{fold}" / name / str(i)
                d.mkdir(parents=True)
                fp = d / "clip.wav"
                jaio.write_wav(str(fp), (rng.standard_normal(16000) * (
                    0.5 if label else 0.004)).astype(np.float32), 16000,
                    dtype="float32")
                xs.append(str(fp))
                ys.append(label)
            np.save(data / f"{name}_x_fold{fold}.npy", np.asarray(xs, object))
            np.save(data / f"{name}_y_fold{fold}.npy", np.asarray(ys))
    return str(data)


def _jax_tree():
    import jax

    return jax.tree.map(np.asarray, jast.init_params(
        jax.random.PRNGKey(3), jast.ASTConfig(**TINY)))


def _patch_init(mp, tree):
    import jax
    import jax.numpy as jnp

    mp.setattr(JL, "init_model", lambda c: (
        jax.tree.map(jnp.asarray, tree), jast.ASTConfig(**TINY)))
    mp.setattr(L, "init_model", lambda c: (
        convert.params_from_jax(tree), ast_mod.ASTConfig(**TINY)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX fold-parallel, port fold-parallel and the port's sequential
    train_fold on folds 1 and 2, from one tree; the sequential runs'
    gradient norms recorded."""
    import jax.numpy as jnp
    from zenker_audio_detection_tpu.train.fold_parallel import (
        train_folds_parallel as jax_parallel)

    root = tmp_path_factory.mktemp("fp")
    data = make_folds(root)
    tree = _jax_tree()
    cfg = L.TrainFoldConfig(data_dir=data, output_root=str(root / "par"),
                            dtype=torch.float32, device="cpu", **COMMON)
    norms = []
    global_norm = optim.global_norm

    def spy(grads):
        norm = global_norm(grads)
        norms.append(float(norm))
        return norm

    with pytest.MonkeyPatch.context() as mp:
        _patch_init(mp, tree)
        want = jax_parallel([1, 2], JL.TrainFoldConfig(
            data_dir=data, output_root=str(root / "jax"), dtype=jnp.float32,
            **COMMON))
        got = FP.train_folds_parallel([1, 2], cfg)
        mp.setattr(optim, "global_norm", spy)
        seq = [L.train_fold(f, dataclasses.replace(
            cfg, output_root=str(root / "seq"))) for f in (1, 2)]
    return root, tree, cfg, got, want, seq, norms


def _history(root, tag, fold):
    return json.loads((root / tag / f"fold{fold}" / "history.json")
                      .read_text())


def _same_histories(a, b):
    assert [h["epoch"] for h in a] == [h["epoch"] for h in b]
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for key in y:
            assert x[key] == pytest.approx(y[key], abs=TOL), (key, x, y)


def _same_metrics(a, b):
    assert set(a) == set(b)
    for key, value in b.items():
        if not _speed(key):
            assert a[key] == pytest.approx(value, abs=TOL), key


@pytest.mark.parametrize("fold", [1, 2])
def test_histories_match_jax_and_sequential(runs, fold):
    root, *_ = runs
    got = _history(root, "par", fold)
    _same_histories(got, _history(root, "jax", fold))
    _same_histories(got, _history(root, "seq", fold))


@pytest.mark.parametrize("fold", [1, 2])
def test_fold_metrics_match_jax_and_sequential(runs, fold):
    _, _, _, got, want, seq, _ = runs
    _same_metrics(got[fold - 1], want[fold - 1])
    _same_metrics(got[fold - 1], seq[fold - 1])
    assert got[fold - 1][f"fold{fold}_test_eval_f1"] > 0.6


def test_a_fold_clips_its_own_gradient(runs):
    """The sequential runs clip (gradient norms above max_grad_norm 1.0,
    other in each fold) and the parallel run still agrees with them
    (test_histories_match_jax_and_sequential): each fold's clip is its
    own, where a norm over both folds would scale each by another
    factor."""
    *_, norms = runs
    assert max(norms) > 1.0
    assert len(set(norms)) > 1


def test_unequal_folds_take_masked_steps(runs):
    """Fold 1 has 3 steps an epoch, fold 2 four: its checkpoints are named
    by its own step count, as the sequential trainer names them."""
    root, *_ = runs
    for tag in ("par", "seq"):
        names = {fold: sorted(p.name for p in (root / tag / f"fold{fold}")
                              .glob("checkpoint-*")) for fold in (1, 2)}
        assert all(n.split("-")[1] in {"3", "6", "9", "12"}
                   for n in names[1]), names
        assert all(n.split("-")[1] in {"4", "8", "12", "16"}
                   for n in names[2]), names
    assert names == {fold: sorted(p.name for p in (root / "par" /
                                  f"fold{fold}").glob("checkpoint-*"))
                     for fold in (1, 2)}


def test_best_params_match_sequential(runs):
    root, *_ = runs
    for fold in (1, 2):
        got, _ = convert.load_hf_model_dir(str(root / "par" / f"fold{fold}"
                                               / "best"))
        want, _ = convert.load_hf_model_dir(str(root / "seq" / f"fold{fold}"
                                                / "best"))
        got = convert._flatten_tree(convert.params_to_numpy(got))
        want = convert._flatten_tree(convert.params_to_numpy(want))
        for key in want:
            err = np.abs(got[key] - want[key]).max()
            assert err <= (COMMON["learning_rate"] if key == "encoder.k.bias"
                           else TOL), (fold, key, err)


def test_checkpoint_resumes_sequentially_in_both_packages(runs, tmp_path):
    """A copy of fold 2's fold-parallel run without its last checkpoint:
    the port's and the JAX package's sequential --resume continue from the
    one before it, and their last epoch matches the parallel run's."""
    import jax.numpy as jnp

    root, tree, cfg, *_ = runs
    want = _history(root, "par", 2)
    assert len(want) >= 2
    for package in ("port", "jax"):
        out = tmp_path / package
        shutil.copytree(root / "par" / "fold2", out / "fold2")
        cks = sorted((out / "fold2").glob("checkpoint-*"),
                     key=lambda p: int(p.name.split("-")[1]))
        shutil.rmtree(cks[-1])
        resumed_cfg = dict(data_dir=cfg.data_dir, output_root=str(out),
                           resume=True, **COMMON)
        with pytest.MonkeyPatch.context() as mp:
            _patch_init(mp, tree)
            if package == "port":
                L.train_fold(2, L.TrainFoldConfig(
                    dtype=torch.float32, device="cpu", **resumed_cfg))
            else:
                JL.train_fold(2, JL.TrainFoldConfig(dtype=jnp.float32,
                                                    **resumed_cfg))
        _same_histories(_history(tmp_path, package, 2), want)


def _tiny_params(seed):
    cfg = ast_mod.ASTConfig(hidden_size=16, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=32,
                            max_length=128)
    return ast_mod.init_params(np.random.default_rng(seed), cfg), cfg


def test_masked_no_op_leaves_a_stopped_fold_as_it_was():
    """active = [True, False]: fold 0 takes its update, fold 1's
    parameters, moments and Adam count come back bitwise unchanged."""
    p0, cfg = _tiny_params(0)
    p1, _ = _tiny_params(1)
    params = optim.tree_map(lambda a, b: torch.stack([a, b]), p0, p1)
    opt = torch.func.vmap(optim.adamw_init)(params)
    # a stopped fold with a non-zero state: one earlier update of both
    step = FP.make_stacked_train_step(
        cfg, lambda lg, y, m, hp: torch.nn.functional.cross_entropy(
            lg, y), optim.decay_mask(p0), dtype=torch.float32,
        weight_decay=0.01, beta2=0.98)
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.standard_normal((2, 3, 128, 128))
                             .astype(np.float32))
    labels = torch.tensor([[0, 1, 1], [1, 0, 1]])
    mask = torch.ones(2, 3)
    hp = {"lr": torch.tensor([1e-2, 1e-2])}
    params, opt, _ = step(params, opt, feats, labels, mask,
                          torch.tensor([True, True]), hp)
    before = (params, opt)
    params2, opt2, losses = step(params, opt, feats, labels, mask,
                                 torch.tensor([True, False]), hp)
    assert torch.isfinite(losses).all()
    assert opt2["count"].tolist() == [2, 1]
    for (_, new), (_, old) in zip(optim.tree_items({"p": params2, "o": opt2}),
                                  optim.tree_items({"p": before[0],
                                                    "o": before[1]})):
        assert torch.equal(new[1], old[1])
    assert not torch.equal(params2["head"]["dense"]["kernel"][0],
                           before[0]["head"]["dense"]["kernel"][0])


@pytest.mark.parametrize("shared", [False, True])
def test_stacked_forward_is_the_model_per_member(shared):
    """stacked_forward against models.ast.forward of each member, and with
    remat the gradients of the summed losses against each member's own
    (remat outside the vmap changes no number)."""
    p0, cfg = _tiny_params(3)
    p1, _ = _tiny_params(4)
    params = optim.tree_map(lambda a, b: torch.stack([a, b]), p0, p1)
    rng = np.random.default_rng(5)
    shape = (3, 128, 128) if shared else (2, 3, 128, 128)
    feats = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    with torch.no_grad():
        got = FP.stacked_forward(params, feats, cfg, dtype=torch.float32,
                                 shared_batch=shared)
    for i, p in enumerate((p0, p1)):
        x = feats if shared else feats[i]
        with torch.no_grad():
            want = ast_mod.forward(p, x, cfg)
        torch.testing.assert_close(got[i], want, atol=1e-5, rtol=1e-5)

    leaves = [leaf.detach().requires_grad_()
              for _, leaf in optim.tree_items(params)]
    tree = optim.tree_from_items(zip((k for k, _ in optim.tree_items(params)),
                                     leaves))
    FP.stacked_forward(tree, feats, cfg, dtype=torch.float32, remat=True,
                       shared_batch=shared).square().sum().backward()
    for i, p in enumerate((p0, p1)):
        own = {k: v.detach().clone().requires_grad_()
               for k, v in convert._flatten_tree(p).items()}
        x = feats if shared else feats[i]
        ast_mod.forward(convert._unflatten_tree(own), x, cfg,
                        remat=True).square().sum().backward()
        for (path, leaf) in zip((k for k, _ in optim.tree_items(params)),
                                leaves):
            name = ".".join(path)
            torch.testing.assert_close(leaf.grad[i], own[name].grad,
                                       atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kw,match", [
    ({"streaming": True}, "streaming"),
    ({"grad_accum": 2}, "gradient accumulation"),
    ({"resume": True}, "resume"),
    ({"on_epoch_end": lambda e, m: False}, "on_epoch_end")])
def test_refusals(tmp_path, kw, match):
    cfg = L.TrainFoldConfig(output_root=str(tmp_path / "out"), device="cpu",
                            fold_parallel=True, **kw)
    with pytest.raises(ValueError, match=match):
        FP.train_folds_parallel([1, 2], cfg)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("flags,exc,match", [
    (["--parallel-folds", "--streaming"], SystemExit, "incompatible"),
    (["--parallel-folds", "--resume"], SystemExit, "incompatible"),
    (["--parallel-folds", "--grad-accum", "2"], SystemExit, "incompatible"),
    (["--parallel-folds", "--num-devices", "2"], RuntimeError,
     "5 folds not divisible by 2 fold groups"),
    (["--parallel-folds", "--data-per-fold", "1"], FileNotFoundError,
     "missing train/test npy files for fold 1 in data_ast_stage1")])
def test_cli_refusals(tmp_path, monkeypatch, flags, exc, match):
    """The JAX trainer's refusals; the flags of several devices now run as
    JAX's do: the fold axis over two ranks refuses five folds in two
    groups in each rank (JAX's ValueError, reported by the launcher), and
    one fold group of one device fails on the missing default data dir."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(exc, match=match):
        cli_s1.main(["--device", "cpu", "--output-root",
                     str(tmp_path / "runs"), "--max-length", "128", *flags])


def test_cli_parallel_folds_on_the_cpu(tmp_path):
    """train_stage1 --parallel-folds --device cpu over two folds: both
    folds' artifacts and cv_metrics; without --device it needs CUDA."""
    data = make_folds(tmp_path, sizes=((1, 4), (2, 6)))
    out = tmp_path / "runs"
    pre = tmp_path / "pre"
    p, cfg = _tiny_params(6)
    convert.save_hf_model_dir(p, cfg, str(pre))
    argv = ["--num-folds", "2", "--data-dir", data, "--output-root",
            str(out), "--pretrained-model-dir", str(pre), "--dry-run",
            "--f32", "--no-augment", "--no-wandb", "--parallel-folds"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_s1.main(argv)
        assert not out.exists()
    cli_s1.main(argv + ["--device", "cpu"])
    for fold in (1, 2):
        assert (out / f"fold{fold}" / "best" / "model.safetensors").exists()
        assert (out / f"fold{fold}" / "run_config.json").exists()
    cv = np.load(out / "cv_metrics.npy", allow_pickle=True).item()
    assert len(cv["per_fold"]) == 2 and "eval_f1_mean" in cv["aggregate"]
