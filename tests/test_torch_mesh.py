"""The port's meshes (`parallel/mesh.py`), the sharded engine and the
data-parallel step against the JAX package, mirroring
tests/test_mesh_utils.py and tests/test_multichip.py.

JAX runs its meshes over the 8 virtual CPU devices of tests/conftest.py in
this process; the port runs two ranks (and four for the ("dcn", "data")
mesh) of a gloo process group, spawned by `parallel/launch.spawn`, one
intra-op thread each. The ranks run `parallel/checks.py` (children import
no JAX and no test module) and send back what they computed; the JAX side
is computed here on the same parameter trees (`params_from_jax`) and the
same inputs. One spawn per rank count serves every check of this file.

Tolerances: `pad_to_multiple` bitwise; the sharded engine's probabilities
1e-5 (test_multichip.py:47-48); the data-parallel step's loss 1e-5, its
summed gradients 1e-5 of each leaf's largest magnitude (at least 1: the
class-token gradient reaches ~200 on random features) and its parameters
1e-5 (test_multichip.py:100-103),
except the key bias, whose gradient is zero in exact arithmetic and which
Adam moves by up to the learning rate on rounding noise across frameworks
(held to the learning rate, as tests/test_torch_train_loop.py holds it).
Within the port, the ranks' parameters stay bitwise equal."""

import functools

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.infer import cascade as JC
from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.parallel import mesh as jmesh
from zenker_audio_detection_tpu_torch.infer import cascade as C
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert
from zenker_audio_detection_tpu_torch.parallel import checks, launch
from zenker_audio_detection_tpu_torch.parallel import mesh as pmesh

TOL = 1e-5
LR = 1e-3
NOISE_LEAF = "encoder.k.bias"
SMALL = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
             intermediate_size=32, num_labels=2)
STEP = dict(SMALL, num_mel_bins=128, max_length=128)
# 16 rows: the first half (rank 0's shard of two) has label mean 3/8, the
# batch 10/16, so a per-shard focal alpha or normalizer would differ from
# the global batch's
LABELS = np.array([0, 0, 0, 1, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1], np.int64)
CLASS_W = np.array([0.7, 1.6], np.float32)
LOSSES = {"stage1": ("stage1", {"focal_gamma": 2.0, "label_smoothing": 0.1}),
          "focal": ("focal", {"class_weights": CLASS_W}),
          "wce": ("wce", {"class_weights": CLASS_W})}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    import jax

    cfg = jast.ASTConfig(**SMALL)
    t1 = jax.tree.map(np.asarray, jast.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    t2 = jax.tree.map(np.asarray, jast.init_params(jax.random.PRNGKey(1),
                                                   cfg))
    step = jax.tree.map(np.asarray, jast.init_params(
        jax.random.PRNGKey(0), jast.ASTConfig(**STEP)))
    return t1, t2, step


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    audio = (rng.standard_normal(16000 * 6) * 0.1).astype(np.float32)
    feats = rng.standard_normal((16, 128, 128)).astype(np.float32)
    return audio, feats


def _port_specs(trees):
    t1, t2, _ = trees
    cfg = ast_mod.ASTConfig(**SMALL)
    return (C.StageSpec(convert.params_from_jax(t1), cfg, -1.15, 3.53,
                        ("Idle", "Swallow")),
            C.StageSpec(convert.params_from_jax(t2), cfg, -0.9, 2.8,
                        ("Healthy", "Zenker")))


def _engine_cfg(mode="gated"):
    return C.CascadeConfig(batch_size=16, dtype=torch.float32,
                           stage2_mode=mode)


def _step_call(trees, feats, loss, rows=16, num_slices=1):
    return ("train_step",
            (convert.params_from_jax(trees[2]), ast_mod.ASTConfig(**STEP),
             feats[:rows], LABELS[:rows], loss, "cpu"),
            {"num_slices": num_slices})


@pytest.fixture(scope="module")
def two_ranks(trees, inputs):
    """Every check of two ranks in one process group."""
    audio, feats = inputs
    s1, s2 = _port_specs(trees)
    calls = {
        "layout": ("mesh_layout", (), {}),
        "engine_gated": ("engine_probs", (s1, s2, audio, _engine_cfg(),
                                          "cpu"), {}),
        "engine_all": ("engine_probs", (s1, s2, audio, _engine_cfg("all"),
                                        "cpu"), {}),
        "engine_13": ("engine_probs", (s1, s2, audio, C.CascadeConfig(
            batch_size=13, dtype=torch.float32), "cpu"), {}),
        "too_many": ("make_mesh_error", (4,), {"device": "cpu"}),
        "tail_step": _step_call(trees, feats, LOSSES["stage1"], rows=15),
        **{f"step_{k}": _step_call(trees, feats, v)
           for k, v in LOSSES.items()},
    }
    out = launch.spawn(checks.sequence, (list(calls.values()),), nprocs=2,
                       device="cpu")
    return dict(zip(calls, out))


@pytest.fixture(scope="module")
def four_ranks(trees, inputs):
    """The ("dcn", "data") and ("fold", "data") checks of four ranks."""
    audio, feats = inputs
    s1, s2 = _port_specs(trees)
    calls = {
        "layout_dcn": ("mesh_layout", (), {"num_slices": 2}),
        "layout_fold": ("mesh_layout", (), {"data_per_fold": 2}),
        "engine_dcn": ("engine_probs", (s1, s2, audio, _engine_cfg(), "cpu"),
                       {"num_slices": 2}),
        "step_dcn": _step_call(trees, feats, LOSSES["focal"], num_slices=2),
        "slices_3": ("mesh_layout", (), {"num_slices": 3}),
        "make_4x1": ("mesh_layout", (), {"num_slices": 1}),
        "too_many": ("make_mesh_error", (8,), {"device": "cpu"}),
    }
    out = launch.spawn(checks.sequence, (list(calls.values()),), nprocs=4,
                       device="cpu")
    return dict(zip(calls, out))


def _ok(entry):
    status, value = entry
    assert status == "ok", value
    return value


# ---------------------------------------------------------------------------
# mesh utilities (tests/test_mesh_utils.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,multiple,axis,pad_value", [
    (10, 8, 0, 0.0), (16, 8, 0, 0.0), (3, 4, 1, -1.5), (7, 3, 0, 2.0),
    (1, 1, 0, 0.0)])
def test_pad_to_multiple_bitwise_jax(n, multiple, axis, pad_value):
    x = np.random.default_rng(n).standard_normal(
        (n, 5) if axis == 0 else (2, n)).astype(np.float32)
    got, got_n = pmesh.pad_to_multiple(x, multiple, axis, pad_value)
    want, want_n = jmesh.pad_to_multiple(x, multiple, axis, pad_value)
    assert got_n == want_n and got.dtype == want.dtype
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_local_batch_size(two_ranks, four_ranks):
    """tests/test_mesh_utils.py:18 and test_multichip.py:315: the global
    batch over the mesh, and JAX's refusal of a batch that does not
    divide."""
    for r in _ok(two_ranks["layout"]):
        assert r["local_batch"] == 8
    for r in _ok(four_ranks["layout_dcn"]):
        assert r["local_batch"] == 4

    class Mesh:
        mesh = torch.arange(3)

    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        pmesh.local_batch_size(16, Mesh)
    with pytest.raises(ValueError, match="not divisible"):
        jmesh.local_batch_size(16, jmesh.make_mesh(3))


def test_shard_gather_and_replicate_round_trip(two_ranks, four_ranks):
    """tests/test_mesh_utils.py:27: each rank's shard is its contiguous
    slice of the leading axis in rank order (dcn-major), the gather gives
    back the global array on every rank, and `replicate` puts rank 0's
    tensor on every rank."""
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for key, result in (("2", two_ranks["layout"]),
                        ("dcn", four_ranks["layout_dcn"])):
        ranks = _ok(result)
        b = 16 // len(ranks)
        for r in ranks:
            np.testing.assert_array_equal(
                r["shard"], x[r["mesh_rank"] * b: (r["mesh_rank"] + 1) * b])
            np.testing.assert_array_equal(r["gathered"], x)
            assert r["replicated"] == [0.0, 0.0], key
        assert [r["mesh_rank"] for r in ranks] == list(range(len(ranks)))


def test_hierarchical_mesh_shape_and_validation(four_ranks):
    """tests/test_multichip.py:308: the ("dcn", "data") mesh over four
    ranks, JAX's axis names and shapes, and every ValueError of make_mesh
    and data_mesh with JAX's words."""
    import jax

    ranks = _ok(four_ranks["layout_dcn"])
    jdcn = jmesh.data_mesh(jax.devices()[:4], num_slices=2)
    for r in ranks:
        assert r["names"] == tuple(jdcn.axis_names) == (pmesh.DCN_AXIS,
                                                        pmesh.DATA_AXIS)
        assert r["shape"] == tuple(jdcn.devices.shape) == (2, 2)
    # each slice's ranks are contiguous
    assert [r["data_ranks"] for r in ranks] == [[0, 1], [0, 1], [2, 3],
                                                [2, 3]]
    for r in _ok(four_ranks["make_4x1"]):
        assert r["names"] == (pmesh.DATA_AXIS,) and r["shape"] == (4,)
    status, msg = four_ranks["slices_3"]
    assert status == "error" and "not divisible by 3 slices" in msg
    with pytest.raises(ValueError, match="divisible"):
        jmesh.data_mesh(jax.devices()[:4], num_slices=3)

    assert four_ranks["too_many"] == ("ok", "requested 8 devices, only 4 "
                                              "visible")
    with pytest.raises(ValueError, match="requested 16 devices, only 8"):
        jmesh.make_mesh(16)


@pytest.mark.parametrize("args,kw,match", [
    ((8, 0), {}, "num_slices must be >= 1, got 0"),
    ((None, 2), {}, "num_slices > 1 requires num_devices > 1"),
    ((1, 2), {}, "num_slices > 1 requires num_devices > 1"),
    ((0,), {}, "num_devices must be >= 1, got 0"),
    ((2, 2), {"axis_name": "fold"}, "only applies to the data axis"),
])
def test_make_mesh_errors_are_jax_errors(args, kw, match):
    """The validations before any device is counted: the same words as
    JAX's make_mesh, and no process group needed."""
    with pytest.raises(ValueError, match=match):
        pmesh.make_mesh(*args, **kw, device="cpu")
    with pytest.raises(ValueError, match=match):
        jmesh.make_mesh(*args, **kw)
    assert pmesh.make_mesh(None, device="cpu") is None
    assert pmesh.make_mesh(1, 1, device="cpu") is None


def test_make_mesh_counts_cards_on_cuda():
    """On CUDA, "visible" is torch.cuda.device_count(): asking for more
    cards than the machine has raises JAX's error before anything starts,
    and the launcher does not fall back to fewer ranks or to the CPU."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError,
                       match=f"requested {n + 2} devices, only {n} visible"):
        pmesh.make_mesh(n + 2, device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch.spawn(checks.mesh_layout, (), nprocs=2, device="cuda")


@pytest.mark.parametrize("args,match", [
    ((4, 0), "data_per_fold must be >= 1, got 0"),
    ((3, 2), "3 devices not divisible into groups of 2")])
def test_fold_data_mesh_errors_are_jax_errors(args, match):
    with pytest.raises(ValueError, match=match):
        pmesh.fold_data_mesh(*args, device="cpu")
    with pytest.raises(ValueError, match=match):
        jmesh.fold_data_mesh(*args)


def test_fold_data_mesh_groups(four_ranks):
    """fold_data_mesh(4, 2): two ("fold", "data") groups of contiguous
    ranks, each rank's shard taken within its group."""
    ranks = _ok(four_ranks["layout_fold"])
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for r in ranks:
        assert r["names"] == (pmesh.FOLD_AXIS, pmesh.DATA_AXIS)
        assert r["shape"] == (2, 2)
        assert r["sub_ranks"] == ([0, 1] if r["rank"] < 2 else [2, 3])
        k = r["rank"] % 2
        np.testing.assert_array_equal(r["shard"], x[k * 8: (k + 1) * 8])
        assert r["replicated"] == [float(r["sub_ranks"][0])] * 2


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.data_mesh()


# ---------------------------------------------------------------------------
# the sharded engine (tests/test_multichip.py:33, :52, :365)
# ---------------------------------------------------------------------------


def _jax_engine_probs(trees, audio, mode="gated", num_slices=1):
    import jax
    import jax.numpy as jnp

    t1, t2, _ = trees
    cfg = jast.ASTConfig(**SMALL)
    s1 = JC.StageSpec(jax.tree.map(jnp.asarray, t1), cfg, -1.15, 3.53,
                      ("Idle", "Swallow"))
    s2 = JC.StageSpec(jax.tree.map(jnp.asarray, t2), cfg, -0.9, 2.8,
                      ("Healthy", "Zenker"))
    mesh = jmesh.data_mesh(jax.devices(), num_slices=num_slices)
    engine = JC.TwoStageEngine(s1, s2, JC.CascadeConfig(
        batch_size=16, dtype=jnp.float32, stage2_mode=mode), mesh=mesh)
    return engine.window_probs(audio)


@pytest.mark.parametrize("key,mode,num_slices", [
    ("engine_gated", "gated", 1), ("engine_all", "all", 1),
    ("engine_dcn", "gated", 2)])
def test_sharded_engine_matches_jax(trees, inputs, two_ranks, four_ranks,
                                    key, mode, num_slices):
    """The port's engine over two ranks (over 2 x 2 for the dcn mesh)
    against JAX's TwoStageEngine on its 8-device mesh, and against the
    port's single-device engine on the same parameters."""
    audio, _ = inputs
    got = _ok({**two_ranks, **four_ranks}[key])
    want1, want2 = _jax_engine_probs(trees, audio, mode, num_slices)
    np.testing.assert_allclose(got["p1"], want1, atol=TOL)
    np.testing.assert_allclose(got["p2"], want2, atol=TOL)
    single = C.TwoStageEngine(*_port_specs(trees), _engine_cfg(mode),
                              device="cpu")
    p1, p2 = single.window_probs(audio)
    np.testing.assert_allclose(got["p1"], p1, atol=TOL)
    np.testing.assert_allclose(got["p2"], p2, atol=TOL)
    assert got["mesh_shape"] == ((2,) if num_slices == 1 else (2, 2))


def test_batch_size_must_divide(trees, two_ranks):
    """tests/test_multichip.py:52: a chunk that does not divide over the
    mesh raises JAX's "divide" error, in both packages."""
    import jax

    status, msg = two_ranks["engine_13"]
    assert status == "error" and "divide" in msg
    t1, t2, _ = trees
    cfg = jast.ASTConfig(**SMALL)
    s1 = JC.StageSpec(t1, cfg, -1.15, 3.53, ("Idle", "Swallow"))
    s2 = JC.StageSpec(t2, cfg, -0.9, 2.8, ("Healthy", "Zenker"))
    with pytest.raises(ValueError, match="divide"):
        JC.TwoStageEngine(s1, s2, JC.CascadeConfig(batch_size=13),
                          mesh=jmesh.data_mesh(jax.devices()[:2]))


def test_streaming_refuses_a_mesh(trees):
    """infer/streaming.py is single-device, as JAX's (streaming.py:94)."""
    from zenker_audio_detection_tpu_torch.infer import streaming

    engine = C.TwoStageEngine(*_port_specs(trees), _engine_cfg(),
                              device="cpu")
    engine.mesh = object()
    with pytest.raises(NotImplementedError, match="single-device"):
        streaming.StreamingCascade(engine)


# ---------------------------------------------------------------------------
# the data-parallel step (tests/test_multichip.py:61, :328)
# ---------------------------------------------------------------------------


def _jax_loss(name):
    from zenker_audio_detection_tpu.train import losses as jl

    loss_name, kw = LOSSES[name]
    fn = {"stage1": jl.stage1_loss, "focal": jl.stage2_focal_loss,
          "wce": jl.stage2_weighted_ce}[loss_name]
    return functools.partial(fn, **kw)


def _jax_step(trees, feats, name, num_slices=None, rows=16):
    """JAX's step on its 8-device mesh (None: one device): (loss, grads,
    params) as flat numpy."""
    import jax
    import jax.numpy as jnp

    from zenker_audio_detection_tpu.models import convert as jconvert
    from zenker_audio_detection_tpu.train import optim, steps

    cfg = jast.ASTConfig(**STEP)
    tx = optim.make_optimizer(LR, 10, 0.1, 0.01)
    params = jax.tree.map(jnp.array, trees[2])
    opt_state = tx.init(params)
    f, y = feats[:rows], LABELS[:rows].astype(np.int32)
    if num_slices:
        mesh = jmesh.data_mesh(jax.devices(), num_slices=num_slices)
        params = jmesh.replicate(params, mesh)
        opt_state = jmesh.replicate(opt_state, mesh)
        f, y = jmesh.shard_batch(f, mesh), jmesh.shard_batch(y, mesh)
    loss_fn = steps.make_loss_fn(cfg, _jax_loss(name), dtype=jnp.float32)
    (_, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, f, y)
    ts = steps.make_train_step(tx, cfg, _jax_loss(name), dtype=jnp.float32)
    new, _, loss, _ = ts(params, opt_state, f, y)
    flat = jconvert._flatten_tree

    def host(t):
        return {k: np.asarray(v) for k, v in flat(t).items()}
    return float(loss), host(grads), host(new)


def _compare_step(got, want_loss, want_grads, want_params):
    assert abs(got["loss"] - want_loss) < TOL, (got["loss"], want_loss)
    grads = convert._flatten_tree(got["grads"])
    params = convert._flatten_tree(got["params"])
    assert sorted(grads) == sorted(want_grads)
    for k in want_grads:
        scale = max(1.0, float(np.abs(want_grads[k]).max()))
        np.testing.assert_allclose(grads[k], want_grads[k], atol=TOL * scale,
                                   err_msg=k)
        np.testing.assert_allclose(params[k], want_params[k],
                                   atol=LR if k == NOISE_LEAF else TOL,
                                   err_msg=k)
    assert got["replica_diff"] == 0.0


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_dp_step_matches_jax_sharded_step(trees, inputs, two_ranks, name):
    """One data-parallel step over two ranks against JAX's GSPMD step on
    8 devices, for each stage loss, on a batch whose first shard's label
    mean lies below 0.5 while the batch's does not: the loss is the global
    batch's, not a mean of per-shard losses."""
    _, feats = inputs
    _compare_step(_ok(two_ranks[f"step_{name}"]),
                  *_jax_step(trees, feats, name, num_slices=1))


def test_straddling_batch_discriminates(trees, inputs, two_ranks):
    """The batch of the step tests does tell a global loss from per-shard
    ones: the mean of the two shards' focal and weighted CE losses is far
    from the global value the port reached."""
    from zenker_audio_detection_tpu_torch.train import losses

    assert LABELS[:8].mean() < 0.5 <= LABELS.mean()
    got = _ok(two_ranks["step_focal"])
    logits = torch.from_numpy(got["logits"])
    y = torch.from_numpy(LABELS)
    for name, fn in (("focal", losses.stage2_focal_loss),
                     ("wce", losses.stage2_weighted_ce)):
        whole = float(fn(logits, y, CLASS_W))
        halves = np.mean([float(fn(logits[s], y[s], CLASS_W))
                          for s in (slice(0, 8), slice(8, 16))])
        assert abs(whole - halves) > 1e-3, (name, whole, halves)
        if name == "focal":
            assert abs(whole - got["loss"]) < TOL


def test_dcn_mesh_step_matches_jax(trees, inputs, four_ranks):
    """tests/test_multichip.py:328: the step over a ("dcn", "data") 2 x 2
    mesh against JAX's over 2 slices of 4 devices."""
    _, feats = inputs
    got = _ok(four_ranks["step_dcn"])
    assert got["mesh_shape"] == (2, 2)
    _compare_step(got, *_jax_step(trees, feats, "focal", num_slices=2))


def test_tail_batch_runs_whole_on_every_rank(trees, inputs, two_ranks):
    """15 rows do not divide over two ranks: the batch runs whole on each
    (JAX runs it replicated), equal to JAX's single-device step."""
    _, feats = inputs
    _compare_step(_ok(two_ranks["tail_step"]),
                  *_jax_step(trees, feats, "stage1", None, rows=15))


def test_two_ranks_make_mesh_error(two_ranks):
    status, msg = two_ranks["too_many"]
    assert (status, msg) == ("ok", "requested 4 devices, only 2 visible")
