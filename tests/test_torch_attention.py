"""The port's mha_packed (its plain version, on the CPU) against the JAX
package's Pallas `mha_packed` in interpret mode, on the same seeded inputs.

Tolerances: f32 atol 2e-5, as tests/test_pallas_attention_packed.py holds
the Pallas kernel to the XLA reference (the two sum in different orders);
bf16 atol 2e-2: both sides round p and the output to bf16 (2^-8 relative),
and at these input scales the outputs are O(1).

Also what the wrapper and the kernel build refuse, checked without a card."""

import re

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.ops import attention as JA
from zenker_audio_detection_tpu_torch.ops import _cuda
from zenker_audio_detection_tpu_torch.ops import attention as A
from zenker_audio_detection_tpu_torch.ops import epilogue

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,NH,D,bq", [(2, 64, 4, 32, 64),
                                         (2, 300, 4, 32, 128),
                                         (1, 146, 12, 64, 128)])
def test_mha_packed_matches_jax(dtype, B, S, NH, D, bq):
    import jax.numpy as jnp

    rng = np.random.default_rng(S + NH)
    qkv = [rng.standard_normal((B, S, NH * D)).astype(np.float32)
           for _ in range(3)]
    want = np.asarray(JA.mha_packed(
        *(jnp.asarray(x, dtype) for x in qkv), num_heads=NH, block_q=bq,
        interpret=True)).astype(np.float32)
    tdtype = getattr(torch, dtype)
    got = A.mha_packed(*(torch.from_numpy(x).to(tdtype) for x in qkv),
                       num_heads=NH, block_q=bq)
    assert got.dtype == tdtype and got.shape == (B, S, NH * D)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


@pytest.mark.parametrize("bq", [1, 64, 96, 10**6])
def test_mha_packed_block_q_does_not_change_the_output(bq):
    """Any block_q >= 1 gives the output of the default 256, bit for bit,
    as every row's result is independent of how rows are blocked."""
    rng = np.random.default_rng(13)
    qkv = [torch.from_numpy(rng.standard_normal((2, 130, 128))
                            .astype(np.float32)) for _ in range(3)]
    torch.testing.assert_close(A.mha_packed(*qkv, num_heads=4, block_q=bq),
                               A.mha_packed(*qkv, num_heads=4),
                               atol=0, rtol=0)


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,kw,err", [
    ((_t(2, 8), _t(2, 8), _t(2, 8)), {"num_heads": 1}, ValueError),
    ((_t(1, 8, 64), _t(1, 9, 64), _t(1, 8, 64)), {"num_heads": 1}, ValueError),
    ((_t(1, 8, 64), _t(1, 8, 64), _t(1, 8, 64)), {"num_heads": 3}, ValueError),
    ((_t(1, 0, 64), _t(1, 0, 64), _t(1, 0, 64)), {"num_heads": 1}, ValueError),
    ((_t(1, 8, 64, dtype=torch.float16),) * 3, {"num_heads": 1}, TypeError),
    ((_t(1, 8, 64, dtype=torch.float64),) * 3, {"num_heads": 1}, TypeError),
    ((_t(1, 8, 64), _t(1, 8, 64, dtype=torch.bfloat16), _t(1, 8, 64)),
     {"num_heads": 1}, TypeError),
    ((_t(1, 8, 64, dtype=torch.int32),) * 3, {"num_heads": 1}, TypeError),
    ((_t(1, 8, 64),) * 3, {"num_heads": 1, "block_q": 0}, ValueError),
    ((_t(1, 8, 64),) * 3, {"num_heads": 1, "block_q": -64}, ValueError),
])
def test_mha_packed_rejects_bad_inputs(args, kw, err):
    with pytest.raises(err):
        A.mha_packed(*args, **kw)


def test_kernel_checks_head_width_and_layout():
    """What the CUDA path refuses, checked without a card."""
    q = _t(1, 8, 192)
    with pytest.raises(ValueError, match="head widths"):
        A._check_kernel(q, q, q, num_heads=4)   # D = 48
    strided = torch.zeros(1, 128, 8).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        A._check_kernel(strided, strided, strided, num_heads=2)
    A._check_kernel(q, q, q, num_heads=6)       # D = 32 passes
    A._check_kernel(q, q, q, num_heads=3)       # D = 64 passes


def test_kernel_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    lib = _cuda.library_path("attention_ws")
    assert lib.parent == _cuda.BUILD_DIR
    assert lib.name.startswith("attention_ws_") and lib.suffix == ".so"
    assert lib == _cuda.library_path("attention_ws")  # stable for one source
    assert set(_cuda._ENTRY_POINTS) == {
        p.stem for p in _cuda.CSRC.glob("*.cu")}
    # the key covers the headers a source includes: an edited header
    # rebuilds every source that includes it, and an edited source only
    # itself
    assert [p.name for p in _cuda._sources("attention_pipelined")] == [
        "attention_pipelined.cu", "flash_common.cuh", "hopper.cuh"]
    assert [p.name for p in _cuda._sources("attention_ws")] == [
        "attention_ws.cu", "flash_common.cuh", "hopper.cuh"]
    for path in _cuda.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    names = list(_cuda._ENTRY_POINTS)
    before = {name: _cuda.library_path(name) for name in names}
    assert before["attention_ws"] == lib  # the same bytes, the same key
    header = tmp_path / "flash_common.cuh"
    including = [name for name in names
                 if header in _cuda._sources(name)]
    # the attention sources include it, the trunk's epilogues do not
    assert including == ["attention_bwd", "attention_pipelined",
                         "attention_ws"]
    header.write_text(header.read_text() + "// edited\n")
    after = {name: _cuda.library_path(name) for name in names}
    assert [name for name in names if after[name] != before[name]] == \
        including
    source = tmp_path / "attention_bwd.cu"
    source.write_text(source.read_text() + "// edited\n")
    again = {name: _cuda.library_path(name) for name in names}
    assert [name for name in names if again[name] != after[name]] == [
        "attention_bwd"]


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda._nvcc()


def test_mha_packed_refuses_other_devices():
    q = torch.zeros(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        A.mha_packed(q, q, q, num_heads=1)


@pytest.mark.parametrize("kind", ["mha_packed", "mha_packed_lse",
                                  "mha_batched_heads", "mha", "mha_pairs",
                                  "mha_qblock"])
def test_launch_reads_the_sm_count_once_per_device(monkeypatch, kind):
    """The persistent grid is sized by the card's SM count, read from the
    device properties once per device and not on every call (checked with
    the properties and the C call stood in for). `mha`, `mha_pairs` and
    `mha_qblock` call `mha_packed`'s kernel through entry points of their
    own in csrc/attention_ws.cu, with the walk's int arguments."""
    reads, calls = [], []

    class Props:
        multi_processor_count = 7

    def props(device):
        reads.append(device)
        return Props()

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(_cuda, "run", lambda source, fn, tensors, ints,
                        device: calls.append((source, fn, len(tensors), ints)))
    A.sm_count.cache_clear()
    try:
        B, S, NH, D = 3, 300, 4, 32
        q = torch.zeros(B, S, NH * D, dtype=torch.bfloat16)
        lse = torch.zeros(B, NH, S) if kind == "mha_packed_lse" else None
        # mha's and mha_qblock's (B, S, NH, D) tensors, the others' packed
        # (B, S, H)
        x = q.view(B, S, NH, D) if kind in ("mha", "mha_qblock") else q
        for _ in range(3):
            A._launch(kind, x, x, x, B, S, NH, D, lse=lse)
    finally:
        A.sm_count.cache_clear()
    assert reads == [q.device]
    geo = A.launch_geometry(kind, B, S, NH, D, 2, sms=7)
    # 7 SMs x ctas_per_sm CTAs, fewer than the 36 items
    assert geo.grid == (7 * geo.ctas_per_sm, 1, 1)
    source = "attention_pipelined" if kind == "mha_batched_heads" else \
        "attention_ws"
    assert calls == [(source, f"{kind}_bf16", 4 if lse is None else 5,
                      (B, S, NH, D, *geo.grid, geo.threads, geo.smem))] * 3


# `extern "C" int <name>(` written out, and the macros whose body defines
# `extern "C" int <their first parameter>(`, with their uses
_EXTERN = re.compile(r'extern "C" int (\w+)\(')
_DEFINE = re.compile(r"^#define (\w+)\((\w+)[^)]*\)((?:.*\\\n)*.*)$",
                     re.MULTILINE)


def _exported(text: str) -> set:
    """The C names a source exports: each `extern "C" int <name>(` outside
    a macro, and the first argument of each use of a macro that defines
    `extern "C" int <its first parameter>(`."""
    macros = {name for name, first, body in _DEFINE.findall(text)
              if f'extern "C" int {first}(' in body}
    rest = _DEFINE.sub("", text)
    names = set(_EXTERN.findall(rest))
    for macro in macros:
        names |= set(re.findall(rf"^{macro}\((\w+)", rest, re.MULTILINE))
    return names


def test_exported_reads_functions_and_macro_uses():
    text = ('#define E(name, T)                  \\\n'
            '  extern "C" int name(int x) {     \\\n'
            '    return 0;                      \\\n'
            '  }\n'
            '#define ARGS(x) x, x\n'
            'E(a_bf16, float)\n'
            'E(a_f32, float)\n'
            'extern "C" int b_bf16(int D) { return D; }\n')
    assert _exported(text) == {"a_bf16", "a_f32", "b_bf16"}


@pytest.mark.parametrize("source", sorted(_cuda._ENTRY_POINTS))
def test_every_c_entry_point_is_bound(source):
    """The names csrc/<source>.cu exports are the ones ops/_cuda.py binds:
    a C name without a binding, or a binding without a C name, fails here
    and not first on the card."""
    text = (_cuda.CSRC / f"{source}.cu").read_text()
    assert _exported(text) == set(_cuda._ENTRY_POINTS[source])


# every kind `_launch` takes
_LAUNCHED = A._PIPELINED


@pytest.mark.parametrize("itemsize,source", [(2, "attention_ws"),
                                             (4, "attention_pipelined")])
def test_qblock_c_names_are_bound(itemsize, source):
    """mha_qblock launches mha_packed's instances through C names of its
    own: `mha_qblock_bf16` in csrc/attention_ws.cu, `mha_qblock_f32` in
    csrc/attention_pipelined.cu, each with its occupancy twin, exported and
    bound, and counted apart from mha_packed's."""
    suffix = "bf16" if itemsize == 2 else "f32"
    assert A._source("mha_qblock", itemsize) == source
    assert A._source("mha_packed", itemsize) == source
    exported = _exported((_cuda.CSRC / f"{source}.cu").read_text())
    for name in (f"mha_qblock_{suffix}", f"mha_qblock_occupancy_{suffix}"):
        assert name in exported and name in _cuda._ENTRY_POINTS[source]
    assert _cuda._ENTRY_POINTS[source][f"mha_qblock_{suffix}"] == \
        _cuda._ENTRY_POINTS[source][f"mha_packed_{suffix}"]


@pytest.mark.parametrize("itemsize,suffix", [(2, "bf16"), (4, "f32")])
@pytest.mark.parametrize("kind", _LAUNCHED)
def test_every_wrapper_calls_a_bound_entry_point(kind, itemsize, suffix):
    """What a wrapper calls, f"{kind}_{dtype}" (and for the persistent and
    pipelined kinds their occupancy twin), is exported by and bound for the
    source `_source` names."""
    source = A._source(kind, itemsize)
    names = [f"{kind}_{suffix}"]
    if kind in A._PIPELINED:
        names.append(f"{kind}_occupancy_{suffix}")
    exported = _exported((_cuda.CSRC / f"{source}.cu").read_text())
    for name in names:
        assert name in exported and name in _cuda._ENTRY_POINTS[source]


def test_every_bound_entry_point_is_called():
    """Each bound C name is one a wrapper calls: no entry point is left
    behind by a kind that moved to another source."""
    called = {(A._source(kind, itemsize), f"{kind}{part}_{suffix}")
              for kind in _LAUNCHED for itemsize, suffix in ((2, "bf16"),
                                                             (4, "f32"))
              for part in ("", "_occupancy")
              if part == "" or kind in A._PIPELINED}
    called |= {("attention_bwd", f"mha_packed_bwd_{part}_{suffix}")
               for part in ("dq", "dkdv") for suffix in ("bf16", "f32")}
    called |= {("attention_bwd", f"mha_packed_bwd_{part}_occupancy_bf16")
               for part in ("dq", "dkdv")}
    # BEATs's attention: bf16 only, on the walk's source
    called |= {("attention_ws", f"mha_packed_relpos{part}_bf16")
               for part in ("", "_occupancy")}
    # the AST trunk's elementwise epilogues (ops/epilogue.py), both dtypes
    called |= {(epilogue.SOURCE, f"{name}_{suffix}")
               for name in ("qkv_bias", "bias_gelu", "residual_layer_norm",
                            "layer_norm")
               for suffix in ("bf16", "f32")}
    bound = {(source, name) for source, names in _cuda._ENTRY_POINTS.items()
             for name in names}
    assert bound == called


def test_chip_smoke_counts_every_counted_wrapper():
    """chip_smoke.py zeroes and reads the launches of every wrapper that
    counts them, so a kernel put on a path is held to its count on the
    card."""
    import chip_smoke

    counted = {name for name, fn in vars(A).items()
               if callable(fn) and hasattr(fn, "launches")}
    assert set(chip_smoke.KERNELS) == counted
