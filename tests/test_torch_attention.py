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
    `mha_qblock` launch `mha_packed`'s kernel through its symbol in
    csrc/attention_ws.cu, with the walk's int arguments."""
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
    source, symbol = {
        "mha_batched_heads": ("attention_pipelined", "mha_batched_heads_bf16"),
        "mha_packed_lse": ("attention_ws", "mha_packed_lse_bf16"),
    }.get(kind, ("attention_ws", "mha_packed_bf16"))
    assert calls == [(source, symbol, 4 if lse is None else 5,
                      (B, S, NH, D, *geo.grid, geo.threads, geo.smem))] * 3


# (entry point, dtype) -> (csrc/ source, C launch symbol, geometry family)
# of the kernel it launches: mha, mha_pairs and mha_qblock compute
# mha_packed's function on its memory and launch its kernel, in f32
# mha_batched_heads'
ROUTES = {
    **{(entry, "bf16"): ("attention_ws", "mha_packed_bf16", "ws")
       for entry in ("mha_packed", "mha", "mha_pairs", "mha_qblock")},
    **{(entry, "f32"): ("attention_pipelined", "mha_batched_heads_f32",
                        "batched")
       for entry in ("mha_packed", "mha", "mha_pairs", "mha_qblock",
                     "mha_batched_heads")},
    ("mha_packed_lse", "bf16"): ("attention_ws", "mha_packed_lse_bf16", "ws"),
    ("mha_packed_lse", "f32"): ("attention_pipelined", "mha_packed_lse_f32",
                                "batched"),
    ("mha_packed_relpos", "bf16"): ("attention_ws", "mha_packed_relpos_bf16",
                                    "ws"),
    ("mha_batched_heads", "bf16"): ("attention_pipelined",
                                    "mha_batched_heads_bf16", "batched"),
    **{("mha_fused", dtype): ("attention_pipelined", f"mha_fused_{dtype}",
                              "fused") for dtype in ("bf16", "f32")},
    **{(f"mha_packed_bwd_{part}", dtype): (
        "attention_bwd", f"mha_packed_bwd_{part}_{dtype}", "bwd")
       for part in ("dq", "dkdv") for dtype in ("bf16", "f32")},
}
# an entry point of each geometry family, whose launch the others share
_FAMILY = {"ws": ("mha_packed", 2), "batched": ("mha_batched_heads", None),
           "fused": ("mha_fused", None)}


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    kernel path (whose launch the test stands in for)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("kind,dtype", sorted(ROUTES))
def test_each_entry_point_launches_the_kernel_of_the_table(monkeypatch, kind,
                                                           dtype):
    """Each wrapper on the card launches the compiled kernel KERNEL_OF gives
    it: that source and C symbol, with the int arguments of its geometry
    family's launch, counted in its own `.launches` alone (checked with
    `_cuda.run` and `sm_count` stood in for)."""
    source, symbol, family = ROUTES[kind, dtype]
    kernel = A.KERNEL_OF[kind, dtype]
    assert set(A.KERNEL_OF) == set(ROUTES)
    assert (kernel.source, kernel.launch, kernel.geometry) == ROUTES[kind,
                                                                     dtype]
    calls = []
    monkeypatch.setattr(A, "sm_count", lambda device: 7)
    monkeypatch.setattr(_cuda, "run", lambda source, fn, tensors, ints,
                        device: calls.append((source, fn, len(tensors), ints)))
    empty = torch.empty  # the lse and delta buffers, on "the card"
    monkeypatch.setattr(torch, "empty", lambda *shape, device=None, **kw:
                        empty(*shape, **kw))
    B, S, NH, D = 3, 300, 4, 32
    tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32

    def card(*shape, dt=tdtype):
        return torch.zeros(*shape, dtype=dt).as_subclass(_OnCard)

    x, stats = card(B, S, NH * D), card(B, NH, S, dt=torch.float32)
    heads = x.view(B, S, NH, D)
    run = {
        "mha_packed": lambda: A.mha_packed(x, x, x, num_heads=NH),
        "mha_pairs": lambda: A.mha_pairs(x, x, x, num_heads=NH),
        "mha_packed_lse": lambda: A.mha_packed_lse(x, x, x, num_heads=NH),
        "mha_packed_relpos": lambda: A.mha_packed_relpos(
            x, x, x, stats, card(NH, 2 * S - 1, dt=torch.float32),
            num_heads=NH),
        "mha_packed_bwd_dq": lambda: A.mha_packed_bwd_dq(
            x, x, x, x, stats, x, num_heads=NH),
        "mha_packed_bwd_dkdv": lambda: A.mha_packed_bwd_dkdv(
            x, x, x, x, stats, stats, num_heads=NH),
    }.get(kind, lambda: getattr(A, kind)(heads, heads, heads))
    counted = [name for name, fn in vars(A).items()
               if callable(fn) and hasattr(fn, "launches")]
    before = {name: getattr(A, name).launches for name in counted}
    run()
    moved = {name: getattr(A, name).launches - before[name]
             for name in counted}
    assert moved == {name: int(name == kind) for name in counted}
    itemsize = x.element_size()
    geo = A.launch_geometry(kind, B, S, NH, D, itemsize, sms=7)
    tensors = {"mha_packed_lse": 5, "mha_packed_relpos": 6,
               "mha_packed_bwd_dq": 8, "mha_packed_bwd_dkdv": 8}.get(kind, 4)
    assert calls == [(source, symbol, tensors,
                      (B, S, NH, D, *geo.grid, geo.threads, geo.smem))]
    if family in _FAMILY:
        like, size = _FAMILY[family]
        assert geo == A.launch_geometry(like, B, S, NH, D, size or itemsize,
                                        sms=7)


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


# the entry points `_launch` takes
_LAUNCHED = ("mha_packed", "mha_packed_lse", "mha", "mha_pairs", "mha_qblock",
             "mha_batched_heads", "mha_fused")


@pytest.mark.parametrize("itemsize,source", [(2, "attention_ws"),
                                             (4, "attention_pipelined")])
def test_qblock_c_names_are_bound(itemsize, source):
    """mha_qblock launches mha_packed's kernel through its symbols
    (`mha_packed_bf16`, in f32 `mha_batched_heads_f32`, and their
    occupancy symbols), exported and bound; no C name of its own is
    exported, so an alias coming back fails here. Its launches still count
    apart from mha_packed's."""
    dtype = "bf16" if itemsize == 2 else "f32"
    kernel = A.KERNEL_OF["mha_qblock", dtype]
    assert kernel == A.KERNEL_OF["mha_packed", dtype]
    assert kernel.source == source
    exported = _exported((_cuda.CSRC / f"{source}.cu").read_text())
    for name in (kernel.launch, kernel.occupancy):
        assert name in exported and name in _cuda._ENTRY_POINTS[source]
    assert not [name for name in exported
                if name.startswith("mha_qblock") or name == f"mha_{dtype}"]


@pytest.mark.parametrize("itemsize,suffix", [(2, "bf16"), (4, "f32")])
@pytest.mark.parametrize("kind", _LAUNCHED)
def test_every_wrapper_calls_a_bound_entry_point(kind, itemsize, suffix):
    """What a wrapper launches, the kernel `KERNEL_OF` gives it (its launch
    symbol and its occupancy symbol), is exported by and bound for that
    kernel's source."""
    kernel = A.KERNEL_OF[kind, suffix]
    assert A.kernel_of(kind, itemsize) == kernel
    exported = _exported((_cuda.CSRC / f"{kernel.source}.cu").read_text())
    for name in (kernel.launch, kernel.occupancy):
        assert name in exported and name in _cuda._ENTRY_POINTS[kernel.source]


def test_every_bound_entry_point_is_called():
    """Each bound C name is the launch or occupancy symbol of a kernel
    `KERNEL_OF` names, or an epilogue's: no symbol is left behind by a kind
    that moved to another kernel, and no alias of a kernel is bound."""
    called = {(kernel.source, name) for kernel in A.KERNEL_OF.values()
              for name in (kernel.launch, kernel.occupancy) if name}
    # the AST trunk's elementwise epilogues (ops/epilogue.py), both dtypes
    called |= {(epilogue.SOURCE, f"{name}_{suffix}")
               for name in ("qkv_bias", "bias_gelu", "residual_layer_norm",
                            "layer_norm")
               for suffix in ("bf16", "f32")}
    bound = {(source, name) for source, names in _cuda._ENTRY_POINTS.items()
             for name in names}
    assert bound == called
    # one launch and one occupancy symbol per compiled kernel: 22 in the
    # attention sources, the f32 backward having no occupancy symbol
    attention = {(s, n) for s, n in bound if s.startswith("attention")}
    assert len(attention) == 22
    assert len({kernel.launch for kernel in A.KERNEL_OF.values()}) == 12


def test_chip_smoke_counts_every_counted_wrapper():
    """chip_smoke.py zeroes and reads the launches of every wrapper that
    counts them, so a kernel put on a path is held to its count on the
    card."""
    import chip_smoke

    counted = {name for name, fn in vars(A).items()
               if callable(fn) and hasattr(fn, "launches")}
    assert set(chip_smoke.KERNELS) == counted
