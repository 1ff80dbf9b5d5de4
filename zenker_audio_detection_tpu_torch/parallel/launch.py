"""Start the ranks of a process group: how the port runs what JAX runs in
one process.

JAX drives every device of a mesh from one process; `torch.distributed`
needs one process per rank. `spawn(fn, args, nprocs, device)` starts
`nprocs` workers with the `spawn` start method, joins them into one process
group over a `FileStore` in a fresh temporary directory (no TCP port, so
concurrent runs cannot collide), runs `fn(*args)` in each and returns rank
0's result. A CLI asks `should_spawn` first: with `--num-devices N > 1`
and no process group it hands itself to `spawn`; under `torchrun`, whose
environment names the group, it joins that group and runs in place.

  * Backends: NCCL when the ranks run on cards, each rank on `cuda:<rank>`;
    gloo on the CPU. A caller may name gloo for ranks that share one card
    (`device="cuda:0"`): NCCL refuses two ranks on one card.
  * Rank 0 prints; the other ranks' standard output goes to /dev/null.
    Rank 0 writes the outputs (the callers check `mesh.is_main`).
  * A failing rank stops the others; the exception (or `SystemExit`)
    reaches the caller, so a CLI's exit code is nonzero.
  * Nothing drops to fewer processes or to the CPU: too few cards raise
    before anything starts.
  * With CUDA ranks the kernels are built here, once, before the ranks
    start (each would otherwise run `nvcc` itself).

The workers import only torch, numpy and this package, and run one
intra-op thread each.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist

from . import mesh as pmesh

# how long a collective may wait for a rank before the group gives up: a
# fold group of run_all_folds that serves one fold fewer than another
# waits one fold's serving at the final gather
TIMEOUT_S = 3600


def _target(fn) -> str:
    """`module:qualname` of `fn`, importable in a fresh interpreter (a
    module run with `python -m` is `__main__` here and its real name in
    the child)."""
    module = fn.__module__
    if module == "__main__":
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        if spec is None:
            raise ValueError(f"{fn.__qualname__} lives in a script; the "
                             "ranks need a function of an importable module")
        module = spec.name
    return f"{module}:{fn.__qualname__}"


def _resolve(target: str):
    module, qualname = target.split(":")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def backend_for(device) -> str:
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def _rank_device(device: str, rank: int) -> str:
    """`cuda` means one card per rank; an indexed card is shared by every
    rank; the CPU is the CPU."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return f"cuda:{rank}"
    return str(d)


def _worker(rank: int, world: int, workdir: str, backend: str, device: str,
            target: str, args: tuple) -> None:
    torch.set_num_threads(1)
    rank_device = _rank_device(device, rank)
    os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank),
                       "WORLD_SIZE": str(world),
                       pmesh.RANK_DEVICE_ENV: rank_device})
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    if rank_device.startswith("cuda"):
        torch.cuda.set_device(torch.device(rank_device))
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = _resolve(target)(*args)
        if rank == 0:
            with open(os.path.join(workdir, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
    except SystemExit as e:
        with open(os.path.join(workdir, f"exit{rank}.pkl"), "wb") as f:
            pickle.dump(e.code, f)
        raise
    except BaseException:
        with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        sys.stdout.flush()
        dist.destroy_process_group()


def spawn(fn, args: tuple = (), nprocs: int = 2, device="cuda",
          backend: str | None = None):
    """Run `fn(*args)` on `nprocs` ranks (module docstring) and return rank
    0's result. `device`: "cuda" (rank r on cuda:r, NCCL by default),
    "cuda:<i>" (every rank on that card, which needs `backend="gloo"`) or
    "cpu" (gloo)."""
    device = str(torch.device(device))
    backend = backend or backend_for(device)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; name the CPU to run "
                               "the ranks there")
        if torch.device(device).index is None:
            pmesh.check_visible(nprocs, device)
        elif backend == "nccl" and nprocs > 1:
            raise ValueError("NCCL refuses two ranks on one card: name "
                             "backend='gloo' to share a card")
        from ..ops import _cuda

        _cuda.build_all()
    workdir = tempfile.mkdtemp(prefix="zenker_ranks_")
    try:
        sys.stdout.flush()
        try:
            torch.multiprocessing.start_processes(
                _worker, args=(nprocs, workdir, backend, device,
                               _target(fn), tuple(args)),
                nprocs=nprocs, join=True, start_method="spawn")
        except Exception as exc:
            _reraise(workdir, nprocs, exc)
        with open(os.path.join(workdir, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _reraise(workdir: str, nprocs: int, exc: Exception):
    """The first failing rank's SystemExit, or its traceback in a
    RuntimeError."""
    for r in range(nprocs):
        path = os.path.join(workdir, f"exit{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                raise SystemExit(pickle.load(f)) from exc
    for r in range(nprocs):
        path = os.path.join(workdir, f"error{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                raise RuntimeError(f"rank {r} failed:\n{f.read()}") from exc
    raise exc


def join_torchrun_group(device) -> None:
    """Under `torchrun` (its environment names the group) join the process
    group, each rank on cuda:<LOCAL_RANK> or the CPU."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    device = torch.device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        os.environ[pmesh.RANK_DEVICE_ENV] = f"cuda:{local}"
    else:
        os.environ[pmesh.RANK_DEVICE_ENV] = "cpu"
    dist.init_process_group(backend_for(device), init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def should_spawn(num_devices: int | None, device="cuda") -> bool:
    """Whether a CLI asked for `num_devices` must start its ranks: more
    than one device and no process group yet (under torchrun the group is
    joined here and the CLI runs in place)."""
    if not num_devices or num_devices <= 1:
        return False
    join_torchrun_group(device)
    return not dist.is_initialized()
