"""Start the ranks of a multi-process STADI run: one process per rank, a
``torch.distributed`` process group over a localhost rendezvous, and the
rank-to-device map.

The JAX package needs no counterpart: ``shard_map`` runs one program over
the devices of a mesh inside one process, while ``torch.distributed`` runs
one process per rank, and something has to start them.

    results = ranks.spawn(fn, world=2, device_type="cuda", args=(spec,))

``fn(ctx, *args)`` runs in every rank with ``ctx`` a :class:`RankContext`;
what it returns (anything picklable, tensors included) comes back in rank
order, pickled by value: torch's own queue reduction would hand a tensor's
storage over through the rank process, which may have exited by the time
the parent reads it. Processes start with the ``spawn`` method (CUDA does not
survive ``fork``), so ``fn`` must be importable by name.

The backend rule: NCCL on CUDA, gloo on the CPU, unless the caller names one.
NCCL takes one card per rank and refuses more ranks than cards; gloo on
CUDA runs only when asked for by name, and then ranks beyond the card count
share the cards in order (rank r on card r mod cards), with gloo staging each
collective through host memory. Under gloo, CUDA tensors go through
all_gather, all_reduce, broadcast and all_to_all_single, but not through the
point-to-point send/recv, so the executors use only the former. Ranks that
share a card take turns on its SMs: their wall times are not a multi-GPU
makespan.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What a rank knows about itself."""
    rank: int
    world: int
    device: torch.device


def free_port() -> int:
    """A free localhost TCP port, from binding port 0 (the OS picks one, so
    runs started side by side do not collide on a fixed port)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def resolve_backend(device_type: str, world: int,
                    dist_backend: Optional[str] = None) -> str:
    """The backend rule of the module docstring. Raises before any process
    group exists when the asked-for layout cannot run."""
    if dist_backend is not None and dist_backend not in BACKENDS:
        raise ValueError(f"unknown dist backend {dist_backend!r}; one of "
                         f"{BACKENDS}")
    if device_type == "cpu":
        if dist_backend == "nccl":
            raise ValueError("NCCL needs CUDA devices; CPU ranks run gloo")
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"no rank layout for device type {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the ranks run on the GPU unless "
                           "the caller asks for the CPU")
    backend = dist_backend or "nccl"
    cards = torch.cuda.device_count()
    if backend == "nccl" and world > cards:
        raise ValueError(
            f"NCCL takes one card per rank: {world} ranks need {world} cards, "
            f"this machine has {cards}; pass --dist-backend gloo (Python: "
            "dist_backend='gloo') to share the cards between ranks, with "
            "collectives staged through host memory")
    return backend


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank r's device: card r mod cards on CUDA, the CPU otherwise."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _rank_main(rank: int, world: int, port: int, backend: str,
               device_type: str, fn: Callable, args: Sequence, results) -> None:
    import torch.distributed as dist
    try:
        device = rank_device(rank, device_type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:                              # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank, **kw)
        try:
            out = fn(RankContext(rank, world, device), *args)
            results.put((rank, "ok", pickle.dumps(out)))
        finally:
            dist.destroy_process_group()
    except Exception:                      # reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))


def spawn(fn: Callable, world: int, *, device_type: str = "cuda",
          dist_backend: Optional[str] = None, args: Sequence = (),
          timeout: float = 900.0) -> List[Any]:
    """Run ``fn(ctx, *args)`` on ``world`` ranks and return their results in
    rank order. Raises with the first failing rank's traceback; every
    process it started is stopped before it returns or raises.

    On CUDA the kernels' library is built here, once, before the ranks
    start: they then load the finished build instead of each running nvcc.
    """
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    backend = resolve_backend(device_type, world, dist_backend)
    if device_type == "cuda":
        from repro_torch.kernels import ops
        ops.load_library()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, backend, device_type, fn,
                               tuple(args), results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        out: List[Any] = [None] * world
        deadline = time.monotonic() + timeout
        done = 0
        while done < world:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:                   # died without reporting (a signal)
                    raise RuntimeError(f"rank {dead[0]} of {world} exited with "
                                       f"code {procs[dead[0]].exitcode}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no result from the ranks within "
                                       f"{timeout} s") from None
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = pickle.loads(value)
            done += 1
        for p in procs:
            p.join(timeout=60)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
