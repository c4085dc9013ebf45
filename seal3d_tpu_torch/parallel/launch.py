"""Start `world` ranks of one function and collect what they return.

    results = launch(fn, world, args, backend="gloo", device="cpu")

Each rank is a process spawned by torch.multiprocessing; it joins a process
group through a `FileStore` in a temporary directory (no TCP port, so runs
in parallel cannot collide), calls fn(device, *args) and hands back its
return value (saved with torch.save; move tensors to the CPU first). The
rank's device is the CPU, or under NCCL card `rank`, or under gloo card
`rank % device_count` (so two or four gloo ranks share one card).

NCCL refuses two ranks on one card: a world above the card count under
NCCL raises `SharedDeviceError` here, and nothing switches to gloo. The
launch has a timeout of its own: ranks still running at its end (a hung
collective) are killed and `RankTimeout` is raised; a rank that raises
ends the launch with that rank's traceback. `fn` must be importable by
the spawned interpreter (a module-level function of a package module).
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch


class SharedDeviceError(RuntimeError):
    """NCCL was asked for more ranks than there are cards."""


class RankTimeout(RuntimeError):
    """Ranks did not finish within the launch's timeout."""


def rank_device(rank: int, backend: str, device: str) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, fn, args, world, backend, device, tmp, timeout):
    import torch.distributed as dist

    torch.set_num_threads(1)    # ranks share the host's cores
    dev = rank_device(rank, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    # a rank's own collective timeout outlasts the launch's, so that a hang
    # ends as RankTimeout, not as whichever rank's error came first
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout + 60))
    try:
        result = fn(dev, *args)
        torch.save(result, os.path.join(tmp, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, args=(), backend: str = "gloo",
           device: str = "cpu", timeout: float = 120.0) -> list:
    """fn(device, *args) on `world` spawned ranks -> their return values in
    rank order."""
    import torch.multiprocessing as mp

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r} (gloo or nccl)")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"unknown device {device!r} (cpu or cuda)")
    if backend == "nccl":
        cards = torch.cuda.device_count() if device == "cuda" else 0
        if world > cards:
            raise SharedDeviceError(
                f"NCCL needs a card per rank: {world} ranks, {cards} "
                f"card(s); run several ranks on one card over gloo")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, world, backend, device, tmp,
                              timeout),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise RankTimeout(
                    f"{fn.__name__}: {world} {backend} ranks did not finish "
                    f"within {timeout:.0f} s (a hung collective?)")
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"),
                           weights_only=False) for r in range(world)]
