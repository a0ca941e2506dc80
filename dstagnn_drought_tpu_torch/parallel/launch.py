"""Run a function on P ranks of one host: spawned processes joined by a
file rendezvous.

``torchrun --nproc_per_node=P -m dstagnn_drought_tpu_torch.cli.train ...``
is the way to train on P ranks. :func:`spawn` is the in-process variant the
tests and the chip smoke use: it starts P fresh interpreters (``spawn``, so
nothing of the caller's threads is inherited), initialises each with
``init_method=file://…`` (no port to collide with; with ``init=False`` the
function initialises the group itself, as a ``torchrun`` entry point does
from its environment), runs ``fn(rank, *args)`` with one intra-op thread,
and returns every rank's result. A rank that
raises, or a run that outlives ``timeout``, kills every rank and raises, so
a hung collective fails the caller instead of hanging it.
"""
from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _worker(fn, rank, world, init_file, args, results):
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    try:
        if init_file is not None:
            dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                    world_size=world, rank=rank)
        out = fn(rank, *args)
        results.put((rank, None, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, timeout: float = 120.0,
          init_dir: str | None = None, init: bool = True) -> list:
    """``[fn(0, *args), …, fn(P-1, *args)]`` from P gloo ranks (the backend
    of the CPU and of ranks that share a card). ``fn`` must be importable by
    name (a module-level function)."""
    ctx = mp.get_context("spawn")
    own_dir = init_dir is None
    init_dir = tempfile.mkdtemp(prefix="rendezvous_") if own_dir else init_dir
    init_file = os.path.join(init_dir, f"init_{os.getpid()}_{time.monotonic_ns()}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, r, world_size, init_file if init else None, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                rank, err, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} (rank, exit code) of {world_size} "
                                       "exited without a result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish within {timeout} s "
                                       f"(finished: {sorted(out)})") from None
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{err}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(out) == world_size else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        if own_dir:
            shutil.rmtree(init_dir, ignore_errors=True)
        elif os.path.exists(init_file):
            os.remove(init_file)
    return [out[r] for r in range(world_size)]
