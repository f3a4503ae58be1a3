"""A pool of ranks: N spawned processes in one gloo process group.

:class:`RankPool` starts ``world`` processes once (rendezvous through a
file under a temporary directory, so no TCP port is fixed), and
:meth:`RankPool.run` calls one module-level function on every rank at once,
returning each rank's result.  The group outlives the calls, so a caller
pays the start-up (and DTensor's per-shape caches) once for many runs.

By default the ranks share the visible cards round-robin (``device="cpu"``
makes each rank a CPU process); two ranks may share one card, which
NCCL refuses and gloo accepts (it moves CUDA tensors through the host).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["RankPool"]


def _serve(rank: int, world: int, store: str, device: str, threads: int,
           timeout_s: float, conn) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        conn.send(("ok", None))
    except Exception:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg is None:
            break
        fn, args, kwargs = msg
        try:
            conn.send(("ok", fn(*args, **kwargs)))
        except Exception:  # reported to the caller; the rank serves on
            conn.send(("err", traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` ranks in one gloo group; see the module doc.

    ``device``: "cuda" (the ranks' cards round-robin) or "cpu".
    ``threads``: intra-op threads per rank (0 leaves torch's default).
    ``timeout_s``: the group's collective timeout, and how long a call
    waits for the ranks' answers before the pool is torn down."""

    def __init__(self, world: int, *, device: str = "cuda", threads: int = 1,
                 timeout_s: float = 300.0):
        self.world = world
        self.timeout_s = timeout_s
        self._dir = tempfile.mkdtemp(prefix="rankpool-")
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        store = os.path.join(self._dir, "store")
        for rank in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve, daemon=True,
                            args=(rank, world, store, device, threads, timeout_s, child))
            p.start()
            self._conns.append(parent)
            self._procs.append(p)
        self._collect("start")

    def _collect(self, what: str) -> list:
        from multiprocessing.connection import wait

        pending = dict(enumerate(self._conns))
        out, errors = [None] * self.world, []
        deadline = time.monotonic() + self.timeout_s
        while pending:
            ready = wait(list(pending.values()), max(deadline - time.monotonic(), 0.0))
            if not ready:
                self.close()
                # A rank that failed leaves the others waiting in a
                # collective: its traceback is the one to read.
                raise TimeoutError(f"ranks {sorted(pending)} gave no answer to {what} "
                                   f"within {self.timeout_s} s\n" + "\n".join(errors))
            for rank in [r for r, c in pending.items() if c in ready]:
                status, value = pending.pop(rank).recv()
                if status == "err":
                    errors.append(f"rank {rank}:\n{value}")
                out[rank] = value
        if errors:
            raise RuntimeError(f"{what} failed on {len(errors)} of {self.world} "
                               "ranks\n" + "\n".join(errors))
        return out

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank at once (``fn`` must be a
        module-level function); returns the results by rank, or raises
        with every failed rank's traceback."""
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", str(fn)))

    def close(self) -> None:
        """Stop every rank (those that do not stop are killed)."""
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        self._conns, self._procs = [], []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
