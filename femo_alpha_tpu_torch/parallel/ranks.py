"""A fixed set of torch.distributed ranks, spawned once, that run jobs.

`RankPool(world, rendezvous_dir)` starts `world` processes (spawn) that
join one gloo group through a file:// rendezvous in `rendezvous_dir`,
make the subgroups named in `groups` (every rank, in the same order), and
then wait for jobs. `run({rank: Job or [Job, ...]})` hands each named
rank its jobs and returns their results; a job is a function named by
module and name,
called as fn(mesh, *args) with mesh a parallel.DeviceMesh of the job's
group (None: the whole world; "solo": one rank and no group; a tuple of
ranks: that subgroup). Jobs on different ranks run at the same time, so a
rank outside a subgroup can run another job meanwhile. A job that raises
returns its traceback and `run` raises it in the caller. `close()` ends
every process. gloo reduces CPU and CUDA tensors alike. `timeout` (s)
bounds each collective and each wait for a result, so a rank that fails
while the others wait in a collective ends the job instead of hanging.
"""

from __future__ import annotations

import importlib
import os
import traceback
from dataclasses import dataclass


@dataclass
class Job:
    module: str
    name: str
    args: tuple = ()
    group: object = None


def _serve(rank, world, init, groups, threads, timeout, cmd, res):
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from .product import DeviceMesh

    try:
        torch.set_num_threads(threads)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout))
        sub = {}
        for g in groups:
            pg = dist.new_group(list(g))
            if rank in g:
                sub[tuple(g)] = DeviceMesh(pg, len(g), list(g).index(rank))
        whole = DeviceMesh(None, world, rank)
        res.put((rank, True, "ready"))
    except BaseException:
        res.put((rank, False, traceback.format_exc()))
        return
    while True:
        jobs = cmd.get()
        if jobs is None:
            break
        try:
            out = []
            for job in jobs:
                mesh = (whole if job.group is None else DeviceMesh()
                        if job.group == "solo" else sub[tuple(job.group)])
                fn = getattr(importlib.import_module(job.module), job.name)
                out.append(fn(mesh, *job.args))
            res.put((rank, True, out))
        except BaseException:
            res.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world, rendezvous_dir, groups=(), threads=1,
                 timeout=300):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        init = "file://" + os.path.join(os.path.abspath(rendezvous_dir),
                                        "rendezvous")
        self.cmd = [ctx.Queue() for _ in range(world)]
        self.res = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True, args=(
            r, world, init, tuple(tuple(g) for g in groups), threads,
            timeout, self.cmd[r], self.res)) for r in range(world)]
        for p in self.procs:
            p.start()
        try:
            self._collect(range(world))
        except BaseException:
            self.close()
            raise

    def _get(self):
        """The next result; raises when a rank process has died or the
        timeout has passed."""
        import queue
        import time

        t_end = time.monotonic() + self.timeout
        while True:
            try:
                return self.res.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if p.exitcode is not None]
                if dead or time.monotonic() > t_end:
                    raise RuntimeError(
                        f"RankPool: ranks {dead} ended" if dead else
                        f"RankPool: no result in {self.timeout} s") from None

    def _collect(self, ranks):
        out, errors = {}, []
        for _ in ranks:
            rank, ok, payload = self._get()
            if ok:
                out[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def run(self, jobs):
        """{rank: Job or [Job, ...]} -> {rank: result or [result, ...]}:
        each rank runs its jobs in order, the ranks at the same time (the
        members of a group must list that group's jobs in one order)."""
        for r, job in jobs.items():
            self.cmd[r].put(list(job) if isinstance(job, (list, tuple))
                            else [job])
        out = self._collect(list(jobs))
        return {r: (out[r] if isinstance(job, (list, tuple)) else out[r][0])
                for r, job in jobs.items()}

    def close(self):
        for q, p in zip(self.cmd, self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
