"""Run a function of ``tests/torch_parallel_cases.py`` on a world of gloo
processes on the CPU (the multi-process tests of the port's parallel tier).

Each rank is a fresh ``python tests/torch_dist_child.py`` process (JAX is
not imported there), one thread (``OMP_NUM_THREADS=1``: pytest runs its
files on several workers at once), joined to the others by
``superdiff_tpu_torch.parallel.distributed.initialize`` at a free
localhost port. The inputs go to every rank through a ``torch.save`` file;
each rank saves what its cases return. A world that runs past its
``timeout`` is killed, and the test fails.
"""

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "torch_dist_child.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """A world of ``world`` ranks running ``cases`` ({name: inputs}, in
    order), started at construction; :meth:`join` waits for it (killing
    it past ``timeout`` seconds from the start) and returns per rank the
    dict {name: what the case returned}. Start a world before slow work of
    the test process (a JAX compile), so the two overlap."""

    def __init__(self, world: int, cases: dict, timeout: float = 120.0, env=None):
        self.world, self.timeout = world, timeout
        self.work = tempfile.mkdtemp(prefix="torch_dist_")
        torch.save(cases, os.path.join(self.work, "inputs.pt"))
        penv = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                    PYTHONPATH=os.pathsep.join([REPO, HERE, os.environ.get("PYTHONPATH", "")]),
                    **(env or {}))
        port = free_port()
        self.start = time.monotonic()
        self.procs = [subprocess.Popen([sys.executable, CHILD, str(port), str(r), str(world),
                                        self.work], env=penv, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                      for r in range(world)]

    def join(self) -> list:
        try:
            logs = []
            try:
                for p in self.procs:
                    left = max(self.timeout - (time.monotonic() - self.start), 0.1)
                    logs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                for p in self.procs:
                    p.kill()
                for p in self.procs:
                    p.communicate()
                raise AssertionError(f"a world of {self.world} ran past {self.timeout} s")
            failed = [f"rank {r} failed:\n{log[-3000:]}"
                      for r, (p, log) in enumerate(zip(self.procs, logs)) if p.returncode]
            assert not failed, "\n".join(failed)
            return [torch.load(os.path.join(self.work, f"rank{r}.pt"), weights_only=False)
                    for r in range(self.world)]
        finally:
            shutil.rmtree(self.work, ignore_errors=True)


def run_world(world: int, cases: dict, timeout: float = 120.0, env=None) -> list:
    """Run ``cases`` on ``world`` ranks and wait (:class:`World`)."""
    return World(world, cases, timeout, env).join()
