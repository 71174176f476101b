"""Shared helper of the port's sharded-training tests: a script run by
``torchrun`` as 8 gloo ranks on the CPU, each rank a process of its own
(the process group lives and dies with the subprocess)."""
import json
import os
import subprocess
import sys

ENV = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")


def torchrun(args, timeout=420):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8"] + args,
        capture_output=True, text=True, timeout=timeout, env=ENV)


def results(r, tag="RESULT "):
    """The JSON objects rank 0 printed after ``tag``."""
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return [json.loads(line[len(tag):]) for line in r.stdout.splitlines()
            if line.startswith(tag)]
