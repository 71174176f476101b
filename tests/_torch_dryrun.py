"""Shared helpers of the port's dry-run tests
(``tests/test_torch_dryrun*.py``): ``python -m repro_torch.launch.dryrun``
or a script in a subprocess, each with a ``fake`` process group of
``DRYRUN_DEVICES`` ranks of its own."""
import os
import subprocess
import sys

# The parent's environment (platform pins must reach the child), the
# process group's size the only override.
ENV = dict(os.environ, PYTHONPATH="src", DRYRUN_DEVICES="8")


def run_cell(args, timeout=300, env=None):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun"] + args,
        capture_output=True, text=True, timeout=timeout, env=env or ENV)


def run_script(script, timeout=300, env=None):
    return subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=timeout, env=env or ENV)


def tail(r):
    return r.stdout[-2000:] + r.stderr[-3000:]
