"""The JAX reference of a world test, run beside the port's world.

A world test's reference script (``python -c`` text) gets two paths.  It
first makes the inputs the port's ranks read (weights, batches, prompts)
and hands them over with ``dump_inputs`` (defined by ``PRELUDE``) to the
second path, then compiles and runs on its forced host devices and writes
its results to the first.  The ranks start as soon as the inputs are
there, so the reference's compilations and the port's world run at once
instead of one after the other.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import os as _os, pickle as _pickle, sys as _sys


def dump_inputs(obj):
    tmp = _sys.argv[2] + ".tmp"
    with open(tmp, "wb") as f:
        _pickle.dump(obj, f)
    _os.replace(tmp, _sys.argv[2])
"""


def run_beside_world(script: str, devices: int, tmp, start_world,
                     timeout: float = 600.0):
    """Runs the reference ``script`` on ``devices`` forced host devices
    and, once its inputs are written, ``start_world(inputs_path)`` in this
    process.  Returns the reference's results.  Fails with the
    reference's stderr if it exits non-zero or never writes its inputs;
    if the world raises, the reference is stopped."""
    res_path = os.path.join(str(tmp), "reference.pkl")
    in_path = os.path.join(str(tmp), "inputs.pkl")
    env = dict(os.environ)
    # LLVM's optimization level 0: these programs run on a few rows, so
    # compiling them is most of the reference's time
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={devices}"
                        " --xla_backend_optimization_level=0")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    deadline = time.time() + timeout
    with open(os.path.join(str(tmp), "reference.err"), "w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", PRELUDE + textwrap.dedent(script),
             res_path, in_path],
            stdout=subprocess.DEVNULL, stderr=err, env=env)
        try:
            while not os.path.exists(in_path) and proc.poll() is None \
                    and time.time() < deadline:
                time.sleep(0.05)
            if os.path.exists(in_path):
                start_world(in_path)
            rc = proc.wait(timeout=max(1.0, deadline - time.time()))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        tail = err.read()[-4000:]
    assert rc == 0 and os.path.exists(in_path), f"stderr:\n{tail}"
    with open(res_path, "rb") as f:
        return pickle.load(f)
