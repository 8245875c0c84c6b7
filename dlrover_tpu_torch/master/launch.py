"""Start the port's master in a child process and read its address.

``start_master`` runs ``dlrover_tpu_torch.master.main --port 0
--port_file <file>`` as ``python -m`` would (the launcher's contract: the
master binds a free port and publishes it through the file), in a
process where importing the JAX package, ``jax``, ``flax`` or ``optax``
raises, so a master that needed any of them would fail to start.
``wait_for_port`` reads the published port.
"""

import os
import subprocess
import sys
import time
from typing import Optional, Sequence

#: Import roots a master started by ``start_master`` may not load.
BLOCKED = ("dlrover_tpu", "jax", "jaxlib", "flax", "optax")

_BOOT = """
import importlib.abc, runpy, sys
BLOCKED = {blocked!r}

class _Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{{name}} may not be imported by the port's master")

sys.meta_path.insert(0, _Blocked())
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
if loaded:
    sys.exit(f"loaded before the master started: {{loaded}}")
try:
    import dlrover_tpu
except ImportError:
    pass
else:
    sys.exit("dlrover_tpu imported despite the block")
sys.argv = ["dlrover_tpu_torch.master.main"] + sys.argv[1:]
runpy.run_module("dlrover_tpu_torch.master.main", run_name="__main__")
"""


def start_master(port_file: str, args: Sequence[str] = (),
                 env: Optional[dict] = None,
                 stdout=None) -> subprocess.Popen:
    """Start a master publishing its port to ``port_file``; ``args`` are
    more flags of ``master.main``; its output goes to ``stdout`` (a
    file), both streams. The package's root is put first on the child's
    ``PYTHONPATH``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    cmd = [sys.executable, "-c", _BOOT.format(blocked=BLOCKED),
           "--port", "0", "--port_file", port_file, *args]
    return subprocess.Popen(cmd, env=env, stdout=stdout,
                            stderr=subprocess.STDOUT if stdout else None)


def wait_for_port(port_file: str, proc: subprocess.Popen,
                  timeout: float = 60.0) -> int:
    """The port the master published; raises if it exits first or
    publishes nothing within ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(port_file) as f:
                text = f.read().strip()
            if text:
                return int(text)
        except OSError:
            pass
        code = proc.poll()
        if code is not None:
            raise RuntimeError(f"the master exited with {code} before "
                               "publishing its port")
        time.sleep(0.02)
    raise TimeoutError(f"no port in {port_file} after {timeout:.0f}s")
