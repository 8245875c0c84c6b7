"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``ops/csrc/<name>.cu`` has a plain C interface and is compiled on
its first use into ``build/kernels/lib<name>-<hash>.so`` beside the
package (a directory git ignores); the hash of the source and of the
headers it includes (``csrc/*.cuh``) names the library, so an edited
source or header is rebuilt and a built one is reused. No
PyTorch header is compiled, so a build takes seconds. Nothing is built
when a module is imported: the CPU tests import every module on a
machine without ``nvcc``.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

from dlrover_tpu_torch.common.log import logger

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "build", "kernels",
)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_SASS_FUNCTION = re.compile(r"Function : (\S+)")
_SASS_REGISTER = re.compile(r"\bR(\d+)\b")
# A kernel's name in a mangled template: after its length's digits.
_TEMPLATE_KERNEL = re.compile(r"\d([a-z_]+_kernel)ILi(\d+)E")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def sources(name: str) -> List[str]:
    """``csrc/<name>.cu`` and every header it includes with quotes,
    directly or through another header, in the order first met."""
    found, todo = [], [source_path(name)]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        with open(path, encoding="utf-8") as f:
            text = f.read()
        todo += [os.path.join(os.path.dirname(path), inc)
                 for inc in _QUOTED_INCLUDE.findall(text)]
    return found


def library_path(name: str) -> str:
    """The library's path, named by a hash of its source and headers."""
    digest = hashlib.sha256()
    for path in sources(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def nvcc_command(name: str, out: str) -> List[str]:
    """The command that compiles ``csrc/<name>.cu`` into ``out``."""
    return [
        nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", out, source_path(name),
    ]


def build(name: str) -> Tuple[str, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path, the build seconds and what ``ptxas -v`` printed (each
    kernel's registers, shared memory and spills; empty when the library
    was there). Raises with nvcc's output when the compile fails."""
    out = library_path(name)
    if os.path.exists(out):
        return out, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        nvcc_command(name, tmp), capture_output=True, text=True
    )
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    ptxas = proc.stderr.strip()
    logger.info("built %s in %.1fs\n%s", out, dt, ptxas)
    os.replace(tmp, out)  # atomic: concurrent ranks never load half a file
    return out, dt, ptxas


def kernel_label(mangled: str) -> str:
    """``bwd_dkv_kernel<128>`` for a mangled ``template <int>`` kernel,
    the mangled name for any other function."""
    m = _TEMPLATE_KERNEL.search(mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled


def sass_registers(lib: str) -> Dict[str, int]:
    """The highest general register (``R<n>``) of each kernel of a built
    library in its SASS (``cuobjdump -sass``), by ``kernel_label``: what
    a thread of it really takes after ``setmaxnreg``, where ``ptxas -v``
    reports the launch's allocation. Raises when cuobjdump fails."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc_path()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {lib} failed:\n{proc.stderr}")
    out: Dict[str, int] = {}
    name = None
    for line in proc.stdout.splitlines():
        found = _SASS_FUNCTION.search(line)
        if found:
            name = kernel_label(found.group(1))
            out.setdefault(name, -1)
        elif name is not None:
            for reg in _SASS_REGISTER.findall(line):
                out[name] = max(out[name], int(reg))
    return out


def load_library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (at first use) and load ``lib<name>``; ``signatures`` maps
    each C entry to its ctypes argument types. Every entry returns an
    int CUDA error code."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(build(name)[0])
        for fn, argtypes in signatures.items():
            entry = getattr(lib, fn)
            entry.argtypes = list(argtypes)
            entry.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib
