"""Build and load the port's hand-written CUDA kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  Libraries
go to ``build/torch_kernels/`` at the root of the checkout, named by a hash
of their source, so an edited source is rebuilt and an unchanged one is
built once per checkout.  ``build`` starts one ``nvcc`` per source, all at
once.  A variant (``VARIANTS``) is a kernel's source built with extra
flags, only when asked for: ``ln_gru_phases`` records per-phase clocks for
``ops/ln_gru_phases.py``.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
CSRC = Path(__file__).resolve().parent / "csrc"
#: kernel name -> source; one shared library each
SOURCES: Dict[str, Path] = {"ln_gru": CSRC / "ln_gru.cu"}
#: variant name -> (kernel, extra nvcc flags); built by name only
VARIANTS: Dict[str, Tuple[str, Tuple[str, ...]]] = {"ln_gru_phases": ("ln_gru", ("-DLN_GRU_PHASES",))}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: kernel name -> {C function: (restype, argtypes)}, applied when loaded
SIGNATURES: Dict[str, Dict[str, Tuple[Any, List[Any]]]] = {
    "ln_gru": {
        # (dtype, joint, w, b, g, beta, h, out, partials, rows, K, H, eps,
        #  units, ctas, unit_block, batch_tile, vec, groups, kgroups, klanes,
        #  unit_tile, segs, stages, smem_bytes, stream): the plan of
        #  ops/ln_gru.py::_launch_plan
        "ln_gru_forward": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F] + [_I] * 12 + [_P]),
        # (device, *sm_count, *smem_per_block)
        "ln_gru_device_limits": (_I, [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]),
        "ln_gru_error_string": (ctypes.c_char_p, [_I]),
    }
}
SIGNATURES["ln_gru_phases"] = {
    **SIGNATURES["ln_gru"],
    # (out [ctas, 7] uint64, ctas)
    "ln_gru_phases": (_I, [_P, _I]),
}
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda and PATH)")
    return found


def _source_and_flags(name: str) -> Tuple[Path, Tuple[str, ...]]:
    if name in VARIANTS:
        kernel, extra = VARIANTS[name]
        return SOURCES[kernel], NVCC_FLAGS + extra
    return SOURCES[name], NVCC_FLAGS


def library_path(name: str) -> Path:
    source, flags = _source_and_flags(name)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, object]]:
    """Compile the named kernels (default: all, no variants) that are not built yet, one
    ``nvcc`` process per source started together.  Returns, per kernel, the
    build seconds (0 when it was already built) and ptxas' register and
    shared-memory report."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: Dict[str, Dict[str, object]] = {}
    procs = {}
    t0 = time.monotonic()
    for name in names:
        target = library_path(name)
        if target.is_file():
            report[name] = {"seconds": 0.0, "ptxas": "", "path": str(target)}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        source, flags = _source_and_flags(name)
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp)
    for name, (proc, tmp) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{stdout}{stderr}")
        os.replace(tmp, library_path(name))  # atomic: a concurrent build never sees a partial library
        report[name] = {
            "seconds": time.monotonic() - t0,
            "ptxas": (stdout + stderr).strip(),
            "path": str(library_path(name)),
        }
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.is_file():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn_name, (restype, argtypes) in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.restype = restype
                fn.argtypes = argtypes
            _libs[name] = lib
        return lib
