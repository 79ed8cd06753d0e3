"""Build the port's CUDA sources into one shared library and load it with ctypes.

Every ``kernels/*/csrc/*.cu`` is compiled by one ``nvcc`` call for Hopper
(``sm_90a``) into one ``.so`` with a plain C interface.  The library is named by a digest
of the sources and the flags, so a changed source builds a new library and
an unchanged one is reused, also by later processes.  Builds go to
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``) at first use, and each one is recorded in
:mod:`repro_torch.obs.retrace` under scope ``torch_port.build``.

``--fmad=false`` is part of the contract, not a tuning flag: the sweep's
results are held bit for bit against the plain PyTorch version, and a
contracted multiply-add rounds once where the plain version rounds twice.
Never build with ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from repro_torch.obs import retrace

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
BUILD_SCOPE = "torch_port.build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: digest -> loaded library, so a process loads each build once
_LOADED: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.relative_to(KERNELS_DIR).as_posix().encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` (default
    ``/usr/local/cuda``).  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); the CUDA kernels cannot be built")


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{digest(sources())}.so"


def build_log_path() -> Path:
    """Where the compiler's output of the current build is kept (register
    and spill counts from ``-Xptxas -v``)."""
    return library_path().with_suffix(".log")


def _build(srcs: list[Path], so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        tmp_so = Path(tmp) / so.name
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-shared", *map(str, srcs), "-o", str(tmp_so)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
        so.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp_so, so)  # atomic: a concurrent loader sees all or nothing


def load_library() -> ctypes.CDLL:
    """The built library of the current sources, building it first when no
    build of this digest exists."""
    srcs = sources()
    key = digest(srcs)
    lib = _LOADED.get(key)
    if lib is None:
        so = BUILD_DIR / f"librepro_torch_{key}.so"
        if not so.exists():
            _build(srcs, so)
            retrace.record_trace(BUILD_SCOPE, (key,))
        lib = ctypes.CDLL(str(so))
        _LOADED[key] = lib
    return lib
