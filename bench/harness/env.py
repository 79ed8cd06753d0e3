"""The run's surroundings: cache directories fixed inside the checkout, the
card check, the card's name and power limit, and the check that no JAX
module was loaded."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

#: Top-level module names that may not be loaded in a run's process.
BANNED = ("jax", "jaxlib", "flax", "repro")
#: Cache variables of the libraries the program may use, each given a fixed
#: directory under ``build/bench-cache/`` of the checkout (the port's own CUDA
#: library builds into ``build/repro_torch/``, also in the checkout).
CACHE_VARS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda_cache", "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def prepare_environment(root: Path) -> None:
    """Cache directories fixed inside the checkout, the allocator's setting, and
    no JAX through a library that would load it.  Runs before torch starts CUDA."""
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(Path(root) / "build" / "bench-cache" / sub)
    # the serving cells' per-layer transients change size from batch to batch; without
    # expandable segments the allocator's cached blocks no longer fit the largest
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def banned_modules() -> list[str]:
    """The banned top-level names among the loaded modules (whole names:
    ``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def card_error(chips: int) -> str | None:
    """Why the run cannot start on this machine, or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: the benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards, torch.cuda.device_count() is {torch.cuda.device_count()}"
    return None


def power_line() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    tool = shutil.which("nvidia-smi")
    if tool is None:
        return "nvidia-smi: not found"
    proc = subprocess.run([tool, "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    return "nvidia-smi: " + (proc.stdout.strip().replace("\n", "; ") or proc.stderr.strip())


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of the run, from ``--seed`` and the stream's
    name (any whole number, of any size, gives its own streams)."""
    text = ":".join([str(int(seed)), *map(str, parts)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1
