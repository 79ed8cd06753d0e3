"""Checkpoint manager: atomic, async, quantized on the card.

The port of :mod:`repro.checkpoint.manager`, with the same layout, files and
manifest, so a checkpoint written by either package restores in the other::

    <root>/step_000000123/
        manifest.json        # written LAST -> commit point
        leaf_00000.npy ...   # one file per leaf (or .npz for int8)

Leaves are numbered in the JAX package's order
(:mod:`repro_torch.checkpoint.tree`: dict keys sorted, lists and tuples in
order); a leaf is a tensor, a NumPy array or a scalar.

  * **Atomic**: writes go to ``step_X.tmp/``; the manifest is written last
    and the directory renamed.  A checkpoint without a manifest is ignored,
    and ``.tmp`` directories are removed when a manager starts, so a kill in
    the middle of a checkpoint (the paper's out-of-bid case) never corrupts
    the latest good one.
  * **Async**: ``save(..., block=False)`` copies the leaves to host memory
    synchronously and writes the files on a background thread, so the
    training loop's pause (t_c) is the device-to-host copy, not the I/O.  A
    write's error is raised by the next :meth:`CheckpointManager.wait` (which
    every save and restore calls first).
  * **Quantized** (``codec_name="int8"``): every float32 / float16 / bfloat16
    leaf of 1024 elements or more is quantized in 256-element blocks by
    :func:`repro_torch.kernels.ckpt_codec.ops.quantize` *while it is still on
    the card* (the CUDA kernel there, the plain version on the CPU), so the
    copy to the host moves int8 plus scales, about a quarter of float32's
    bytes.  The files hold the same ``q``, ``scales`` and ``shape`` arrays as
    the JAX manager's.  Restore dequantizes onto the template's device with
    plain PyTorch (the JAX package has no dequantize kernel either).  The
    default ``codec_name="raw"`` is bit-exact; bfloat16 leaves are stored as
    their 16-bit view with a ``"bfloat16"`` dtype tag.
  * **Integrity**: sha256 per leaf file, checked on restore.  Every way a
    checkpoint can be unreadable (missing or torn leaf, hash mismatch,
    mangled manifest) raises :class:`CheckpointCorruptionError`, so the
    trainer can quarantine the damaged snapshot and fall back to an older one
    (:meth:`CheckpointManager.quarantine` renames it to ``*.corrupt``).

  * **On a mesh** (the ranks of a process group, the JAX package's
    multi-device arrays): a placed leaf (a DTensor) is gathered whole by
    every rank (``full_tensor()``, a collective), one leaf at a time, and
    rank 0 alone quantizes it and writes; the files are those of a
    one-device checkpoint.  Every rank constructs the manager, saves and
    restores together.  Each write (and :meth:`CheckpointManager.wait`,
    since only rank 0's writer thread runs) ends with the ranks sharing
    their outcome, a collective that is also the barrier: no rank lists or
    restores a step before it exists, and when rank 0's write fails (a full
    disk) every rank raises, the others a :class:`CheckpointWriteError`
    naming it.
  * **Elastic restore**: ``restore(..., shardings=)`` places each restored
    leaf on the ambient mesh (:func:`repro_torch.parallel.use_compat_mesh`,
    or ``mesh=``) with the given placements (what
    :func:`repro_torch.parallel.shard_params` gives), which need not be the
    mesh it was saved from: every rank reads and checks every leaf, then cuts
    its own shard.  Without ``shardings`` a leaf lands where its template
    leaf is: a placed template's mesh and placements, a tensor's device, the
    CPU for a NumPy or meta template.

Fault-injection sites (:mod:`repro_torch.faults`): ``ckpt.save`` fires per
write (``raise`` = I/O failure, ``torn`` = a leaf file silently truncated
after hashing, seen only at restore) and ``ckpt.restore`` per restore attempt
(``raise`` = unreadable checkpoint), both keyed by step, alike on every rank.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import faults
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.kernels.ckpt_codec import ops as codec
from repro_torch.parallel import sharding as S

#: Leaves the int8 codec quantizes: these dtypes, at least this many elements.
QUANTIZED_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
MIN_QUANTIZED_SIZE = 1024

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16, "int8": torch.int8,
    "uint8": torch.uint8, "bool": torch.bool,
}


@dataclasses.dataclass
class CheckpointMeta:
    step: int
    codec: str
    n_leaves: int
    wall_time_s: float
    bytes_written: int
    extra: dict


class CheckpointCorruptionError(IOError):
    """A checkpoint on disk cannot be restored (torn file, bad hash, mangled
    manifest).  Carries the step and path so recovery code can quarantine
    exactly the damaged snapshot and fall back to an older one."""

    def __init__(self, step: int | None, path: str, reason: str):
        self.step = step
        self.path = path
        self.reason = reason
        super().__init__(f"corrupt checkpoint step={step} ({path}): {reason}")


class CheckpointWriteError(IOError):
    """Another rank of the mesh failed its part of a checkpoint operation
    (rank 0's write, or its rename of a quarantined step); carries that
    rank's error as text."""


def quantized(leaf, codec_name: str) -> bool:
    """Does the codec store ``leaf`` as int8 blocks?"""
    if codec_name != "int8":
        return False
    x = leaf if isinstance(leaf, torch.Tensor) else _as_tensor(leaf)
    return x.dtype in QUANTIZED_DTYPES and x.numel() >= MIN_QUANTIZED_SIZE


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def _dtype_name(x: torch.Tensor) -> str:
    return str(x.dtype).removeprefix("torch.")


@dataclasses.dataclass
class _Snapshot:
    """One leaf in host memory: ``arrays`` holds ``q`` / ``scales`` / ``shape``
    (int8) or the raw array (its 16-bit view for bfloat16)."""

    dtype: str
    arrays: dict


def _snapshot(leaf, codec_name: str) -> _Snapshot:
    """The device-to-host part of a save: quantize on the leaf's device when
    the codec says so, then copy to host memory."""
    x = _as_tensor(leaf).detach()
    name = _dtype_name(x)
    if quantized(x, codec_name):
        q, scales, shape = codec.quantize(x.contiguous())
        return _Snapshot(name, {
            "q": q.cpu().numpy(), "scales": scales.cpu().numpy(), "shape": np.asarray(shape, dtype=np.int64),
        })
    host = x.to("cpu", copy=True)  # a copy on the CPU too: the caller may change x while the write runs
    arr = host.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else host.numpy()
    return _Snapshot(name, {"raw": arr})


def _device_of(tmpl, mesh=None) -> torch.device:
    """Where a restored leaf is built: its template's device (a placed
    template's local one), else the device of the mesh it goes to, else the
    CPU."""
    if S.is_placed(tmpl):
        tmpl = tmpl.to_local()
    if isinstance(tmpl, torch.Tensor) and tmpl.device.type != "meta":
        return tmpl.device
    if mesh is not None and mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _ranks() -> tuple[int, int]:
    """``(rank, world size)`` of the running process group, ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _placement_leaves(template, shardings) -> list:
    """The placements of ``shardings`` for each leaf of ``template``, in
    :func:`tree_lib.flatten`'s order (``shardings`` has the template's nesting,
    a tuple of placements where the template has a leaf)."""
    out: list = []

    def walk(x, sh):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], sh[k])
        elif isinstance(x, (list, tuple)):
            if len(x) != len(sh):
                raise ValueError(f"{len(x)} entries against {len(sh)} placements")
            for a, b in zip(x, sh):
                walk(a, b)
        elif x is not None:
            out.append(tuple(sh))

    walk(template, shardings)
    return out


class CheckpointManager:
    def __init__(
        self,
        root: str,
        *,
        keep: int = 3,
        codec_name: str = "raw",  # raw | int8
        async_io: bool = False,
    ):
        if codec_name not in ("raw", "int8"):
            raise ValueError(f"unknown codec {codec_name!r}; expected 'raw' or 'int8'")
        self.root = root
        self.keep = keep
        self.codec_name = codec_name
        self.async_io = async_io
        self._thread: threading.Thread | None = None
        self._last_error: Exception | None = None
        self.rank, self.world = _ranks()  # on a mesh every rank constructs the manager; rank 0 writes
        self._on_rank0(self._make_root)

    # ------------------------------------------------------------------
    def _make_root(self):
        os.makedirs(self.root, exist_ok=True)
        self._clean_tmp()

    def _clean_tmp(self):
        for d in os.listdir(self.root):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith((".tmp", ".corrupt")):
                if os.path.exists(os.path.join(self.root, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def quarantine(self, step: int) -> str:
        """Move a damaged checkpoint out of :meth:`steps`'s view (renamed to
        ``step_X.corrupt``, kept on disk as evidence); returns the new path."""
        src = os.path.join(self.root, f"step_{step:09d}")
        dst = src + ".corrupt"

        def move():
            if os.path.exists(dst):  # re-quarantine after a re-save of the step
                shutil.rmtree(dst, ignore_errors=True)
            os.replace(src, dst)

        self._on_rank0(move)  # on a mesh every rank calls it; rank 0 moves, the others wait
        return dst

    # ------------------------------------------------------------------
    def _agree(self, err: Exception | None) -> Exception | None:
        """On a mesh, every rank's outcome shared (a collective, so also a
        barrier): a rank's own error, else another rank's as a
        :class:`CheckpointWriteError`, else None.  So every rank raises or
        none does."""
        if self.world == 1:
            return err
        errs = [None] * self.world
        dist.all_gather_object(errs, None if err is None else f"{type(err).__name__}: {err}")
        if err is None:
            failed = [(r, e) for r, e in enumerate(errs) if e is not None]
            if failed:
                err = CheckpointWriteError(f"rank {failed[0][0]} failed: {failed[0][1]}")
        return err

    def _on_rank0(self, fn) -> None:
        """``fn()`` on rank 0 alone, then :meth:`_agree`."""
        err = None
        if self.rank == 0:
            try:
                fn()
            except Exception as e:
                err = e
        err = self._agree(err)
        if err is not None:
            raise err

    def save(self, step: int, tree, extra: dict | None = None, *, block: bool = True) -> CheckpointMeta:
        """Snapshot ``tree`` (nested dicts / lists / tuples of tensors, arrays
        or scalars; placed leaves gathered whole) at ``step``."""
        self.wait()  # one outstanding async save at a time (double-buffer)
        t0 = time.monotonic()
        # synchronous part: quantize on the device, copy to the host (the training pause = t_c)
        leaves, treedef = tree_lib.flatten(tree)
        host_leaves = [self._snapshot(x) for x in leaves]
        snap_time = time.monotonic() - t0
        meta_holder: dict = {}

        def write():
            try:
                if self.rank == 0:
                    meta_holder["meta"] = self._write(step, host_leaves, treedef, extra or {}, snap_time)
                else:  # the fault plan fires alike on every rank, so the ranks agree on which steps exist
                    self._fire_save(step)
                    meta_holder["meta"] = CheckpointMeta(step, self.codec_name, len(host_leaves), snap_time, 0,
                                                         extra or {})
            except Exception as e:  # surfaced on the next wait()
                self._last_error = e

        if block or not self.async_io:
            write()
            err, self._last_error = self._agree(self._last_error), None
            if err is not None:
                raise err
            return meta_holder["meta"]
        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        return CheckpointMeta(step, self.codec_name, len(host_leaves), snap_time, 0, extra or {})

    def _snapshot(self, leaf) -> _Snapshot | None:
        """A leaf in host memory on rank 0 (None on the other ranks); a placed
        leaf is gathered whole on every rank first."""
        if S.is_placed(leaf):
            leaf = leaf.full_tensor()
        return _snapshot(leaf, self.codec_name) if self.rank == 0 else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._last_error = self._agree(self._last_error)
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    # ------------------------------------------------------------------
    def _write(self, step, host_leaves, treedef, extra, snap_time) -> CheckpointMeta:
        name = f"step_{step:09d}"
        tmp = os.path.join(self.root, name + ".tmp")
        final = os.path.join(self.root, name)
        action = self._fire_save(step)
        os.makedirs(tmp, exist_ok=True)
        files = []
        total = 0
        for i, leaf in enumerate(host_leaves):
            path = os.path.join(tmp, f"leaf_{i:05d}")
            if "raw" in leaf.arrays:
                np.save(path, leaf.arrays["raw"])
                path += ".npy"
            else:
                np.savez(path, **leaf.arrays)
                path += ".npz"
            with open(path, "rb") as f:
                h = hashlib.sha256(f.read()).hexdigest()
            total += os.path.getsize(path)
            files.append({"file": os.path.basename(path), "sha256": h, "dtype": leaf.dtype})
        if action is not None and action.kind == "torn" and files:
            # silent torn write: the commit completes but one leaf is
            # truncated after hashing -- only restore's integrity check sees it
            torn = os.path.join(tmp, files[0]["file"])
            with open(torn, "rb") as f:
                data = f.read()
            with open(torn, "wb") as f:
                f.write(data[: len(data) // 2])
        manifest = {
            "step": step,
            "codec": self.codec_name,
            "treedef": str(treedef),
            "files": files,
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, final)
        self._gc()
        return CheckpointMeta(step, self.codec_name, len(host_leaves), snap_time, total, extra)

    @staticmethod
    def _fire_save(step: int):
        action = faults.current().fire("ckpt.save", key=step)
        if action is not None and action.kind == "raise":
            raise faults.InjectedFault(action)  # async saves surface this on wait()
        return action

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, template, step: int | None = None, *, shardings=None, mesh=None) -> tuple:
        """Restore into the structure of ``template`` (the same nesting as the
        saved tree; its leaves give the shapes and devices).  Returns
        ``(tree, extra)`` with tensor leaves in the saved dtypes.

        ``shardings``: a tree of DTensor placements of the template's nesting
        (:func:`repro_torch.parallel.shard_params` over its axes); each leaf
        is then placed with them on ``mesh`` (the ambient mesh unless given),
        every rank cutting its own shard of the leaf it read."""
        self.wait()
        if shardings is not None:
            mesh = mesh or S.active_abstract_mesh().device_mesh
            if mesh is None:
                raise ValueError("restore(shardings=) needs a mesh: use_compat_mesh(...) or mesh=")
            mesh = S._as_abstract(mesh)._device_mesh()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = os.path.join(self.root, f"step_{step:09d}")
        action = faults.current().fire("ckpt.restore", key=step)
        if action is not None:
            raise CheckpointCorruptionError(step, d, f"injected: {action.describe()}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CheckpointCorruptionError(step, d, f"unreadable manifest: {e}") from e
        leaves_t, treedef = tree_lib.flatten(template)
        if len(manifest["files"]) != len(leaves_t):
            raise ValueError(f"checkpoint has {len(manifest['files'])} leaves, template has {len(leaves_t)}")
        where = [None] * len(leaves_t) if shardings is None else _placement_leaves(template, shardings)
        if len(where) != len(leaves_t):
            raise ValueError(f"{len(where)} placements for {len(leaves_t)} leaves")
        out = []
        for i, (entry, tmpl) in enumerate(zip(manifest["files"], leaves_t)):
            path = os.path.join(d, entry["file"])
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError as e:
                raise CheckpointCorruptionError(step, path, f"missing leaf file: {e}") from e
            if hashlib.sha256(data).hexdigest() != entry["sha256"]:
                raise CheckpointCorruptionError(step, path, "leaf sha256 mismatch (torn write?)")
            dev = _device_of(tmpl, mesh)
            try:
                dtype = _TORCH_DTYPES[entry["dtype"]]
                if path.endswith(".npz"):
                    with np.load(io.BytesIO(data)) as z:
                        q, scales, shape = z["q"], z["scales"], tuple(int(s) for s in z["shape"])
                    arr = codec.dequantize(
                        torch.from_numpy(q).to(dev), torch.from_numpy(scales).to(dev), shape, dtype=dtype
                    )
                else:
                    raw = np.load(io.BytesIO(data))
                    if entry["dtype"] == "bfloat16":  # stored as its 16-bit view
                        host = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
                    else:
                        host = torch.from_numpy(raw)
                    arr = host.to(dev)
            except (ValueError, KeyError, EOFError, OSError, zipfile.BadZipFile) as e:
                raise CheckpointCorruptionError(step, path, f"undecodable leaf: {e}") from e
            want = tuple(getattr(tmpl, "shape", ()))
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {i}: shape {tuple(arr.shape)} != template {want}")
            if where[i] is not None:
                arr = S.place(arr, mesh, where[i])
            elif S.is_placed(tmpl):
                arr = S.place(arr, tmpl.device_mesh, tuple(tmpl.placements))
            out.append(arr)
        return treedef.unflatten(out), manifest["extra"]
