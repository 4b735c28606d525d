"""Checkpoints in the reference's on-disk format, with its async writer.

Every leaf is saved as ``.npy`` chunks of raw little-endian bytes
(``uint8``), keyed by the global index bounds of the chunk, plus a
manifest with shapes, dtype strings, chunk tables and crc32 integrity
hashes.  Leaf names are the reference's tree paths (dict keys in sorted
order, joined by ``/``), so a checkpoint written by either package
restores in the other.  The port writes one chunk a leaf, whole (a
DTensor leaf is gathered first); its reader assembles a leaf from any
overlapping chunks, so it also restores what a sharded mesh wrote.

bfloat16 has no numpy dtype: its bytes are written through
``Tensor.view(torch.uint8)`` under the dtype string ``"bfloat16"`` and
read back through ``.view(torch.bfloat16)``, as the reference's
``ml_dtypes`` arrays are.

Commit protocol: chunks are written into ``step_<n>.tmp/`` and the
directory is renamed to ``step_<n>/`` after the manifest lands, so a
crashed writer never leaves a half-valid checkpoint.
``CheckpointManager`` copies the state to the host synchronously and
writes the files on one background thread; ``wait()`` joins it and
raises its error, at the latest at the next save or restore.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import shutil
import threading
import time
import zlib

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.schema import _unflatten


def _leaf_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(name, leaf) in sorted-key order, names joined by ``/``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (numpy's name for it)."""
    return str(dtype).removeprefix("torch.")


def _chunk_name(name: str, start: tuple, stop: tuple) -> str:
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", name)
    idx = "_".join(f"{a}-{b}" for a, b in zip(start, stop))
    return f"{safe}__{idx or 'scalar'}.npy"


def save_checkpoint(directory, step: int, state, *, keep: int = 3):
    """Synchronous save of a tree of tensors, one chunk a leaf.  Returns
    the checkpoint path."""
    directory = pathlib.Path(directory)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "leaves": {}}
    for name, leaf in _leaf_paths(state):
        t = leaf.detach().to("cpu").contiguous()
        shape = list(t.shape)
        data = t.reshape(-1).view(torch.uint8).numpy()
        fname = _chunk_name(name, (0,) * t.ndim, tuple(shape))
        np.save(tmp / fname, data)
        manifest["leaves"][name] = {
            "shape": shape,
            "dtype": _dtype_name(t.dtype),
            "chunks": [{"file": fname, "start": [0] * t.ndim,
                        "stop": shape, "shape": shape,
                        "dtype": _dtype_name(t.dtype),
                        "crc32": zlib.crc32(data) & 0xFFFFFFFF}],
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(directory, keep)
    return final


def _gc(directory: pathlib.Path, keep: int):
    steps = sorted(
        (int(p.name.split("_")[1]), p)
        for p in directory.glob("step_*") if p.name.split("_")[1].isdigit())
    for _, p in steps[:-keep] if keep else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if p.name.split("_")[1].isdigit()
             and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _read_leaf(ckpt: pathlib.Path, meta: dict, verify: bool) -> torch.Tensor:
    """A whole leaf on the host, assembled from its chunks."""
    shape = tuple(meta["shape"])
    out = torch.empty(shape, dtype=getattr(torch, meta["dtype"]))
    for ch in meta["chunks"]:
        raw = np.load(ckpt / ch["file"])
        if verify and zlib.crc32(raw) & 0xFFFFFFFF != ch["crc32"]:
            raise IOError(f"checksum mismatch in {ch['file']}")
        dtype = getattr(torch, ch.get("dtype", meta["dtype"]))
        data = torch.from_numpy(raw).view(dtype).reshape(ch["shape"])
        if tuple(ch["shape"]) == shape:
            out = data
            continue
        dst = tuple(slice(a, b) for a, b in zip(ch["start"], ch["stop"]))
        out[dst] = data
    return out


def restore_checkpoint(directory, step: int, abstract_state, device=None,
                       *, verify: bool = False):
    """Restore ``step``.  ``abstract_state`` is a tree of tensors (meta
    tensors from ``abstract_params`` / ``abstract_state``, or real ones):
    each leaf's shape must match the checkpoint's and its dtype is the
    one restored.  Leaves land on ``device`` (default: the host)."""
    ckpt = pathlib.Path(directory) / f"step_{step}"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    out = []
    for name, leaf in _leaf_paths(abstract_state):
        meta = manifest["leaves"][name]
        if tuple(leaf.shape) != tuple(meta["shape"]):
            raise ValueError(f"{name}: checkpoint shape {meta['shape']}, "
                             f"wanted {tuple(leaf.shape)}")
        t = _read_leaf(ckpt, meta, verify)
        out.append(t.to(device=device or "cpu", dtype=leaf.dtype))
    return _unflatten(abstract_state, out)


def _host_copy(t) -> torch.Tensor:
    """A leaf's whole tensor copied to the host; a DTensor is gathered
    first (a collective: every rank of its mesh must call it)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().to("cpu", copy=True)


@dataclasses.dataclass
class CheckpointManager:
    """Async checkpointing with a single background writer thread.
    ``last_save`` holds the newest save's seconds (``d2h_s``; ``files_s``
    once ``wait()`` has joined its writer) and ``bytes``.  A save writes
    whole tensors (DTensor leaves gathered), so a checkpoint from a mesh
    restores anywhere; with ``writer=False`` (every rank of a mesh but
    one) it gathers and writes nothing."""
    directory: str
    keep: int = 3
    writer: bool = True
    _thread: threading.Thread | None = None
    _error: list = dataclasses.field(default_factory=list)
    last_save: dict = dataclasses.field(default_factory=dict)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()

    def save(self, step: int, state, *, block: bool = False):
        self.wait()
        # Copy to the host synchronously (a copy even of host tensors)
        # so the step can update `state` in place at once; file IO
        # happens off-thread.
        if not self.writer:
            for _, t in _leaf_paths(state):   # the writer's gathers
                if isinstance(t, DTensor):
                    t.full_tensor()
            return
        t0 = time.perf_counter()
        host_state = _unflatten(state, [
            _host_copy(t) for _, t in _leaf_paths(state)])
        timing = {"step": step, "d2h_s": time.perf_counter() - t0,
                  "bytes": sum(t.numel() * t.element_size()
                               for _, t in _leaf_paths(host_state))}
        self.last_save = timing

        def work():
            try:
                t1 = time.perf_counter()
                save_checkpoint(self.directory, step, host_state,
                                keep=self.keep)
                timing["files_s"] = time.perf_counter() - t1
            except Exception as e:  # surfaced at the next wait()
                self._error.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def restore_latest(self, abstract_state, device=None):
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step,
                                        abstract_state, device)
