"""Fault-tolerant checkpointing: atomic, async, integrity-checked, in the
JAX package's on-disk format.

  * **atomicity** — writes land in ``step_<n>.tmp/`` and are renamed to
    ``step_<n>/`` only after every leaf and the manifest are written; a
    crash mid-save never corrupts the restore point;
  * **integrity** — ``manifest.json`` carries each leaf's key, file, shape,
    dtype, crc32 and bytes; restore checks them before handing tensors on;
  * **async commit** — ``save_async`` copies the state to host memory and
    commits on a background thread; the loop pays the copy only;
  * **retention** — the newest ``keep`` checkpoints stay;
  * **elastic restore** — leaves are saved whole; ``restore(..., specs,
    mesh)`` cuts each rank's block of the *current* mesh from them, so a
    job restarted on another rank count or mesh shape reshards as it
    reads (the JAX checkpointer's ``device_put`` against the current
    mesh's shardings);
  * extra state (the data pipeline's step) rides in the manifest.

On a mesh of more than one rank (``Checkpointer(root, mesh=...)``) every
rank makes the same calls in the same order.  ``save`` and ``save_async``
take the state's specs and gather each leaf whole into rank 0's host
memory, one leaf at a time, on the calling thread; only rank 0 writes,
renames and deletes old checkpoints, so the files are exactly a one-rank
checkpoint's.  ``wait`` ends in an all-reduce of rank 0's outcome: no rank
passes it before rank 0's commit has landed, and a failed commit raises on
every rank.

One ``.npy`` a leaf, named by its key (``params/blocks/attn/wq`` →
``params__blocks__attn__wq.npy``).  numpy has no bfloat16 (the JAX package
gets one from ``ml_dtypes``, which the port does not use), so a bf16 leaf
is written as its 16-bit words (a ``uint16`` ``.npy``) with ``"dtype":
"bfloat16"`` in the manifest, and restored bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.interception import checkpoint_restore_span, checkpoint_save_span
from repro_torch.sharding import collectives as C
from repro_torch.sharding.partition import spec_items
from repro_torch.sharding.placement import gather_to_host, local_block

_STEP_RE = re.compile(r"^step_(\d+)$")


@dataclasses.dataclass
class CheckpointManifest:
    step: int
    leaves: List[dict]  # [{key, file, shape, dtype, crc32, nbytes}]
    extra: dict

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "CheckpointManifest":
        return CheckpointManifest(step=int(d["step"]), leaves=d["leaves"], extra=d.get("extra", {}))


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy of the leaf, its manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16), "bfloat16"
        a = t.to("cpu", copy=True).numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":  # 16-bit words, or a JAX-written ml_dtypes leaf
        return torch.from_numpy(np.asarray(arr, order="C").view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _manifest_ok(path: str) -> bool:
    """Cheap structural validation of a committed checkpoint directory: the
    manifest parses and every leaf file exists with at least its payload's
    bytes.  The CRCs are checked by :meth:`Checkpointer.restore`."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            man = CheckpointManifest.from_json(json.load(f))
        for leaf in man.leaves:
            fp = os.path.join(path, leaf["file"])
            if not os.path.isfile(fp) or os.path.getsize(fp) < int(leaf["nbytes"]):
                return False
        return True
    except (OSError, ValueError, KeyError, TypeError):
        return False


def list_checkpoints(root: str) -> List[str]:
    """Structurally valid checkpoint directories under ``root``, newest
    first; damaged ones are skipped."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m:
            steps.append((int(m.group(1)), os.path.join(root, name)))
    steps.sort(reverse=True)
    return [path for _, path in steps if _manifest_ok(path)]


def latest_checkpoint(root: str) -> Optional[str]:
    """Newest structurally valid checkpoint, or None."""
    ckpts = list_checkpoints(root)
    return ckpts[0] if ckpts else None


class Checkpointer:
    def __init__(self, root: str, keep: int = 3, mesh=None):
        self.root = root
        self.keep = keep
        #: the mesh whose ranks share this checkpointer (None: this process alone)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.writer = self.mesh is None or torch.distributed.get_rank() == 0
        os.makedirs(root, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # -- save -------------------------------------------------------------------
    def _write(self, step: int, host_leaves: List[Tuple[str, np.ndarray, str]], extra: dict) -> str:
        """Write and commit; each whole leaf is dropped from ``host_leaves``
        as soon as it is on disk."""
        final = os.path.join(self.root, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest_leaves = []
        while host_leaves:
            key, arr, dtype = host_leaves.pop(0)
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest_leaves.append(
                {
                    "key": key,
                    "file": fn,
                    "shape": list(arr.shape),
                    "dtype": dtype,
                    "crc32": zlib.crc32(arr.tobytes()),
                    "nbytes": int(arr.nbytes),
                }
            )
        man = CheckpointManifest(step=step, leaves=manifest_leaves, extra=extra)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(man.to_json(), f)
        if os.path.exists(final):  # a re-save of the same step replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _snapshot(self, state, specs) -> List[Tuple[str, np.ndarray, str]]:
        """Host copies of the whole leaves: on a mesh, gathered into the
        writer's memory leaf by leaf (every rank takes part; the others get
        an empty list)."""
        if self.mesh is None:
            return [(k, *_host(v)) for k, v in tree.items(state)]
        if specs is None:
            raise ValueError("a state sharded over ranks is saved with its specs")
        by_key = dict(spec_items(specs))
        out = []
        for k, v in tree.items(state):
            whole = gather_to_host(v, by_key[k], self.mesh)
            if whole is not None:
                out.append((k, *_host(whole)))
        return out

    def save(self, step: int, state, extra: Optional[dict] = None, specs=None) -> str:
        """Synchronous save of a tree of tensors or arrays (on a mesh, this
        rank's blocks under the matching tree of ``specs``); a failure left
        by an earlier ``save_async`` surfaces here first."""
        self.wait()
        host = self._snapshot(state, specs)
        path, err = os.path.join(self.root, f"step_{step}"), None
        if self.writer:
            try:
                with checkpoint_save_span(step, self.root, sum(a.nbytes for _, a, _ in host)):
                    path = self._write(step, host, extra or {})
            except Exception as e:
                err = e
        self._agree(err)
        if err is not None:
            raise err
        return path

    def save_async(self, step: int, state, extra: Optional[dict] = None, specs=None) -> None:
        """Copy to host (on a mesh, gather: every rank, before this returns),
        commit in the background; join with ``wait``.  A failed commit
        re-raises from the next ``wait``, ``save`` or ``save_async``."""
        self.wait()
        host = self._snapshot(state, specs)
        if not self.writer:
            return
        nbytes = sum(a.nbytes for _, a, _ in host)

        def commit():
            try:
                with checkpoint_save_span(step, self.root, nbytes):
                    self._write(step, host, extra or {})
            except BaseException as e:  # surfaced on the next wait()
                self._last_error = e

        self._pending = threading.Thread(target=commit, name="ckpt-commit", daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        err, self._last_error = self._last_error, None
        self._agree(err)
        if err is not None:
            raise RuntimeError(f"async checkpoint failed: {err!r}") from err

    def _agree(self, err: Optional[BaseException]) -> None:
        """On a mesh, every rank learns whether the writer's commit failed
        (``err`` on the writer), and the other ranks raise if it did."""
        if self.mesh is not None:
            (failed,) = C.any_rank(self.mesh, err is not None)
            if failed and err is None:
                raise RuntimeError("checkpoint commit failed on rank 0")

    def _gc(self) -> None:
        steps = sorted(int(_STEP_RE.match(n).group(1)) for n in os.listdir(self.root) if _STEP_RE.match(n))
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"), ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def restore(self, path: str, target, device=None, specs=None, mesh=None) -> Tuple[Any, CheckpointManifest]:
        """The leaves of ``target``'s structure (tensors, meta tensors or
        arrays; only their keys are read) from the checkpoint at ``path``,
        each checked against its manifest entry, as tensors on ``device``
        (default: each target leaf's device, the CPU for an array or a meta
        tensor).  With the matching tree of ``specs`` and a ``mesh``, each
        is this rank's block of the whole leaf under its spec on that mesh,
        whatever mesh wrote it; every rank reads the files."""
        if specs is not None and mesh is None:
            raise ValueError("a restore by specs names the mesh it restores onto")
        by_spec = dict(spec_items(specs)) if specs is not None else {}
        with checkpoint_restore_span(path) as span:
            with open(os.path.join(path, "manifest.json")) as f:
                man = CheckpointManifest.from_json(json.load(f))
            by_key = {leaf["key"]: leaf for leaf in man.leaves}
            keyed = list(tree.items(target))
            missing = [k for k, _ in keyed if k not in by_key]
            if missing:
                raise ValueError(f"checkpoint missing leaves: {missing[:5]}…")
            out = []
            for key, leaf in keyed:
                meta = by_key[key]
                arr = np.load(os.path.join(path, meta["file"]))
                if list(arr.shape) != meta["shape"] or zlib.crc32(arr.tobytes()) != meta["crc32"]:
                    raise ValueError(f"checkpoint leaf {key} failed integrity check")
                dev = device
                if dev is None:
                    dev = leaf.device if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta" else "cpu"
                if specs is None:
                    out.append(_tensor(arr, meta["dtype"], dev))
                    continue
                whole = _tensor(arr, meta["dtype"], "cpu")
                block = local_block(whole, by_spec[key], mesh)
                if isinstance(leaf, torch.Tensor) and tuple(block.shape) != tuple(leaf.shape):
                    raise ValueError(f"checkpoint leaf {key}: block {tuple(block.shape)} on this mesh, "
                                     f"target {tuple(leaf.shape)}")
                # a block smaller than the leaf is copied, so that the whole leaf is freed
                out.append(block.to(dev, copy=block.numel() < whole.numel()))
            span.outs["step"] = man.step
            return tree.unflatten(target, out), man
