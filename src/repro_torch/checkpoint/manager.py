"""Atomic, verified, topology-aware checkpoints. Twin of
``repro.checkpoint.manager``, with the same on-disk layout, so a checkpoint
written by either package is read by the other.

Layout (one directory per step):
    step_000000420/
      manifest.json        # step, time, per-leaf shapes and dtypes, the
                           # crc32 and byte count of every other file, meta
      arrays/<leaf>.npy    # one file per params leaf
      <group>/<leaf>.npy   # one file per leaf of each ``extra`` group
      topology/<layer>.npz # sparse element/block coordinates (SET state)

Leaf names are tree paths joined by ``__`` (``tree.tree_flatten_with_names``,
the names ``jax.tree_util`` gives the reference). A bfloat16 leaf is written
as the reference writes it, as raw 2-byte voids (``'<V2'``), and read back by
viewing its bytes as ``torch.bfloat16`` through ``int16``: numpy itself has
no bfloat16.

* ``save`` takes tensors (on any device) or numpy arrays. The device→host
  snapshot is taken synchronously, before the writer thread starts, so the
  thread touches only host copies and never a CUDA tensor or a buffer the
  caller may update next.
* Writes are atomic: a ``.tmp_step_*`` directory renamed into place once
  its manifest is written. Retention (``keep_last``) collects old steps only
  after a publish; tmp directories orphaned by a killed writer are swept
  when a manager is made.
* Integrity (DESIGN.md §8): ``verify_step`` re-reads every file against the
  manifest's crc32 and byte count; ``latest_valid_step`` scans backward past
  a bad step and moves it to ``quarantine/`` with a ``QUARANTINE_REASON.txt``
  and an ``obs`` point, ``checkpoint.quarantine``; ``restore`` verifies
  first and raises :class:`CheckpointCorruptError` naming the step and
  leaf.
* ``restore`` returns numpy leaves, as the reference does without
  ``shardings`` (a bfloat16 leaf as a CPU ``torch.bfloat16`` tensor), or
  tensors on ``device=``, or with ``shardings`` (``launch.sharding``
  layouts) each rank's shard of every leaf, a DTensor on the mesh.
* ``save_streamed``/``restore_stream`` write and read leaves chunk by chunk
  through ``.npy`` memmaps, for state larger than host memory (DESIGN.md §7).
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_flatten_with_names, tree_map

__all__ = ["CheckpointManager", "CheckpointCorruptError"]

Tree = Any
DeviceLike = Optional[Union[str, torch.device]]

_CRC_CHUNK = 4 << 20  # stream file checksums in 4 MiB slices
_BF16 = "bfloat16"


class CheckpointCorruptError(Exception):
    """A checkpoint failed integrity verification, or a leaf failed to load.

    Carries the offending step directory and, when known, the leaf file, so
    that a failed restore says which checkpoint and which array."""

    def __init__(self, step_dir, leaf: Optional[str] = None, reason: str = ""):
        self.step_dir = str(step_dir)
        self.leaf = leaf
        self.reason = reason
        where = f"{self.step_dir}" + (f" leaf {leaf!r}" if leaf else "")
        super().__init__(f"corrupt checkpoint at {where}: {reason}")


def _crc32_file(path: Path) -> tuple:
    """(crc32, n_bytes) of a file, streamed so huge leaves never load whole."""
    crc, n = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CRC_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)
    return crc, n


def _file_table(root: Path) -> Dict[str, Dict[str, int]]:
    """Relpath -> {crc32, bytes} for every file under ``root`` except the
    manifest (which is written after, and cannot checksum itself)."""
    out = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file() or p.name == "manifest.json":
            continue
        crc, n = _crc32_file(p)
        out[str(p.relative_to(root))] = {"crc32": crc, "bytes": n}
    return out


class _Snapshot:
    """A leaf's host copy, taken when ``save`` is called: ``array`` is what
    the file holds (a bfloat16 leaf's bytes as int16) and ``dtype`` the name
    the manifest records."""

    __slots__ = ("array", "dtype")

    def __init__(self, leaf):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            self.dtype = str(t.dtype).removeprefix("torch.")
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            # a CUDA tensor's .cpu() is a synchronous copy; a CPU tensor is
            # copied so that the caller may update it while the thread writes
            self.array = t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
        else:
            self.array = np.array(leaf)
            self.dtype = str(self.array.dtype)

    def write(self, path: Path) -> None:
        if self.dtype != _BF16:
            np.save(path, self.array)
            return
        # the reference's bytes: ml_dtypes' bfloat16 saves as '<V2'
        a = np.ascontiguousarray(self.array)
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
            f.write(a.tobytes())


def _snapshot_tree(tree: Tree):
    leaves, _ = tree_flatten_with_names(tree)
    return [(name, _Snapshot(leaf)) for name, leaf in leaves]


def _to_host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _like_dtype(leaf) -> Optional[str]:
    """A ``like`` leaf's dtype name, or None where it has none."""
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return None
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_last: int = 3
    async_write: bool = True

    def __post_init__(self):
        self.dir = Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # a writer that died mid-save (SIGKILL/preemption) leaves a tmp dir
        # behind; it was never published so it holds no recoverable state
        for tmp in self.dir.glob(".tmp_step_*"):
            shutil.rmtree(tmp, ignore_errors=True)

    # -- save ---------------------------------------------------------------

    def save(
        self,
        step: int,
        params: Tree,
        extra: Optional[Dict[str, Tree]] = None,
        topologies: Optional[Dict[str, Dict[str, Any]]] = None,
        meta: Optional[Dict] = None,
    ) -> None:
        """The snapshot is taken here, synchronously (a CUDA leaf's copy to
        the host); the file I/O happens on the writer thread when
        ``async_write``."""
        self.wait()
        host_tree = _snapshot_tree(params)
        host_extra = {k: _snapshot_tree(v) for k, v in (extra or {}).items()}
        host_topos = {
            lname: {k: np.array(_to_host(a)) for k, a in arrays.items()}
            for lname, arrays in (topologies or {}).items()
        }
        meta = json.loads(json.dumps(meta or {}))  # the caller may change its dicts next

        def write():
            tmp = self.dir / f".tmp_step_{step:09d}"
            final = self.dir / f"step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            (tmp / "arrays").mkdir(parents=True)
            shapes = {}
            for name, snap in host_tree:
                snap.write(tmp / "arrays" / f"{name}.npy")
                shapes[name] = [list(snap.array.shape), snap.dtype]
            for group, leaves in host_extra.items():
                (tmp / group).mkdir(exist_ok=True)
                for name, snap in leaves:
                    snap.write(tmp / group / f"{name}.npy")
            if host_topos:
                (tmp / "topology").mkdir(exist_ok=True)
                for lname, arrays in host_topos.items():
                    np.savez(tmp / "topology" / f"{lname}.npz", **arrays)
            manifest = {
                "step": step,
                "time": time.time(),
                "shapes": shapes,
                "files": _file_table(tmp),
                "meta": meta,
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic publish
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=self._guard(write), daemon=True)
            self._thread.start()
        else:
            write()

    def save_streamed(
        self,
        step: int,
        stream_groups: Dict[str, Dict[str, tuple]],
        meta: Optional[Dict] = None,
    ) -> None:
        """Incremental save for state larger than host memory headroom
        (DESIGN.md §7): each leaf arrives as ``(shape, dtype, chunk_iter)``,
        the iterator yielding consecutive axis-0 slices (numpy arrays or
        tensors), written straight into an on-disk ``.npy`` memmap: the
        working set is one chunk, and no snapshot copy is taken.

        Synchronous by design: the chunks read live training state, which
        the next step updates. The same atomic publish and retention as
        :meth:`save`."""
        self.wait()
        tmp = self.dir / f".tmp_step_{step:09d}"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        shapes: Dict[str, list] = {}
        for group, leaves in stream_groups.items():
            (tmp / group).mkdir(exist_ok=True)
            for name, (shape, dtype, chunks) in leaves.items():
                out = np.lib.format.open_memmap(
                    tmp / group / f"{name}.npy", mode="w+",
                    dtype=np.dtype(dtype), shape=tuple(shape),
                )
                pos = 0
                for c in chunks:
                    c = _to_host(c)
                    out[pos : pos + c.shape[0]] = c
                    pos += c.shape[0]
                if pos != shape[0]:
                    raise ValueError(
                        f"{group}/{name}: chunks covered {pos} of {shape[0]} rows"
                    )
                out.flush()
                del out
                shapes[f"{group}__{name}"] = [list(shape), str(np.dtype(dtype))]
        manifest = {
            "step": step,
            "time": time.time(),
            "shapes": shapes,
            "streamed_groups": sorted(stream_groups),
            "files": _file_table(tmp),
            "meta": meta or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def restore_stream(self, step: Optional[int], group: str, name: str) -> np.ndarray:
        """Read-only memmap view of one streamed leaf, which the restorer
        copies out chunk by chunk, so restore is as incremental as the save."""
        root = self._step_dir(step)
        path = root / group / f"{name}.npy"
        try:
            return np.load(path, mmap_mode="r")
        except Exception as e:  # noqa: BLE001 — numpy raises a zoo here
            raise CheckpointCorruptError(
                root, leaf=f"{group}/{name}.npy", reason=str(e)
            ) from e

    def _guard(self, fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        return run

    def wait(self) -> None:
        """Join the writer thread; raise what it raised, once."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def all_steps(self) -> List[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if p.is_dir()
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> Path:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return self.dir / f"step_{step:09d}"

    # -- integrity -----------------------------------------------------------

    def verify_step(self, step: int) -> Optional[str]:
        """None if the checkpoint is intact, else a human-readable reason.

        Checks: the manifest exists and parses; every file it recorded still
        exists with the recorded byte count and crc32. A checkpoint with no
        ``files`` table falls back to an existence check over ``shapes``."""
        root = self.dir / f"step_{step:09d}"
        mpath = root / "manifest.json"
        if not mpath.exists():
            return "manifest.json missing"
        try:
            manifest = json.loads(mpath.read_text())
        except (json.JSONDecodeError, OSError) as e:
            return f"manifest.json unreadable: {e}"
        files = manifest.get("files")
        if files is None:  # pre-checksum checkpoint: existence only
            streamed = manifest.get("streamed_groups")
            for name in manifest.get("shapes", {}):
                rel = (
                    name.replace("__", "/", 1) + ".npy"
                    if streamed
                    else f"arrays/{name}.npy"
                )
                if not (root / rel).exists():
                    return f"leaf {rel} missing"
            return None
        for rel, want in files.items():
            p = root / rel
            if not p.exists():
                return f"leaf {rel} missing"
            crc, n = _crc32_file(p)
            if n != want["bytes"]:
                return f"leaf {rel} truncated: {n} of {want['bytes']} bytes"
            if crc != want["crc32"]:
                return f"leaf {rel} checksum mismatch"
        return None

    def quarantine(self, step: int, reason: str = "") -> Path:
        """Move a bad step dir out of the ``step_*`` namespace, so that
        retention, ``latest_step`` and later scans never consider it again;
        the data is kept for post-mortem, with the reason beside it."""
        qdir = self.dir / "quarantine"
        qdir.mkdir(exist_ok=True)
        src = self.dir / f"step_{step:09d}"
        dst = qdir / f"step_{step:09d}"
        if dst.exists():
            shutil.rmtree(dst)
        src.rename(dst)
        (dst / "QUARANTINE_REASON.txt").write_text(reason + "\n")
        from repro_torch import obs
        obs.point("checkpoint.quarantine", step=step, reason=reason)
        return dst

    def latest_valid_step(self, quarantine: bool = True) -> Optional[int]:
        """Newest step that passes :meth:`verify_step`, scanning backward
        past corrupt or partial checkpoints (quarantining them by default):
        the restore entry a crash-recovery loop should use."""
        self.wait()
        for step in reversed(self.all_steps()):
            reason = self.verify_step(step)
            if reason is None:
                return step
            if quarantine:
                self.quarantine(step, reason)
        return None

    def read_manifest(self, step: Optional[int] = None) -> Dict:
        """The manifest only: lets a restorer learn the model's config and
        kind before it builds the ``like`` tree."""
        return json.loads((self._step_dir(step) / "manifest.json").read_text())

    def restore(
        self,
        step: Optional[int] = None,
        like: Optional[Tree] = None,
        shardings: Optional[Tree] = None,
        like_extra: Optional[Dict[str, Tree]] = None,
        verify: bool = True,
        device: DeviceLike = None,
    ):
        """``(params, extra, topologies, manifest)``. ``like`` gives the
        params tree's structure (its leaves' values are not read; only a
        bfloat16 leaf's dtype is); ``like_extra`` maps an extra group's name
        to its like tree, and groups not named stay on disk. Leaves come
        back as numpy arrays, a bfloat16 leaf as a CPU ``torch.bfloat16``
        tensor; with ``device``, every leaf as a tensor there. Topologies
        stay numpy.

        ``verify`` (default) runs :meth:`verify_step` first, so that a torn
        or bit-flipped checkpoint fails as :class:`CheckpointCorruptError`
        naming the step dir, not as a numpy error deep in a leaf load.
        ``shardings`` (a tree like ``like`` of ``launch.sharding.Layout``)
        re-shards each params leaf onto the current mesh: the full leaf is
        read, placed on ``device`` (default: the mesh's device type) and
        this rank's shard kept, a DTensor of that layout (an elastic resume
        onto another mesh)."""
        if shardings is not None and device is None:
            device = tree_flatten(shardings)[0][0].mesh.device_type
        root = self._step_dir(step)
        if verify:
            reason = self.verify_step(int(root.name.split("_")[1]))
            if reason is not None:
                raise CheckpointCorruptError(root, reason=reason)
        try:
            manifest = json.loads((root / "manifest.json").read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(root, leaf="manifest.json", reason=str(e)) from e
        device = None if device is None else torch.device(device)

        def load_leaf(sub: Path, name: str, like_leaf):
            path = sub / f"{name}.npy"
            try:
                arr = np.load(path)
            except Exception as e:  # noqa: BLE001 — numpy raises a zoo here
                raise CheckpointCorruptError(
                    root, leaf=str(path.relative_to(root)), reason=str(e)
                ) from e
            if arr.dtype.kind == "V":
                # bfloat16 and friends round-trip through numpy as raw voids
                if _like_dtype(like_leaf) == _BF16:
                    arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    arr = arr.view(np.asarray(like_leaf).dtype)
            if device is not None:
                arr = torch.as_tensor(arr).to(device)
            return arr

        def load_tree(sub: Path, like_tree: Tree):
            leaves, unflatten = tree_flatten_with_names(like_tree)
            return unflatten([load_leaf(sub, name, leaf) for name, leaf in leaves])

        params = load_tree(root / "arrays", like) if like is not None else None
        if params is not None and shardings is not None:
            params = tree_map(lambda lay, a: lay.distribute(a), shardings, params)
        extra = {group: load_tree(root / group, group_like)
                 for group, group_like in (like_extra or {}).items()}
        topologies = {}
        topo_dir = root / "topology"
        if topo_dir.exists():
            for f in sorted(topo_dir.glob("*.npz")):
                try:
                    with np.load(f) as z:
                        topologies[f.stem] = dict(z)
                except Exception as e:  # noqa: BLE001
                    raise CheckpointCorruptError(
                        root, leaf=f"topology/{f.name}", reason=str(e)
                    ) from e
        return params, extra, topologies, manifest
