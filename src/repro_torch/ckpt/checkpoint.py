"""Fault-tolerant checkpoints (port of ``repro.ckpt.checkpoint``), in the
reference's on-disk layout.

  * atomic -- written to ``<dir>/tmp.<step>``, then renamed to
    ``step_<10 digits>``: a crash mid-write never corrupts the latest
    checkpoint, and ``tmp.*`` never counts as one;
  * mesh-agnostic restore -- leaves are saved as full logical arrays (one
    ``{i:04d}_<name>.npy`` a leaf, named by its path), so a job restarts
    on another mesh and cuts its blocks on load (``restore(...,
    shardings=)``);
  * async -- ``save(..., blocking=False)`` copies every leaf to host
    memory before it returns (synchronously: the port's train step then
    updates the parameters and moments in place, which the reference's
    immutable state never does) and writes in a background thread;
  * manifest -- step, each leaf's name, path, shape and dtype in
    ``manifest.json``.

A state is nested dicts, lists and tensors; a ``Params`` in it reads as
the dict of its ``named_parameters`` (``train.step``'s layout of the
moments and of ``state_shardings``).  The leaves are taken in
``jax.tree`` order (dict keys sorted) and their paths written as
``jax.tree_util.keystr`` writes them (``['opt']['m']['layers.0.ln1']``),
so a state of the same layout gets the reference's manifest.  bfloat16
leaves are stored as their uint16 bits (the reference's ``ml_dtypes``
view), the manifest keeping the dtype ``"bfloat16"``.

Under a mesh, every rank calls ``save`` and ``restore``: save gathers the
blocks to full (``shardings``, from ``train.step.state_shardings``), and
only rank 0 of the default process group writes; every rank reads the
files and keeps its blocks.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")

# dtypes numpy has no type for: stored as a same-width unsigned view
# (torch has no uint16, so the bits pass through int16)
_VIEW = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16)}
_BY_NAME = {"bfloat16": (torch.bfloat16, np.int16)}


def _children(node):
    """[(key, child)] of a tree node in ``jax.tree`` order (a ``Params``
    as the dict of its ``named_parameters``), or None for a leaf."""
    if isinstance(node, nn.Module):
        return sorted(node.named_parameters())
    if isinstance(node, dict):
        return sorted(node.items())
    if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
        return list(enumerate(node))
    return None                   # a tensor, or a partition.Sharding


def _flatten(tree, path=()):
    """[(path keys, leaf)] in ``jax.tree`` order."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [x for k, v in kids for x in _flatten(v, path + (k,))]


def keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _leaf_name(path) -> str:
    return _SAFE.sub("_", keystr(path)).strip("_") or "leaf"


def _rebuild(like, leaves):
    """A tree of ``like``'s layout with the next of ``leaves`` at each
    leaf; a ``Params`` comes back as one, its gradients on where
    ``like``'s are."""
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, nn.Module):
        from ..models.transformer import params_from_named
        got = {k: _rebuild(v, leaves) for k, v in kids}
        out = params_from_named({n: got[n] for n, _ in
                                 like.named_parameters()})
        for (_, new), (_, old) in zip(out.named_parameters(),
                                      like.named_parameters()):
            new.requires_grad_(old.requires_grad)
        return out
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in kids}
    return type(like)(_rebuild(v, leaves) for _, v in kids)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor: synchronous, never a view of the tensor's
    storage (the state is updated in place after ``save`` returns)."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype in _VIEW:
        _, iv, nv = _VIEW[host.dtype]
        return host.view(iv).numpy().view(nv)
    return host.numpy()


def _dtype_name(dt: torch.dtype) -> str:
    if dt in _VIEW:
        return _VIEW[dt][0]
    return str(torch.empty(0, dtype=dt).numpy().dtype)


def _full_leaves(state, shardings):
    """[(path, leaf)] of the state, every leaf gathered from this rank's
    block to its full logical value under ``shardings`` (a collective on
    a mesh: every rank calls it)."""
    leaves = _flatten(state)
    if shardings is None:
        return leaves
    from ..sharding import spmd
    sh = _flatten(shardings)
    if [p for p, _ in sh] != [p for p, _ in leaves]:
        raise ValueError("the shardings' layout is not the state's")
    ctx = spmd.Ctx.of(sh[0][1].mesh)
    return [(p, spmd.gather(v.detach(), s.spec, ctx))
            for (p, v), (_, s) in zip(leaves, sh)]


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        if _writer():
            self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ---- save ---------------------------------------------------------
    def save(self, state: Any, step: int, blocking: bool = True,
             shardings: Any = None):
        """Write ``state`` as step ``step``.  With ``shardings`` (the
        state's blocks under a mesh) every rank calls this: the blocks
        are gathered, rank 0 writes.  The host copy of every leaf is
        complete when this returns, also with ``blocking=False``."""
        leaves = _full_leaves(state, shardings)
        if not _writer():
            return
        host = [(p, _to_numpy(v), _dtype_name(v.dtype)) for p, v in leaves]
        if self._thread is not None:
            self._thread.join()                 # one in-flight write max
            self._thread = None
        if blocking:
            self._write(host, step)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(host, step), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, host, step: int):
        tmp = self.dir / f"tmp.{step}"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (path, arr, dtype) in enumerate(host):
            name = f"{i:04d}_{_leaf_name(path)}"
            np.save(tmp / f"{name}.npy", arr, allow_pickle=False)
            manifest["leaves"].append(
                {"name": name, "path": keystr(path),
                 "shape": list(arr.shape), "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                  # atomic publish
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---- restore ------------------------------------------------------
    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None):
        """(state, step): the checkpoint (the latest when ``step`` is None)
        in the layout, dtypes and devices of ``like``.  ``shardings``: the
        current mesh's ``Sharding``s of ``like``'s leaves (which are then
        this rank's blocks), so a job restarts on another mesh."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = _flatten(like)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(f"{len(manifest['leaves'])} leaves in {d}, "
                             f"{len(leaves)} in the state")
        sh = None if shardings is None else [
            s for _, s in _flatten(shardings)]
        if sh is not None and len(sh) != len(leaves):
            raise ValueError("the shardings' layout is not the state's")
        ctx = None
        out = []
        for i, ((path, want), m) in enumerate(zip(leaves,
                                                  manifest["leaves"])):
            arr = np.load(d / f"{m['name']}.npy")
            if m["dtype"] in _BY_NAME:
                dt, iv = _BY_NAME[m["dtype"]]
                t = torch.from_numpy(arr.view(iv)).view(dt)
            else:
                t = torch.from_numpy(arr)
            if sh is not None:
                from ..sharding import spmd
                ctx = ctx or spmd.Ctx.of(sh[i].mesh)
                t = spmd.block(t, sh[i].spec, ctx)
            if tuple(t.shape) != tuple(want.shape):
                raise ValueError(f"{m['path']}: shape {tuple(t.shape)} in "
                                 f"the checkpoint, {tuple(want.shape)} in "
                                 f"the state")
            out.append(t.to(device=want.device, dtype=want.dtype,
                            copy=True).contiguous())
        return _rebuild(like, iter(out)), step
