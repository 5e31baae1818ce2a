"""Checkpoint store: one .npy per leaf + JSON manifest, atomic, async.

The on-disk format is the JAX package's (``repro/checkpoint/ckpt.py``), so
a checkpoint written by either package restores in the other:

  * ``save`` writes ``<dir>/step_<n>.tmp`` then ``os.replace``s it to
    ``<dir>/step_<n>`` — a crash mid-save never corrupts the latest
    checkpoint, and ``latest_step`` only ever sees complete directories;
  * leaves are named by the JAX pytree paths: a dataclass field is
    ``.name``, a sequence item its index, a dict item its key (dict keys in
    sorted order), joined by ``/``; for a fleet, ``.layers/0/.hi`` ...
    ``.layers/0/.nnz``, ..., ``.spills``, ``.overflow``, ``.n_updates``,
    ``.n_updates_hi``.  Static fields (a hierarchy's ``cuts``, a
    ``vassoc.HierVec``'s too) are not leaves: they come from the template;
    a model's ``ParamTree`` is walked as its pytree (dict keys sorted,
    lists by index), so a training state ``dict(params, opt=dict(m, v,
    count), hier=HierEmbedState)`` has the reference's paths
    (``params/cross/0/w``, ``opt/m/table``,
    ``hier/.hier/.layers/0/.key``);
  * the port's int64 update counter is written as the reference's two
    words, ``.n_updates`` (uint32, the low 32 bits) and ``.n_updates_hi``
    (int32), and read back into one int64 (``hier.counter_words``);
  * bfloat16 leaves are written as the JAX package writes them, raw 2-byte
    words (numpy has no bfloat16), with ``bfloat16`` in the manifest.

``restore`` places each leaf on its template leaf's device, or on
``device``, or with ``shardings=`` under a ``distribution.sharding
.Sharding`` as the reference ``device_put``s it under a ``NamedSharding``:
each rank reads only its block of the leaf from disk (a memory-mapped
``.npy``) and keeps it as a DTensor on the mesh's device, with no
collective.  Restoring a checkpoint written from the card onto the CPU,
onto a mesh, or onto another instance count followed by
``runtime.elastic.rebalance_instances``, is the same code path.
``AsyncCheckpointer`` copies the state to the host synchronously, then
writes on a background thread.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.analysis import contracts
from repro_torch.core import hier, vassoc
from repro_torch.core.hier import HierAssoc
from repro_torch.distribution import sharding as sharding_mod
from repro_torch.models import common

_MANIFEST = "manifest.json"

# Leaf names (last path component) that may legitimately be absent from an
# old checkpoint's manifest: state fields added after the checkpoint format
# shipped.  restore() falls back to the template value for these ONLY.
MIGRATED_LEAVES = frozenset({
    "n_updates_hi",      # the 64-bit update counter's high word (HierAssoc)
})


def _join(path: str, part: str) -> str:
    return f"{path}/{part}" if path else part


def _walk(node, path: str, fn: Callable) -> Any:
    """Rebuild ``node`` with ``fn(path, leaf, disk_dtype)`` in place of
    every leaf, in the JAX package's leaf order.  ``disk_dtype`` is the
    numpy dtype a leaf is stored as when it differs from the leaf's own
    (the counter's low word, held in an int64)."""
    if isinstance(node, HierAssoc):
        lo, hi = hier.counter_words(node)
        layers = _walk(node.layers, _join(path, ".layers"), fn)
        spills = fn(_join(path, ".spills"), node.spills, None)
        overflow = fn(_join(path, ".overflow"), node.overflow, None)
        lo = fn(_join(path, ".n_updates"), lo, np.uint32)
        hi = fn(_join(path, ".n_updates_hi"), hi, None)
        # a product, not a shift: DTensor (a restore under shardings) has
        # no rule for ``<<`` and returns its operand unshifted
        n = hi.to(torch.int64) * (1 << 32) + lo.to(torch.int64)
        return HierAssoc(layers=layers, spills=spills, overflow=overflow,
                         n_updates=n, cuts=node.cuts)
    if isinstance(node, vassoc.HierVec):
        return vassoc.HierVec(
            layers=_walk(node.layers, _join(path, ".layers"), fn),
            spills=fn(_join(path, ".spills"), node.spills, None),
            overflow=fn(_join(path, ".overflow"), node.overflow, None),
            n_updates=fn(_join(path, ".n_updates"), node.n_updates, None),
            cuts=node.cuts)
    if isinstance(node, nn.Module):                 # a ParamTree
        return common.with_leaves(
            node, _walk(common.to_tree(node), path, fn))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return type(node)(**{
            f.name: _walk(getattr(node, f.name), _join(path, f".{f.name}"),
                          fn)
            for f in dataclasses.fields(node)})
    if isinstance(node, dict):
        out = {k: _walk(node[k], _join(path, str(k)), fn)
               for k in sorted(node)}
        return {k: out[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(x, _join(path, str(i)), fn)
                          for i, x in enumerate(node))
    if node is None:
        return None
    return fn(path, node, None)


def _flatten(tree) -> list:
    """(path, leaf, disk dtype) of every leaf, in the JAX package's order
    and with its path names."""
    out = []
    _walk(tree, "", lambda p, x, d: out.append((p, x, d)) or x)
    return out


def _host_copy(x):
    """A host copy of a leaf that later in-place updates cannot reach
    (``.cpu()`` of a CPU tensor would share its storage)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True) if isinstance(x, np.ndarray) else x


def _to_numpy(x, disk_dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        x = x.numpy()
    arr = np.asarray(x)
    return arr.astype(disk_dtype) if disk_dtype is not None else arr


def _dtype_name(arr: np.ndarray, leaf) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None
         ) -> str:
    """Atomically persist ``tree`` as ``<ckpt_dir>/step_<step>``."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = dict(step=step, leaves=[], extra=extra or {})
    for i, (path, leaf, disk_dtype) in enumerate(_flatten(tree)):
        arr = _to_numpy(leaf, disk_dtype)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            dict(path=path, file=fname, shape=list(arr.shape),
                 dtype=_dtype_name(arr, leaf)))
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _as_template(arr: np.ndarray, tmpl, device):
    """A loaded array in the template leaf's type, dtype and device."""
    if isinstance(tmpl, torch.Tensor):
        dev = tmpl.device if device is None else device
        if tmpl.dtype == torch.bfloat16 and arr.dtype.kind == "V":
            t = torch.from_numpy(np.array(arr.view(np.int16), order="C")) \
                .view(torch.bfloat16)
        elif tmpl.dtype == torch.bfloat16:
            t = torch.from_numpy(np.array(arr, np.float32, order="C"))
        else:
            want = torch.empty((), dtype=tmpl.dtype).numpy().dtype
            t = torch.from_numpy(np.array(arr, want, order="C"))
        return t.to(device=dev, dtype=tmpl.dtype)
    if isinstance(tmpl, np.ndarray):
        return arr.astype(tmpl.dtype)
    return arr


def _sharding_lookup(shardings) -> Callable:
    """path -> Sharding, from one ``Sharding`` for every leaf or from
    nested dicts/lists of them in the template's nesting (as
    ``sharding.to_shardings`` gives for a ``ParamTree``)."""
    if isinstance(shardings, sharding_mod.Sharding):
        return lambda path: shardings
    by_path = {}

    def walk(node, path):
        if isinstance(node, sharding_mod.Sharding):
            by_path[path] = node
            return
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            walk(v, _join(path, str(k)))

    walk(shardings, "")

    def lookup(path):
        if path not in by_path:
            raise KeyError(f"no sharding for checkpoint leaf {path!r}")
        return by_path[path]
    return lookup


def restore(ckpt_dir: str, step: int, template: Any, device=None,
            shardings: Any = None) -> Any:
    """Rebuild a ``template``-shaped tree from ``<ckpt_dir>/step_<step>``.

    Each tensor leaf takes its template leaf's dtype and device (``device``
    overrides the device, and raises when it names CUDA and there is
    none): restoring onto the CPU, or onto the card, is the same code
    path.  A leaf named in ``MIGRATED_LEAVES`` that the manifest
    lacks keeps its template value, with a warning; any other missing leaf
    raises ``KeyError``.

    ``shardings`` (one ``Sharding`` for every leaf, or a tree of them in
    the template's nesting) makes each tensor leaf a DTensor: the rank
    reads its block of the leaf from disk and keeps exactly that, on the
    mesh's device (the card unless the mesh is a CPU mesh); no collective
    is made.  The template gives dtypes and shapes only there (it may be
    on ``meta``).  ``device`` and ``shardings`` together raise.

    Under ``REPRO_CHECK=1`` the rebuilt tree is validated against the
    canonical-form and counter contracts before the restore returns
    (``contracts.validate_restored``; under ``shardings`` on each rank's
    blocks): a corrupted or hand-edited checkpoint fails here, naming the
    violated invariant.
    """
    if device is not None and shardings is not None:
        raise ValueError("restore places leaves on a device or under "
                         "shardings, not both")
    if device is not None:
        device = resolve_device(device)
    shard_for = None if shardings is None else _sharding_lookup(shardings)
    shapes = {}
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    by_path = {l["path"]: l for l in manifest["leaves"]}

    def load(path, tmpl, disk_dtype):
        info = by_path.get(path)
        if info is None:
            # Schema migration, allow-listed only: a leaf ADDED to a state
            # dataclass after the checkpoint was written keeps its template
            # value, so old checkpoints restore losslessly.  Any other
            # missing path fails hard — a truncated manifest or renamed
            # leaf must not silently resume from template state.
            leaf_name = path.rsplit("/", 1)[-1].lstrip(".")
            if leaf_name not in MIGRATED_LEAVES:
                raise KeyError(
                    f"checkpoint leaf {path!r} missing from manifest and "
                    f"not a known schema migration {sorted(MIGRATED_LEAVES)}")
            warnings.warn(f"[ckpt] migrating old checkpoint: leaf {path!r} "
                          f"absent from manifest, keeping template value")
            arr = _to_numpy(tmpl)
        else:
            arr = np.load(os.path.join(d, info["file"]),
                          mmap_mode=None if shard_for is None else "r")
        if shard_for is None or not isinstance(tmpl, torch.Tensor):
            return _as_template(np.asarray(arr), tmpl, device)
        sharding = shard_for(path)
        shapes[path] = arr.shape
        block = arr[sharding_mod.local_slices(arr.shape, sharding)]
        return _as_template(block, tmpl,
                            sharding_mod.mesh_device(sharding.mesh))

    out = _walk(template, "", load)
    if contracts.enabled():
        contracts.validate_restored(out, name=f"restore step_{step}")
    if shard_for is not None:
        out = _walk(out, "", lambda path, x, _: sharding_mod.from_shard(
            x, shard_for(path), shapes[path]) if path in shapes else x)
    return out


class AsyncCheckpointer:
    """Snapshot-now, write-later checkpointer (overlaps I/O with compute)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()                                 # one in flight at a time
        host_tree = _walk(tree, "", lambda p, x, d: _host_copy(x))

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except BaseException as e:      # pragma: no cover - surfaced
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)
