"""Checkpoint / resume for pipeline and SLAM state.

The reference has no persistence at all — a page reload loses everything
(SURVEY.md §5.4). Here any pytree (BAState, keypoint buffers, pose
graphs, optimizer state) round-trips as one numpy ``.npz`` of leaves
plus a JSON file of their tree paths: one format on every machine,
depending on no optional package.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

# In-memory checkpoint store for ``mem://`` paths: the streaming SLAM
# session resumes the backend once per window, and a per-step disk
# checkpoint round-trip (write + read) would sit in the online step
# latency. A mem:// "directory" behaves
# like a rolling on-disk checkpoint but lives in this process. Flat
# dict trees only (the SLAM state is one); arrays are copied on save
# and restore so the store can never alias live mutable state.
_MEM_STORE: dict[str, dict] = {}


def checkpoint_exists(path: str) -> bool:
    """True if a checkpoint exists at ``path`` (disk or mem://)."""
    if path.startswith("mem://"):
        return path in _MEM_STORE
    return os.path.exists(path + ".npz") or (
        path.endswith(".npz") and os.path.exists(path)
    )


def remove_checkpoint(path: str) -> None:
    """Delete the checkpoint(s) under ``path`` (mem:// prefix or disk).

    A :class:`~..models.streaming.SlamSession` stores rolling state under
    one mem:// prefix; without eviction every finished session would leak
    its final pose/observation buffers in :data:`_MEM_STORE` for the life
    of the process.
    """
    if path.startswith("mem://"):
        prefix = path.rstrip("/") + "/"
        for key in [
            k for k in _MEM_STORE if k == path or k.startswith(prefix)
        ]:
            del _MEM_STORE[key]
        return
    stem = path[:-4] if path.endswith(".npz") else path
    for candidate in (stem + ".npz", stem + ".json"):
        if os.path.exists(candidate):
            os.remove(candidate)


def _flatten_with_paths(tree):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    paths = ["/".join(str(k) for k in path) for path, _ in flat]
    leaves = [leaf for _, leaf in flat]
    return paths, leaves, treedef


def save_checkpoint(path: str, tree, step: int | None = None) -> str:
    """Save a pytree checkpoint; returns the ``.npz`` path written.

    Leaves go to ``<path>/<name>.npz``, their tree paths to
    ``<path>/<name>.json``.
    """
    name = f"step_{step}" if step is not None else "state"
    if path.startswith("mem://"):
        key = path.rstrip("/") + "/" + name
        assert isinstance(tree, dict), "mem:// checkpoints take flat dicts"
        _MEM_STORE[key] = {k: np.array(v) for k, v in tree.items()}
        return key
    os.makedirs(path, exist_ok=True)
    ckpt_path = os.path.abspath(os.path.join(path, name))
    paths, leaves, _ = _flatten_with_paths(tree)
    np.savez(
        ckpt_path + ".npz",
        **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)},
    )
    with open(ckpt_path + ".json", "w") as f:
        json.dump({"paths": paths}, f)
    return ckpt_path + ".npz"


def restore_checkpoint_flat(path: str) -> dict:
    """Template-free restore of a checkpoint saved from a FLAT dict.

    Returns ``{key: np.ndarray}``. Used by SLAM resume (models/slam.py)
    where leaf shapes (observation counts, frame index) are unknown
    until the checkpoint is read, so no template pytree can exist.
    """
    if path.startswith("mem://"):
        return {k: np.array(v) for k, v in _MEM_STORE[path].items()}
    npz = path if path.endswith(".npz") else path + ".npz"
    data = np.load(npz)
    with open(npz[:-4] + ".json") as f:
        paths = json.load(f)["paths"]

    def clean(p):
        # Flat-dict key paths render as "['key']" via tree_flatten paths.
        return p[2:-2] if p.startswith("['") and p.endswith("']") else p

    return {clean(p): data[f"leaf_{i}"] for i, p in enumerate(paths)}


def restore_checkpoint(path: str, like):
    """Restore a checkpoint into the structure of ``like`` (a template
    pytree with correctly-shaped leaves)."""
    npz = path if path.endswith(".npz") else path + ".npz"
    data = np.load(npz)
    leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    treedef = jax.tree.structure(like)
    like_leaves = jax.tree.leaves(like)
    out = [
        jnp.asarray(v, l.dtype if hasattr(l, "dtype") else None)
        for v, l in zip(leaves, like_leaves)
    ]
    return jax.tree.unflatten(treedef, out)
