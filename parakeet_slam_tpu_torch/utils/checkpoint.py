"""Checkpoint / resume for filter and backend state (port of
`parakeet_slam_tpu.utils.checkpoint`).

A snapshot is a plain `np.savez` archive of a state tree's leaves
(`leaf_{i}`), their paths (`__keys__`) and a step (`__step__`), published
atomically through `<path>.tmp.npz` and a rename. The tree is made of
dicts (keys taken in sorted order), dataclasses (fields in declaration
order) and leaves: tensors, numpy arrays and host ints. The paths are the
reference's letter for letter (`['state']/.lm_desc`), and so are the dtypes
on disk: a dataclass field whose metadata names an `npz_view` dtype (the
descriptor words, int32 here and uint32 there) is stored as a view of its
bits, and a host int (the pose graph's cursors) as a 0-d int32 array. So a
snapshot of the port and one of the reference can be diffed key by key;
`from_reference` carries one of the reference's across.
"""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import torch

# the path of a SLAMSystem snapshot's RNG leaf
KEY_LEAF = "['key']"


def _walk(node, path, out, view=None):
    """Append (key, leaf, npz_view dtype or None) of every leaf of `node`."""
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + [f"[{k!r}]"], out)
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _walk(getattr(node, f.name), path + [f".{f.name}"], out, f.metadata.get("npz_view"))
    else:
        out.append(("/".join(path), node, view))


def _flatten_with_paths(tree):
    """(keys, leaves, npz_view dtypes) of a state tree, in the reference's
    order (`jax.tree_util.tree_flatten_with_path`)."""
    flat = []
    _walk(tree, [], flat)
    return [k for k, _, _ in flat], [leaf for _, leaf, _ in flat], [v for _, _, v in flat]


def _to_numpy(leaf, view):
    if torch.is_tensor(leaf):
        arr = leaf.detach().cpu().numpy()
    elif isinstance(leaf, (int, np.integer)):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr.view(view) if view is not None else arr


def _from_numpy(arr, template, view):
    """A saved array in the form of its template leaf: a tensor on the
    template's device (descriptor words viewed back), a host int, or an
    array."""
    if torch.is_tensor(template):
        if view is not None:
            arr = arr.view(torch.empty(0, dtype=template.dtype).numpy().dtype)
        return torch.from_numpy(np.array(arr)).to(template.device)
    if isinstance(template, (int, np.integer)):
        return int(arr)
    return np.array(arr)


def _unflatten(template, leaves):
    """Rebuild `template`'s structure from an iterator over its new leaves."""
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    return next(leaves)


def _write_npz(path: str, arrays: dict):
    """`np.savez` to `<path>.tmp.npz`, then an atomic rename onto path."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, **arrays)
    Path(tmp).rename(path)


def save_checkpoint(path: str, tree, step: int = 0):
    """Save a state-tree snapshot; `step` is stored for resume bookkeeping."""
    keys, leaves, views = _flatten_with_paths(tree)
    arrays = {f"leaf_{i}": _to_numpy(v, view) for i, (v, view) in enumerate(zip(leaves, views))}
    arrays["__keys__"] = np.array(keys)
    arrays["__step__"] = np.array(step)
    _write_npz(path, arrays)


def load_checkpoint(path: str, template):
    """Load a snapshot into the structure of `template` (the same tree).

    Returns (tree, step). The leaf paths and shapes are checked against the
    template, so a config change that altered the state layout raises
    ValueError; tensors come back on the template leaves' devices."""
    data = np.load(path, allow_pickle=False)
    keys_saved = [str(k) for k in data["__keys__"]]
    keys_tmpl, leaves_tmpl, views = _flatten_with_paths(template)
    if keys_saved != keys_tmpl:
        raise ValueError(f"checkpoint layout mismatch: saved {keys_saved[:3]}... vs "
                         f"template {keys_tmpl[:3]}...")
    leaves = []
    for i, (tmpl_leaf, view) in enumerate(zip(leaves_tmpl, views)):
        arr = data[f"leaf_{i}"]
        shape = tuple(tmpl_leaf.shape) if hasattr(tmpl_leaf, "shape") else ()
        if arr.shape != shape:
            rng = (" (the RNG state: a snapshot resumes on a device of the type that wrote it, "
                   "and one of the JAX package's goes through from_reference first)"
                   if keys_tmpl[i] == KEY_LEAF else "")
            raise ValueError(f"checkpoint leaf {keys_tmpl[i]} shape {arr.shape} != "
                             f"template {shape}{rng}")
        leaves.append(_from_numpy(arr, tmpl_leaf, view))
    return _unflatten(template, iter(leaves)), int(data["__step__"])


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt_") -> str | None:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    cands = sorted(d.glob(f"{prefix}*.npz"))
    return str(cands[-1]) if cands else None


def from_reference(jax_prefix: str, out_prefix: str, generator: torch.Generator):
    """Rewrite a `SLAMSystem` snapshot written by the JAX package
    (`<jax_prefix>.state.npz` and `.kf.npz`) into this package's form at
    `out_prefix`, so that the port continues the reference's run: the
    filter-state and pose-graph leaves go through unchanged, the RNG leaf
    (`['key']`, a threefry key there) becomes `generator.get_state()`, and
    the keyframe file, whose layout both packages share, is copied. The
    reference's draws after the snapshot follow from its saved key; a
    caller that wants them injects them per frame."""
    data = np.load(jax_prefix + ".state.npz", allow_pickle=False)
    keys = [str(k) for k in data["__keys__"]]
    if KEY_LEAF not in keys:
        raise ValueError(f"{jax_prefix}.state.npz holds no {KEY_LEAF} leaf: "
                         "not a SLAMSystem snapshot")
    arrays = {name: data[name] for name in data.files}
    arrays[f"leaf_{keys.index(KEY_LEAF)}"] = generator.get_state().numpy()
    _write_npz(out_prefix + ".state.npz", arrays)
    shutil.copyfile(jax_prefix + ".kf.npz", out_prefix + ".kf.npz")
