"""Scene-state checkpoints.

Port of `simple_mmd_renderer_tpu/utils/checkpoint.py`, in its file format,
so that a file written by either package loads in the other. The whole sim
state is a tree of tensors (the animation clock and every rigid body's
position, orientation and velocities), so save and restore are exact: a
paused simulation resumes bit for bit.

Format (v2): one .npz with a `__format_version__` marker and one array per
leaf, keyed by the leaf's key path as `jax.tree_util.keystr` names it
(``leaf:.time``, ``leaf:.physics.pos``: a dataclass field is ``.name``, a
sequence item ``[i]``, a dict entry ``['key']``). Loading matches leaves by
name against the template, so a reordered dataclass still loads, and a
renamed, added or removed field fails with an error naming the field.

Legacy v1 files (positional ``leaf_<i>`` and the reference's
``repr(treedef)``) load only when their ``__treedef__`` equals the repr JAX
gives the template's structure, which `treedef_repr` writes out for the
port's trees (dataclasses as the reference's flax dataclasses, dicts,
lists, tuples; pinned by a test against `repr(jax.tree.flatten(tree)[1])`);
any other v1 file is refused with the reference's message.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FORMAT_VERSION = 2
_LEAF_PREFIX = "leaf:"


def _leaf_paths(tree, path=""):
    """[(key path, tensor), ...] in flatten order."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _leaf_paths(getattr(tree, f.name),
                                        f"{path}.{f.name}")]
    if isinstance(tree, (tuple, list)):
        return [leaf for i, x in enumerate(tree)
                for leaf in _leaf_paths(x, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaf_paths(tree[k], f"{path}[{k!r}]")]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def _rebuild(tree, leaves):
    """`tree` with its tensors replaced by `leaves` (an iterator), in
    flatten order."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}


def _node_repr(tree) -> str:
    if isinstance(tree, torch.Tensor):
        return "*"
    if dataclasses.is_dataclass(tree):
        children = ", ".join(_node_repr(getattr(tree, f.name))
                             for f in dataclasses.fields(tree))
        return f"CustomNode({type(tree).__name__}[()], [{children}])"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_node_repr(tree[k])}"
                               for k in sorted(tree)) + "}"
    children = [_node_repr(x) for x in tree]
    if isinstance(tree, list):
        return "[" + ", ".join(children) + "]"
    return "(" + ", ".join(children) + ("," if len(children) == 1 else "") \
        + ")"


def treedef_repr(tree) -> str:
    """The repr JAX gives the structure of the reference's counterpart of
    `tree` (`repr(jax.tree.flatten(tree)[1])`): what a v1 checkpoint
    records."""
    return f"PyTreeDef({_node_repr(tree)})"


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty((), dtype=t.dtype).numpy().dtype


def save_state(path: str, state) -> None:
    """Serialize a SimState (or any tree of tensors) to an .npz file (one
    host read of every leaf)."""
    arrays = {}
    for name, leaf in _leaf_paths(state):
        key = _LEAF_PREFIX + name
        if key in arrays:
            raise ValueError(f"duplicate checkpoint leaf path {name!r}")
        arrays[key] = leaf.detach().cpu().numpy()
    arrays["__format_version__"] = np.asarray(FORMAT_VERSION, np.int32)
    np.savez(path, **arrays)


def _to_template(data, named, template):
    """The file's arrays `data` ([ndarray] in flatten order) as tensors on
    the template's devices, in the template's structure."""
    return _rebuild(template, iter(
        torch.as_tensor(np.array(a), device=old.device)
        for a, (_, old) in zip(data, named)))


def _load_v1(data, template):
    """Legacy positional format: load only when the treedef repr matches
    the template's."""
    named = _leaf_paths(template)
    saved_treedef = bytes(data["__treedef__"]).decode()
    if saved_treedef != treedef_repr(template):
        raise ValueError(
            "checkpoint is the legacy v1 format and its structure no longer "
            "matches the current SimState (fields were added, removed or "
            "reordered since it was written). v1 files cannot be migrated "
            "field-by-field — re-create the checkpoint with this version "
            "(saves now use the named v2 format).")
    restored = [np.asarray(data[f"leaf_{i}"]) for i in range(len(named))]
    for (_, old), new in zip(named, restored):
        if tuple(old.shape) != new.shape or _np_dtype(old) != new.dtype:
            raise ValueError(
                f"v1 checkpoint leaf mismatch: saved "
                f"{new.shape}/{new.dtype} vs template "
                f"{tuple(old.shape)}/{_np_dtype(old)}")
    return _to_template(restored, named, template)


def load_state(path: str, template):
    """Restore into the structure of `template` (a matching tree of
    tensors), on the template's devices.

    Leaves are matched by key path. Errors name the offending field: a
    leaf present in the file but not the template, a template field
    missing from the file, or a shape/dtype change on a matching field.
    """
    data = np.load(path)
    if "__format_version__" not in data.files:
        if "__treedef__" in data.files:
            return _load_v1(data, template)
        raise ValueError(
            f"{path!r} is not a checkpoint file (no format marker)")
    version = int(data["__format_version__"])
    if version > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format v{version} is newer than this build "
            f"(supports up to v{FORMAT_VERSION}) — update the renderer or "
            "re-save the checkpoint with the older build")

    named = _leaf_paths(template)
    saved_names = {k[len(_LEAF_PREFIX):] for k in data.files
                   if k.startswith(_LEAF_PREFIX)}
    want_names = [name for name, _ in named]
    missing = [n for n in want_names if n not in saved_names]
    unknown = sorted(saved_names - set(want_names))
    if missing or unknown:
        parts = []
        if missing:
            parts.append(
                "fields missing from the checkpoint (added to SimState "
                f"since it was saved?): {', '.join(missing)}")
        if unknown:
            parts.append(
                "checkpoint fields unknown to this SimState (removed or "
                f"renamed?): {', '.join(unknown)}")
        raise ValueError("checkpoint structure mismatch: " + "; ".join(parts))

    restored = []
    for name, old in named:
        new = np.asarray(data[_LEAF_PREFIX + name])
        if tuple(old.shape) != new.shape:
            raise ValueError(
                f"checkpoint field {name!r}: shape {new.shape} does "
                f"not match template {tuple(old.shape)}")
        if _np_dtype(old) != new.dtype:
            raise ValueError(
                f"checkpoint field {name!r}: dtype {new.dtype} "
                f"does not match template {_np_dtype(old)}")
        restored.append(new)
    return _to_template(restored, named, template)
