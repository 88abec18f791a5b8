"""Checkpoint and resume of simulation state (port of
``chiron_tpu/checkpoint.py``).

The file layout is the JAX package's: one ``.npz`` holding the flattened
tree's leaves (``leaf_0``, ``leaf_1``, ...) and a JSON header (``treedef``,
``n_leaves``, ``metadata``), written atomically.  The tree is flattened as
JAX flattens it -- a dict by its sorted keys, a dataclass or a NamedTuple
by its fields, a list or a tuple in order, ``None`` an empty node -- and its
structure is written in JAX's ``PyTreeDef`` notation, so that each package
reads the other's files.  A tensor leaf is saved from the host and loaded onto the
device of the template's leaf.

One leaf cannot carry over: the PRNG key.  The port's is an integer and
JAX's a threefry ``uint32[2]``; a sampler checkpoint that JAX wrote loads
into the port with a key the caller passes (:func:`load_sampler_checkpoint`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# The tree: JAX's flattening order and notation
# ---------------------------------------------------------------------------


def _flatten(tree, leaves: List[Any]) -> str:
    """Append ``tree``'s leaves to ``leaves``; return its structure in
    JAX's ``PyTreeDef`` notation."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        items = [f"{k!r}: {_flatten(tree[k], leaves)}" for k in sorted(tree)]
        return "{" + ", ".join(items) + "}"
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(t, leaves) for t in tree]
        if hasattr(tree, "_fields"):   # a NamedTuple, such as TilePairList
            return (f"CustomNode(namedtuple[{type(tree).__name__}], "
                    f"[{', '.join(subs)}])")
        if isinstance(tree, list):
            return "[" + ", ".join(subs) + "]"
        return "(" + ", ".join(subs) + (",)" if len(subs) == 1 else ")")
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        subs = [_flatten(getattr(tree, f.name), leaves)
                for f in dataclasses.fields(tree)]
        return f"CustomNode({type(tree).__name__}[()], [{', '.join(subs)}])"
    leaves.append(tree)
    return "*"


def tree_flatten(tree) -> Tuple[List[Any], str]:
    """``(leaves, structure)`` of ``tree``, as ``jax.tree_util.tree_flatten``
    orders them."""
    leaves: List[Any] = []
    return leaves, f"PyTreeDef({_flatten(tree, leaves)})"


def _as_leaf(saved: np.ndarray, like):
    """A loaded array in the form of the template's leaf: a tensor on its
    device, an int, or a numpy array.  A key of another form (JAX's
    ``uint32[2]`` where the port's template holds an int) stays an array."""
    if torch.is_tensor(like):
        return torch.as_tensor(saved, device=like.device)
    if isinstance(like, (int, np.integer)) and not isinstance(like, bool):
        return int(saved) if saved.ndim == 0 else saved
    if isinstance(like, float):
        return float(saved)
    return saved


def _unflatten(like, leaves):
    """The tree of ``like`` with its leaves taken in order from the iterator
    ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(t, leaves) for t in like]
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return type(like)(**{f.name: _unflatten(getattr(like, f.name), leaves)
                             for f in dataclasses.fields(like)})
    return _as_leaf(next(leaves), like)


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool) and leaf >= 1 << 63:
        return np.asarray(leaf, dtype=np.uint64)
    return np.asarray(leaf)


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def save_checkpoint(
    path: str,
    state_tree: Any,
    metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Save a tree of tensors, arrays and scalars plus JSON metadata to
    ``path``.

    The write is atomic (a temporary file and ``os.replace``), so a crash
    mid-save never destroys the previous checkpoint at the same path; the
    path is used verbatim (``np.savez``'s ``.npz`` suffix is bypassed by
    writing through a file object).

    >>> save_checkpoint("run.ckpt.npz", {"sampler": sampler_state.as_data()},
    ...                 metadata={"iteration": 42, "seed": 1234})
    """
    leaves, treedef = tree_flatten(state_tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    header = {
        "treedef": treedef,
        "n_leaves": len(leaves),
        "metadata": metadata or {},
    }
    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8
    )
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def _header(path) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return json.loads(bytes(data["__header__"]).decode("utf-8"))


def load_checkpoint(path: str, like: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint: ``(state, metadata)``.

    With ``like``, a tree of the same structure (a freshly made state, say),
    the leaves are put back into that structure, each in the form of the
    template's leaf (a tensor on its device, an int, an array); the saved
    structure must equal the template's.  Without it, the flat list of
    numpy leaves is returned.
    """
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["__header__"]).decode("utf-8"))
        leaves = [data[f"leaf_{i}"] for i in range(header["n_leaves"])]
    metadata = header.get("metadata", {})
    if like is None:
        return leaves, metadata
    template_leaves, treedef = tree_flatten(like)
    if len(template_leaves) != len(leaves):
        raise ValueError(
            f"Checkpoint has {len(leaves)} leaves but the template "
            f"tree has {len(template_leaves)}"
        )
    # the leaf count alone cannot tell a velocities-but-no-box checkpoint
    # from a box-but-no-velocities template: compare the structures too
    saved_treedef = header.get("treedef")
    if saved_treedef is not None and saved_treedef != treedef:
        raise ValueError(
            "Checkpoint tree structure does not match the template:\n"
            f"  saved:    {saved_treedef}\n"
            f"  template: {treedef}"
        )
    return _unflatten(like, iter(leaves)), metadata


# ---------------------------------------------------------------------------
# Samplers and their moves
# ---------------------------------------------------------------------------


def _move_state(move) -> dict:
    """JSON restart state of an MCMC move: the acceptance statistics, the
    autotuned parameter and the attempt counters."""
    state = {
        "attempts": int(getattr(move, "_number_of_attempts_made", 0)),
        "move_iteration": int(getattr(move, "_move_iteration", 0)),
    }
    stats = getattr(move, "statistics", None)
    if isinstance(stats, dict):
        state["statistics"] = {k: int(v) for k, v in stats.items()}
    try:
        state["param"] = float(move._param_value())
    except (AttributeError, NotImplementedError):
        pass
    return state


def _restore_move_state(move, state: dict) -> None:
    move._number_of_attempts_made = int(state.get("attempts", 0))
    move._move_iteration = int(state.get("move_iteration", 0))
    if "statistics" in state and hasattr(move, "statistics"):
        move.statistics = {
            k: int(v) for k, v in state["statistics"].items()
        }
    if "param" in state and hasattr(move, "_set_param_value"):
        move._set_param_value(float(state["param"]))


def save_sampler_checkpoint(path, sampler_state, iteration=0, extra=None,
                            moves=None):
    """Persist a ``SamplerState`` (and counters) for a restart.

    ``moves`` (optional) is a ``{name: move}`` mapping: each move's
    acceptance statistics, autotuned parameter and attempt counters go into
    the metadata, so that a restart resumes the chain's tuning (pass the
    same mapping to :func:`load_sampler_checkpoint`)."""
    data = sampler_state.as_data()
    meta = {
        "iteration": int(iteration),
        # which optional fields are present, so that the restore matches
        # the leaves to fields rather than counting them
        "fields": {
            "velocities": data.velocities is not None,
            "box_vectors": data.box_vectors is not None,
        },
    }
    if moves:
        meta["moves"] = {name: _move_state(m) for name, m in moves.items()}
    if extra:
        meta.update(extra)
    save_checkpoint(path, data, metadata=meta)


def load_sampler_checkpoint(path, sampler_state, moves=None, key=None):
    """Restore a ``SamplerState`` in place from a checkpoint; returns the
    metadata.

    Pass the ``{name: move}`` mapping given to
    :func:`save_sampler_checkpoint` to restore each move's statistics,
    tuned parameter and attempt counters too.  The template's optional
    fields are filled to match the checkpoint's field header, so the leaves
    are matched by field and a mismatch raises; a checkpoint without that
    header falls back to the leaf count.

    ``key`` (an integer) replaces the saved PRNG key.  It is required for a
    checkpoint that the JAX package wrote: its key is a threefry
    ``uint32[2]``, which has no counterpart in the port's integer keys, so
    the positions, velocities, box, iteration and move statistics carry
    over and the caller names the key.
    """
    data_like = sampler_state.as_data()
    zeros = torch.zeros_like(data_like.positions)
    box0 = torch.zeros((3, 3), dtype=torch.float32,
                       device=data_like.positions.device)
    fields = _header(path).get("metadata", {}).get("fields")
    if fields is not None:
        if fields["velocities"] and data_like.velocities is None:
            data_like = dataclasses.replace(data_like, velocities=zeros)
        if fields["box_vectors"] and data_like.box_vectors is None:
            data_like = dataclasses.replace(data_like, box_vectors=box0)
        if not fields["velocities"] and data_like.velocities is not None:
            raise ValueError(
                "checkpoint has no velocities but the template state does; "
                "construct the template without velocities to restore"
            )
        if not fields["box_vectors"] and data_like.box_vectors is not None:
            raise ValueError(
                "checkpoint has no box vectors but the template state does; "
                "construct the template without box vectors to restore"
            )
    else:  # no field header: densify by the leaf count
        n_saved = _header(path)["n_leaves"]
        if len(tree_flatten(data_like)[0]) != n_saved \
                and data_like.velocities is None:
            data_like = dataclasses.replace(data_like, velocities=zeros)
        if len(tree_flatten(data_like)[0]) != n_saved \
                and data_like.box_vectors is None:
            data_like = dataclasses.replace(data_like, box_vectors=box0)
    data, meta = load_checkpoint(path, like=data_like)
    if key is not None:
        data = dataclasses.replace(data, key=int(key))
    elif not isinstance(data.key, int):
        raise ValueError(
            "the checkpoint's PRNG key is not an integer key of this package "
            f"(shape {np.shape(data.key)}, a JAX key): pass key=<int>"
        )
    sampler_state.update_from_data(data)
    if moves:
        saved_moves = meta.get("moves", {})
        for name, move in moves.items():
            if name in saved_moves:
                _restore_move_state(move, saved_moves[name])
    return meta
