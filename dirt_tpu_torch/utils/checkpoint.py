"""Checkpoints of plain trees of tensors and arrays, as one ``.npz``.

Counterpart of ``dirt_tpu/utils/checkpoint.py``, in the same file layout:
``leaf_0`` .. ``leaf_{n-1}`` in the order ``jax.tree_util.tree_flatten``
gives a plain tree (dict items sorted by key, lists and tuples in order,
``None`` holding no leaf), and ``__treedef__``, the reference walker's JSON
description of the tree as uint8 bytes. So a file written by either
package loads in the other. The walker is the reference's own; it needs no
``jax.tree_util`` for plain trees, and this module walks the leaves with
it too.

A tree is nests of dict (string keys) / list / tuple / None with leaves
that are tensors (saved through ``.detach().cpu().numpy()``), numpy arrays
or scalars, or Python numbers, strings and bytes. Anything else raises
``TypeError`` rather than being walked wrongly, as do non-string dict
keys. NamedTuples load back as plain tuples. :func:`load_pytree` returns
numpy leaves; ``torch.as_tensor(leaf, device=...)`` puts one back on a
device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

_LEAF_TYPES = (
    torch.Tensor, np.ndarray, np.generic, int, float, bool, complex, bytes,
    str,
)


def save_pytree(path: str, tree) -> None:
    """Save a plain tree of tensors or arrays to ``path`` (.npz).

    Raises TypeError for containers outside dict/list/tuple/None or for
    non-string dict keys (see module docstring).
    """
    spec = _treedef_to_json(tree)
    leaves = []
    _leaves(tree, spec, leaves)
    arrays = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps(spec).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)


def load_pytree(path: str):
    """Load a tree saved by :func:`save_pytree` or by ``dirt_tpu``'s
    (numpy leaves)."""
    with np.load(path, allow_pickle=False) as data:
        spec = json.loads(bytes(data["__treedef__"].tobytes()).decode())
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]
    return _json_to_tree(spec, iter(leaves))


def _leaves(tree, spec, out) -> None:
    """Append the leaves of ``tree`` to ``out`` as numpy arrays, in the
    order of its description ``spec``."""
    kind = spec["__kind__"]
    if kind == "leaf":
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out.append(np.asarray(tree))
    elif kind == "dict":
        for key, sub in spec["items"].items():
            _leaves(tree[key], sub, out)
    elif kind in ("list", "tuple"):
        for item, sub in zip(tree, spec["items"]):
            _leaves(item, sub, out)


def _treedef_to_json(tree):
    if tree is None:
        # jax.tree_util treats None as an empty node (no leaf).
        return {"__kind__": "none"}
    if isinstance(tree, dict):
        bad = [k for k in tree if not isinstance(k, str)]
        if bad:
            raise TypeError(
                "save_pytree: dict keys must be strings (JSON would "
                f"stringify {bad[0]!r} and change the restored tree); "
                "convert keys before saving"
            )
        return {"__kind__": "dict",
                "items": {k: _treedef_to_json(v)
                          for k, v in sorted(tree.items())}}
    if isinstance(tree, (list, tuple)):
        # NamedTuples walk (and reload) as plain tuples — documented.
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_treedef_to_json(v) for v in tree]}
    if isinstance(tree, _LEAF_TYPES):
        return {"__kind__": "leaf"}
    raise TypeError(
        "save_pytree only handles plain dict/list/tuple/None trees with "
        f"tensor or array leaves; got a {type(tree).__name__} node. "
        "Convert other containers (an optimizer's state, a module) to "
        "plain dicts, lists and tuples first: any other walk would "
        "corrupt the leaf order."
    )


def _json_to_tree(spec, leaves_iter):
    kind = spec["__kind__"]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(leaves_iter)
    if kind == "dict":
        return {k: _json_to_tree(v, leaves_iter)
                for k, v in spec["items"].items()}
    items = [_json_to_tree(v, leaves_iter) for v in spec["items"]]
    return items if kind == "list" else tuple(items)
