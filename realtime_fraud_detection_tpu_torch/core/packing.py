"""Transfer packing: collapse a [B, ...] dataclass tree into dense blobs.

Port of the JAX package's ``core/packing.py``. ``pack_tree`` runs on the host
in numpy: every float leaf goes into one f32[B, Wf] matrix, every int leaf
into i32[B, Wi], every bool leaf into u8[B, Wb], so a microbatch crosses to
the device as three buffers. ``unpack_tree`` slices the device tensors back
into the tree. Leaves are visited in dataclass field order, nested
dataclasses depth first, and None fields contribute no leaves: the blobs
are byte-identical to the JAX package's for the same batch.

A leaf given as a CPU ``torch.bfloat16`` tensor (numpy has no bfloat16)
rides a fourth, half-width blob, ``"bf16"``, held on the host as the int16
bit patterns and viewed back as bfloat16 by ``unpack_tree``: the JAX
package's bf16 wire blob, bit for bit. A tree without such a leaf packs into
the three blobs alone, with the same spec as before the fourth existed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_KIND_TO_BLOB = {
    "f": ("f32", np.float32),
    "i": ("i32", np.int32),
    "u": ("i32", np.int32),
    "b": ("u8", np.uint8),
}
BLOB_NAMES = ("f32", "i32", "u8")
BF16_BLOB = "bf16"
_BLOB_DTYPE = {"f32": np.float32, "i32": np.int32, "u8": np.uint8,
               BF16_BLOB: np.int16}
_LEAF = "leaf"

_TORCH_DTYPE = {
    "float32": torch.float32, "float64": torch.float64,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "bool": torch.bool, "int8": torch.int8, "int16": torch.int16,
    "bfloat16": torch.bfloat16,
}


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """Leaves of a dataclass tree in field order (None fields skipped) and
    a hashable description of its structure."""
    if tree is None:
        return [], None
    if not dataclasses.is_dataclass(tree):
        return [tree], _LEAF
    leaves: List[Any] = []
    children = []
    for f in dataclasses.fields(tree):
        sub_leaves, sub_def = tree_flatten(getattr(tree, f.name))
        leaves.extend(sub_leaves)
        children.append((f.name, sub_def))
    return leaves, (type(tree), tuple(children))


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """Inverse of ``tree_flatten``."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == _LEAF:
            return next(it)
        cls, children = d
        return cls(**{name: build(sub) for name, sub in children})

    return build(treedef)


def tree_map(fn, tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


class PackSpec:
    """Static, hashable description of a packed tree.

    ``entries[k] = (blob, offset, tail_shape, dtype_str)`` for leaf k in
    flatten order; ``widths[blob]`` is each blob's total column count.
    """

    __slots__ = ("treedef", "entries", "widths", "_hash")

    def __init__(self, treedef, entries: Tuple, widths: Tuple):
        self.treedef = treedef
        self.entries = entries
        self.widths = widths
        self._hash = hash((treedef, entries, widths))

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return (isinstance(other, PackSpec)
                and self.treedef == other.treedef
                and self.entries == other.entries
                and self.widths == other.widths)


def pack_tree(tree: Any) -> Tuple[Dict[str, np.ndarray], PackSpec]:
    """Host side: flatten a tree of [B, ...] numpy arrays into 3 blobs.

    Every leaf must share the leading batch dim B; ints must fit in int32.
    Returns ``({"f32": [B,Wf], "i32": [B,Wi], "u8": [B,Wb]}, spec)``; an
    empty blob is [B, 0]. CPU bfloat16 tensor leaves add the int16
    ``"bf16"`` blob.
    """
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("pack_tree: empty tree")
    b = int(np.shape(leaves[0])[0])
    names = BLOB_NAMES + (BF16_BLOB,)
    parts: Dict[str, list] = {name: [] for name in names}
    offsets = {name: 0 for name in names}
    entries = []
    for leaf in leaves:
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        arr = leaf.view(torch.int16).numpy() if bf16 else np.asarray(leaf)
        if arr.ndim == 0 or arr.shape[0] != b:
            raise ValueError(
                f"pack_tree: every leaf needs leading dim {b}, "
                f"got shape {arr.shape}")
        if not bf16 and arr.dtype.kind not in _KIND_TO_BLOB:
            raise ValueError(f"pack_tree: unsupported leaf dtype {arr.dtype}")
        blob, cast = (BF16_BLOB, np.int16) if bf16 else _KIND_TO_BLOB[arr.dtype.kind]
        if (blob == "i32" and arr.dtype.itemsize > 4 and arr.size
                and (arr.max() > np.iinfo(np.int32).max
                     or arr.min() < np.iinfo(np.int32).min)):
            raise ValueError(
                f"pack_tree: {arr.dtype} leaf exceeds int32 range "
                f"(min={arr.min()}, max={arr.max()})")
        tail = arr.shape[1:]
        width = int(math.prod(tail))
        parts[blob].append(
            np.ascontiguousarray(arr.reshape(b, width), dtype=cast))
        entries.append((blob, offsets[blob], tail,
                        "bfloat16" if bf16 else arr.dtype.name))
        offsets[blob] += width
    if not offsets[BF16_BLOB]:
        names = BLOB_NAMES
    blobs = {
        name: (np.concatenate(parts[name], axis=1) if parts[name]
               else np.zeros((b, 0), _BLOB_DTYPE[name]))
        for name in names
    }
    spec = PackSpec(treedef, tuple(entries), tuple(offsets[n] for n in names))
    return blobs, spec


def unpack_tree(blobs: Dict[str, torch.Tensor], spec: PackSpec,
                keep_u8: bool = False) -> Any:
    """Device side: slice the blob tensors back into the tree (views plus
    one dtype cast per leaf). With ``keep_u8`` bool leaves stay views of
    the u8 blob, so unpacking launches nothing (for a kernel that reads
    bytes). The bf16 blob may arrive as its int16 bit patterns: its leaves
    are bfloat16 views of them."""
    leaves = []
    for blob, offset, tail, dtype_name in spec.entries:
        width = int(math.prod(tail))
        col = blobs[blob][:, offset:offset + width]
        if col.dtype == torch.int16 and dtype_name == "bfloat16":
            col = col.view(torch.bfloat16)
        col = col.reshape((col.shape[0],) + tuple(tail))
        if keep_u8 and blob == "u8":
            leaves.append(col)
        else:
            leaves.append(col.to(_TORCH_DTYPE[dtype_name]))
    return tree_unflatten(spec.treedef, leaves)


def widen_bf16(tree: Any) -> Any:
    """bf16 was a wire format: the tree with its bfloat16 leaves widened
    back to f32."""
    return tree_map(lambda x: x.to(torch.float32) if x.dtype == torch.bfloat16 else x,
                    tree)
