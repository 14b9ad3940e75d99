"""Gradient block tables: params tree <-> zero-padded [L, width] block views.

The port of erasurehead_tpu/ops/blocks.py. Per-layer (blockwise) gradient
coding decodes each layer's flattened gradient block against the same
weights. A :class:`BlockSpec` describes how a model's parameter or gradient
tree flattens into a zero-padded block table and back, bijectively:
``blocks_to_tree(tree_to_blocks(g)) == g`` exactly (values are moved, never
transformed).

A tree is a dict of tensors (the deep families) or one tensor (a GLM's bare
[F] vector: one leaf, one block). Dict leaves go in **sorted-key order**,
the order in which JAX flattens a dict, so the block table, ``block_of`` and
the per-leaf decode order are the JAX package's (torch dicts keep insertion
order, so the order is made explicit here). Nested dicts are not taken.

Block granularity is per leaf, except that the keys a model names in
``block_split_leaves`` split along their leading axis, one block per slice:
DeepMLP's [n_layers, H, H] stack becomes one block per layer, MoE's
[n_experts, ...] stacks one block per expert.

``tree_to_blocks`` and ``blocks_to_tree`` carry leading batch dimensions
through: leaves [..., *leaf_shape] <-> table [..., n_blocks, width].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F_nn

__all__ = [
    "BlockSpec",
    "tree_leaves",
    "tree_unflatten",
    "tree_map",
    "block_spec",
    "model_block_spec",
    "tree_to_blocks",
    "blocks_to_tree",
    "partition_block_table",
]


def tree_leaves(tree) -> list:
    """The leaves of a params tree: a dict's values in sorted-key order, or
    the one tensor."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


def tree_unflatten(keys: Optional[Tuple[str, ...]], leaves):
    """Inverse of :func:`tree_leaves` for a tree whose sorted keys are
    ``keys`` (None: a bare tensor)."""
    if keys is None:
        (leaf,) = leaves
        return leaf
    return dict(zip(keys, leaves))


def tree_map(fn, tree, *rest):
    """``fn`` leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: fn(tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static description of a tree's block-table view.

    Leaf ``i`` (sorted-key order) contributes ``rows_per_leaf[i]``
    consecutive blocks of ``sizes_per_leaf[i]`` elements each (1 row = the
    whole leaf for unsplit leaves; split leaves contribute one row per
    leading-axis slice), each zero-padded to ``width`` = the largest block.
    ``keys`` is None for a bare tensor."""

    keys: Optional[Tuple[str, ...]]
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    rows_per_leaf: Tuple[int, ...]
    sizes_per_leaf: Tuple[int, ...]
    #: per block: (leaf index, row within the leaf)
    block_of: Tuple[Tuple[int, int], ...]
    width: int

    @property
    def n_blocks(self) -> int:
        return len(self.block_of)

    def leaf_offsets(self) -> np.ndarray:
        """[n_leaves + 1] block-row offsets of each leaf's slice."""
        return np.cumsum([0, *self.rows_per_leaf])


def block_spec(tree, split_leaves: Tuple[str, ...] = ()) -> BlockSpec:
    """The :class:`BlockSpec` of a parameter or gradient template (tensors
    or numpy arrays). ``split_leaves`` names dict keys whose leading axis
    splits into one block per slice."""
    keys = tuple(sorted(tree)) if isinstance(tree, dict) else None
    split_set = set(split_leaves)
    shapes, rows, sizes, block_of = [], [], [], []
    for li, leaf in enumerate(tree_leaves(tree)):
        if isinstance(leaf, dict):
            raise ValueError("block_spec: nested dicts are not taken")
        key = keys[li] if keys is not None else None
        shape = tuple(int(d) for d in np.shape(leaf))
        split = key in split_set and len(shape) >= 1 and shape[0] >= 1
        n_rows = shape[0] if split else 1
        size = int(np.prod(shape[1:] if split else shape, dtype=np.int64))
        if size == 0 or n_rows == 0:
            raise ValueError(
                f"block_spec: leaf {key or li} has zero-size shape {shape}"
            )
        shapes.append(shape)
        rows.append(n_rows)
        sizes.append(size)
        block_of.extend((li, r) for r in range(n_rows))
    return BlockSpec(
        keys=keys,
        leaf_shapes=tuple(shapes),
        rows_per_leaf=tuple(rows),
        sizes_per_leaf=tuple(sizes),
        block_of=tuple(block_of),
        width=max(sizes),
    )


def model_block_spec(model, params) -> BlockSpec:
    """The model's coded-block view of its params: per-leaf blocks, with the
    model's ``block_split_leaves`` split along their leading axis."""
    return block_spec(params, getattr(model, "block_split_leaves", ()))


def _lead(leaf: torch.Tensor, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    lead = tuple(leaf.shape[: leaf.dim() - len(shape)])
    if tuple(leaf.shape[len(lead):]) != shape:
        raise ValueError(
            f"leaf shape {tuple(leaf.shape)} does not end in the spec's {shape}"
        )
    return lead


def tree_to_blocks(tree, spec: BlockSpec) -> torch.Tensor:
    """Tree -> zero-padded ``[..., n_blocks, width]`` block table (inverse
    of :func:`blocks_to_tree`); leaves may carry leading batch dims."""
    leaves = tree_leaves(tree)
    if len(leaves) != len(spec.leaf_shapes):
        raise ValueError(
            f"tree_to_blocks: {len(leaves)} leaves vs spec's "
            f"{len(spec.leaf_shapes)}"
        )
    rows = []
    for leaf, shape, n_rows, size in zip(
        leaves, spec.leaf_shapes, spec.rows_per_leaf, spec.sizes_per_leaf
    ):
        flat = leaf.reshape(_lead(leaf, shape) + (n_rows, size))
        if size < spec.width:
            flat = F_nn.pad(flat, (0, spec.width - size))
        rows.append(flat)
    return torch.cat(rows, dim=-2)


def blocks_to_tree(table: torch.Tensor, spec: BlockSpec):
    """``[..., n_blocks, width]`` block table -> tree (drops the zero
    padding; inverse of :func:`tree_to_blocks`)."""
    if tuple(table.shape[-2:]) != (spec.n_blocks, spec.width):
        raise ValueError(
            f"blocks_to_tree: table shape {tuple(table.shape)} vs spec "
            f"[{spec.n_blocks}, {spec.width}]"
        )
    lead = tuple(table.shape[:-2])
    offsets = spec.leaf_offsets()
    leaves = [
        table[..., offsets[i]:offsets[i + 1], :size].reshape(lead + shape)
        for i, (shape, size) in enumerate(
            zip(spec.leaf_shapes, spec.sizes_per_leaf)
        )
    ]
    return tree_unflatten(spec.keys, leaves)


def partition_block_table(model, spec: BlockSpec, params, Xp, yp) -> np.ndarray:
    """Host-side ``[P, L, width]`` float64 table of per-partition gradient
    blocks at ``params``: the decoded gradient of block l under fold
    weights pw is ``pw @ table[:, l, :]``, the exact full gradient the same
    contraction with ``pw == 1``. ``Xp``/``yp`` are the partition-major
    stacks ([P, rows, F] / [P, rows]); one ``grad_sum`` per partition."""
    out = []
    for p in range(int(yp.shape[0])):
        g = model.grad_sum(params, Xp[p], yp[p])
        out.append(tree_to_blocks(g, spec).detach().cpu().double().numpy())
    return np.stack(out, axis=0)
