"""The port's gradient block tables against erasurehead_tpu/ops/blocks.py.

The same numpy templates (the JAX families' own draws, carried across) go
through both packages. The spec metadata must be equal, and the padded block
tables equal byte for byte: blocks move values, they never transform them.
Leaves go in sorted-key order in both (JAX flattens a dict that way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erasurehead_tpu.models.deep_mlp import DeepMLPModel as JDeepMLP
from erasurehead_tpu.models.glm import LogisticModel as JLogistic
from erasurehead_tpu.models.mlp import MLPModel as JMLP
from erasurehead_tpu.models.moe import MoEModel as JMoE
from erasurehead_tpu.ops import blocks as j_blocks
from erasurehead_tpu_torch.models.deep_mlp import DeepMLPModel
from erasurehead_tpu_torch.models.glm import LogisticModel, params_from_numpy
from erasurehead_tpu_torch.models.mlp import MLPModel
from erasurehead_tpu_torch.models.moe import MoEModel
from erasurehead_tpu_torch.ops import blocks

F = 16

CASES = {
    "deepmlp_L3": (lambda: JDeepMLP(hidden=8, n_layers=3), lambda: DeepMLPModel(hidden=8, n_layers=3)),
    "deepmlp_L5": (lambda: JDeepMLP(hidden=8, n_layers=5), lambda: DeepMLPModel(hidden=8, n_layers=5)),
    "moe_E4": (lambda: JMoE(hidden=8, n_experts=4), lambda: MoEModel(hidden=8, n_experts=4)),
    "mlp": (lambda: JMLP(hidden=8), lambda: MLPModel(hidden=8)),
    "glm": (None, LogisticModel),
}


def _templates(name, seed=0):
    """(JAX model, port model, JAX params, port params) from one draw; the
    GLM is a bare [F] vector."""
    j_make, t_make = CASES[name]
    if j_make is None:
        p = np.random.default_rng(seed).standard_normal(F).astype(np.float32)
        return None, t_make(), jnp.asarray(p), torch.from_numpy(p)
    jm = j_make()
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed), F))
    return jm, t_make(), jax.tree.map(jnp.asarray, jp), params_from_numpy(jp)


def _specs(name):
    jm, tm, jp, tp = _templates(name)
    jspec = j_blocks.model_block_spec(jm, jp) if jm else j_blocks.block_spec(jp)
    return jspec, blocks.model_block_spec(tm, tp), jp, tp


@pytest.mark.parametrize("name", sorted(CASES))
def test_spec_matches_jax(name):
    jspec, tspec, _, _ = _specs(name)
    assert tspec.n_blocks == jspec.n_blocks
    assert tspec.block_of == jspec.block_of
    assert tspec.width == jspec.width
    assert tspec.rows_per_leaf == jspec.rows_per_leaf
    assert tspec.sizes_per_leaf == jspec.sizes_per_leaf
    assert tspec.leaf_shapes == jspec.leaf_shapes
    assert list(tspec.leaf_offsets()) == list(jspec.leaf_offsets())


@pytest.mark.parametrize("name", sorted(CASES))
def test_table_matches_jax_byte_for_byte(name):
    jspec, tspec, jp, tp = _specs(name)
    want = np.asarray(j_blocks.tree_to_blocks(jp, jspec))
    got = blocks.tree_to_blocks(tp, tspec).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    # and the JAX table unpacks through the port into the same leaves
    back = blocks.blocks_to_tree(torch.from_numpy(want.copy()), tspec)
    for a, b in zip(blocks.tree_leaves(back), jax.tree.leaves(jp)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_is_exact_and_padding_zero(name):
    _, tspec, _, tp = _specs(name)
    table = blocks.tree_to_blocks(tp, tspec)
    assert tuple(table.shape) == (tspec.n_blocks, tspec.width)
    for bi, (li, _) in enumerate(tspec.block_of):
        assert (table[bi, tspec.sizes_per_leaf[li]:] == 0).all()
    back = blocks.blocks_to_tree(table, tspec)
    for a, b in zip(blocks.tree_leaves(back), blocks.tree_leaves(tp)):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_leading_batch_dims_round_trip():
    """Per-slot gradient trees [W, S, *leaf] pack into [W, S, L, width]
    with every slot's table equal to its own unbatched table."""
    _, tspec, _, tp = _specs("deepmlp_L3")
    batched = blocks.tree_map(
        lambda l: torch.stack([torch.stack([l * (w + 1) - s for s in range(2)]) for w in range(3)]),
        tp,
    )
    table = blocks.tree_to_blocks(batched, tspec)
    assert tuple(table.shape) == (3, 2, tspec.n_blocks, tspec.width)
    one = blocks.tree_to_blocks(blocks.tree_map(lambda l: l[2, 1], batched), tspec)
    assert torch.equal(table[2, 1], one)
    back = blocks.blocks_to_tree(table, tspec)
    for a, b in zip(blocks.tree_leaves(back), blocks.tree_leaves(batched)):
        assert torch.equal(a, b)


def test_layer_and_expert_blocks():
    """DeepMLP layers and MoE experts are individual blocks; the leaves
    come in sorted-key order."""
    _, tspec, _, _ = _specs("deepmlp_L5")
    assert tspec.keys == ("W", "W_in", "b", "b_in", "b_out", "w_out")
    assert tspec.rows_per_leaf == (5, 1, 5, 1, 1, 1)
    assert tspec.n_blocks == 5 + 5 + 4
    _, tspec, _, _ = _specs("moe_E4")
    assert tspec.keys == ("W1", "Wg", "b1", "b2", "bg", "w2")
    assert tspec.n_blocks == 4 * 4 + 2
    _, tspec, _, _ = _specs("glm")
    assert tspec.keys is None and tspec.n_blocks == 1 and tspec.width == F


def test_refuses_zero_size_and_nested_leaves():
    with pytest.raises(ValueError, match="zero-size"):
        blocks.block_spec({"a": torch.zeros(0, 3)})
    with pytest.raises(ValueError, match="nested"):
        blocks.block_spec({"a": {"b": torch.zeros(2)}})


@pytest.mark.parametrize("name", ["deepmlp_L3", "moe_E4", "glm"])
def test_partition_block_table_matches_jax(name):
    jm, tm, jp, tp = _templates(name)
    jspec = j_blocks.model_block_spec(jm, jp) if jm else j_blocks.block_spec(jp)
    tspec = blocks.model_block_spec(tm, tp)
    rng = np.random.default_rng(5)
    Xp = (rng.standard_normal((4, 12, F)) / 4).astype(np.float32)
    yp = np.sign(rng.standard_normal((4, 12))).astype(np.float32)
    want = j_blocks.partition_block_table(jm or JLogistic(), jspec, jp, jnp.asarray(Xp), jnp.asarray(yp))
    got = blocks.partition_block_table(tm, tspec, tp, torch.from_numpy(Xp), torch.from_numpy(yp))
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
