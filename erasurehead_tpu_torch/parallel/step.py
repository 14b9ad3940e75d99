"""The coded gradient step on one device.

In the JAX package (erasurehead_tpu/parallel/step.py) the step is a
``shard_map`` over a worker mesh axis: each chip computes the slot gradients
of its logical workers, contracts them with the collection weights, and a
``psum`` over the worker axis decodes. On one card the W logical workers fold
onto the one device, so the ``psum`` is the identity and a round's device
work is one op: the decoded gradient of the whole stack.

The forms of that op, each a function ``(params, X, y, weights) -> grads``
(an [F] tensor for a GLM, a dict of tensors for the deep families):

  - :func:`make_faithful_grad_fn`: every worker computes each of its
    (possibly redundant) slot gradients of the worker-major [W, S, rows, F]
    stack, then the [W, S] slot weights contract them;
  - :func:`make_deduped_grad_fn`: every partition gradient of the
    partition-major [P, rows, F] stack once, contracted with the folded [P]
    partition weights;
  - :func:`make_fused_grad_fn`: either stack, leading dims flattened into M
    slots, through the one-pass kernel (ops/kernels.fused_glm_grad);
  - :func:`make_flat_grad_fn`: a closed-form GLM on any stack kind, the
    slot axes folded into the rows and the decode weights into the
    residual: one matvec/rmatvec pair (one scatter accumulator for a
    sparse stack);
  - :func:`make_margin_flat_grad_fn`: a closed-form GLM on a dense stack,
    one flat margin product and the per-slot weighted transpose;
  - :func:`make_layer_block_grad_fn`: per-layer (blockwise) gradient coding:
    per-slot gradient trees, every leaf decoded in place through one launch
    of the decode kernel a round (ops/kernels.fused_block_decode_leaves).

The first two are the monolithic PyTorch form, the counterpart of the JAX
package's own XLA lowering. For the autodiff families (``grads_via_loss``)
it is one ``torch.func.grad`` of the weighted summed loss, as in the JAX
package's ``_weighted_loss_grad`` (without its psum: one device).

Every body but the fused kernel's is wrapped by :func:`_dq`, so an int8
stack (ops/features.QuantizedStack) dequantizes at the top of the round and
every lowering below sees a dense stack; X may also be a PaddedRows or
FieldOnehot stack (ops/features.py).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from erasurehead_tpu_torch.ops import blocks as blocks_lib
from erasurehead_tpu_torch.ops import features as features_lib
from erasurehead_tpu_torch.ops import kernels

GradFn = Callable[..., object]  # (params, X, y, weights) -> [F] or dict


def _dq(body: GradFn) -> GradFn:
    """Dequantize a compressed stack (ops/features.QuantizedStack) at the
    top of a grad body: the int8 payload and its scales are what the stack
    holds, the float32 reconstruction a temporary of the round, and every
    lowering below sees the dense stack an uncompressed run would. The
    identity for every other stack."""

    def grad(params, Xs, ys, ws):
        return body(params, features_lib.maybe_dequantize(Xs), ys, ws)

    return grad


def _grads_via_loss(model) -> bool:
    return getattr(model, "grads_via_loss", False)


def _weighted_loss_grad(model, params, Xs, ys, ws, contract: str):
    """Gradient of sum_slots w_slot * loss_sum(params, X_slot, y_slot): the
    decoded gradient of an autodiff family in one backward pass (the JAX
    package's step._weighted_loss_grad on one device)."""

    def total(p):
        per = model.loss_sum
        for _ in contract:
            per = torch.func.vmap(per, in_dims=(None, 0, 0))
        return (ws.float() * per(p, Xs, ys)).sum()

    return torch.func.grad(total)(params)


def _weighted_sum(weights: torch.Tensor, grads: torch.Tensor, contract: str):
    """sum_i weights[i...] * grads[i..., :] over the leading axes."""
    return torch.einsum(f"{contract},{contract}f->f", weights, grads)


def make_faithful_grad_fn(model) -> GradFn:
    """Every logical worker computes all of its (redundant) slot gradients.

    Matches the reference's cost model: an FRC/MDS worker does (s+1)
    partitions' worth of matvec work each round.

    Args of the returned fn:
      params: [F] float32, or the deep families' dict of tensors.
      Xw, yw: worker-major stacks [W, S, rows, F] / [W, S, rows].
      slot_weights: [W, S] decode x coding weight per slot message.
    """

    def grad(params, Xw, yw, slot_weights):
        if _grads_via_loss(model):
            return _weighted_loss_grad(model, params, Xw, yw, slot_weights, "ws")
        per_slot = model.grad_sum(params, Xw, yw)  # [W, S, F]
        return _weighted_sum(slot_weights, per_slot, "ws")

    return _dq(grad)


def make_deduped_grad_fn(model) -> GradFn:
    """Each partition gradient once, combined with folded decode weights
    (CodingLayout.fold_slot_weights): the same decoded gradient as the
    faithful mode at 1/(s+1) the work.

    Args of the returned fn:
      params: [F] float32, or the deep families' dict of tensors.
      Xp, yp: partition-major stacks [P, rows, F] / [P, rows].
      part_weights: [P] folded per-partition weights.
    """

    def grad(params, Xp, yp, part_weights):
        if _grads_via_loss(model):
            return _weighted_loss_grad(model, params, Xp, yp, part_weights, "p")
        per_part = model.grad_sum(params, Xp, yp)  # [P, F]
        return _weighted_sum(part_weights, per_part, "p")

    return _dq(grad)


def _closed_form(model) -> bool:
    return hasattr(model, "margin_residual") and not _grads_via_loss(model)


# Whether margin_flat="auto" resolves to the hybrid lowering for dense
# closed-form stacks: off, as in the JAX package (its MARGIN_FLAT_DEFAULT).
MARGIN_FLAT_DEFAULT = False


def supports_margin_flat(model, X) -> bool:
    """The hybrid needs a closed-form GLM on a dense stack (an int8
    QuantizedStack counts: the body dequantizes first)."""
    return _closed_form(model) and isinstance(X, (torch.Tensor, features_lib.QuantizedStack))


def resolve_margin_flat(margin_flat: str, model, X) -> bool:
    if not supports_margin_flat(model, X):
        return False
    if margin_flat == "on":
        return True
    if margin_flat == "off":
        return False
    return MARGIN_FLAT_DEFAULT


def _hybrid_margin_flat_grad(model, params, Xs, ys, ws):
    """One flat [M*R, F] margin product, then the per-slot weighted
    transpose, for the worker-major [W, S, R, F] or partition-major
    [P, R, F] stack: the per-slot step's math in another reduction order."""
    R, F = ys.shape[-1], Xs.shape[-1]
    M = ys.numel() // R
    X3 = features_lib._f32(Xs.reshape(M, R, F))
    p = features_lib.matvec(X3.reshape(M * R, F), params)
    r = model.margin_residual(p, ys.reshape(M * R))
    wr = ws.reshape(M, 1) * r.reshape(M, R)
    return -torch.einsum("mrf,mr->f", X3, wr)


def make_margin_flat_grad_fn(model) -> GradFn:
    """The hybrid lowering as a drop-in for make_faithful_grad_fn /
    make_deduped_grad_fn on dense closed-form stacks (the caller gates on
    :func:`supports_margin_flat`)."""
    return _dq(functools.partial(_hybrid_margin_flat_grad, model))


# Whether flat_grad="auto" resolves to the flat lowering for dense and
# PaddedRows stacks: off, as in the JAX package (its FLAT_GRAD_DEFAULT);
# FieldOnehot stacks resolve flat (resolve_flat_grad).
FLAT_GRAD_DEFAULT = False


def supports_flat_grad(model, X) -> bool:
    """The flat lowering needs a closed-form GLM on any stack kind: dense,
    PaddedRows, FieldOnehot or a dense QuantizedStack."""
    return _closed_form(model) and isinstance(
        X, (torch.Tensor, features_lib.PaddedRows, features_lib.FieldOnehot,
            features_lib.QuantizedStack)
    )


def resolve_flat_grad(flat_grad: str, model, X) -> bool:
    """Should this run take the flat lowering? ("on" validity is the
    caller's concern: this resolves, it does not raise.) Under "auto" a
    FieldOnehot stack resolves flat, as in the JAX package (its per-slot
    form builds one scatter accumulator a slot); dense and PaddedRows
    stacks resolve per-slot (FLAT_GRAD_DEFAULT)."""
    if not supports_flat_grad(model, X):
        return False
    if flat_grad == "on":
        return True
    if flat_grad == "off":
        return False
    if isinstance(X, features_lib.FieldOnehot):
        return True
    return FLAT_GRAD_DEFAULT


def _flat_local_body(model) -> GradFn:
    """The whole stack as one flat operand (features.flatten_rows), the
    [M] slot weights folded into a per-row scale of the residual before the
    single transpose product:

        sum_s w_s * (-X_s^T r_s)  ==  -Xf^T (w_row * r)     (exact)
    """

    def grad(params, Xs, ys, ws):
        R = ys.shape[-1]
        M = ys.numel() // R
        Xf = features_lib.flatten_rows(Xs)
        wf = ws.reshape(M, 1).expand(M, R).reshape(M * R)
        r = model.margin_residual(features_lib.matvec(Xf, params), ys.reshape(M * R))
        return -features_lib.rmatvec(Xf, wf * r)

    return grad


def make_flat_grad_fn(model) -> GradFn:
    """The flat lowering as a drop-in for make_faithful_grad_fn (worker-major
    [W, S, rows, ...]) and make_deduped_grad_fn (partition-major
    [P, rows, ...]); the caller gates on :func:`supports_flat_grad`. Same
    math as the per-slot form in another reduction order."""
    return _dq(_flat_local_body(model))


def make_fused_grad_fn(kind: str) -> GradFn:
    """The one-pass kernel (ops/kernels.py) as a drop-in for either grad fn
    above on dense GLM stacks: the worker-major [W, S, rows, F] or the
    partition-major [P, rows, F] stack, leading dims flattened into kernel
    slots (views, no copy)."""

    def grad(params, Xs, ys, ws):
        M = int(np.prod(Xs.shape[:-2]))
        return kernels.fused_glm_grad(
            params,
            Xs.reshape((M,) + tuple(Xs.shape[-2:])),
            ys.reshape(M, -1),
            ws.reshape(M),
            kind,
        )

    return grad


# Whether layer_coding="auto" resolves to the blockwise decode: off, as in
# the JAX package (its step.LAYER_CODING_DEFAULT); "on" forces it.
LAYER_CODING_DEFAULT = False

# Whether block_decode="auto" takes the fused per-leaf lowering. The JAX
# package resolves "auto" through its tune plane and falls back to treewise;
# the tune plane is not ported, and the fused form is the one whose decode
# reads the leaves in place with no packed table, so "auto" is fused here.
BLOCK_DECODE_FUSED_DEFAULT = True

_MODEL_AXES = ("seq_axis", "tp_axis", "pp_axis", "ep_axis")


def supports_layer_coding(model) -> bool:
    """Can this model's gradients take the blockwise decode?

    Deviation from the JAX package, whose gate refuses every autodiff family
    on jax >= 0.6: there, per-slot ``jax.grad`` w.r.t. replicated params
    inside ``shard_map`` implicitly psums cotangents per slot position, so
    per-slot grads would double-count. The port runs on one device with no
    ``shard_map`` and no implicit psum: per-slot ``torch.func.grad`` is
    exact for every family it has (the GLMs, mlp, deepmlp, moe). The other
    JAX exclusion, model-internal mesh axes, stays; the port's models have
    none."""
    return all(getattr(model, ax, None) is None for ax in _MODEL_AXES)


def resolve_layer_coding(layer_coding: str, model) -> bool:
    """Should this run decode per layer block? ("on" validity is the
    caller's concern: this resolves the choice, it does not raise.)"""
    if not supports_layer_coding(model):
        return False
    if layer_coding == "on":
        return True
    if layer_coding == "off":
        return False
    return LAYER_CODING_DEFAULT


def resolve_block_decode(block_decode: str) -> bool:
    """Fused per-leaf decode (True) or the packed treewise table (False)?
    Both reduce through the same kernel in the same order, so they are
    bitwise equal: a pure lowering choice."""
    if block_decode == "fused":
        return True
    if block_decode == "treewise":
        return False
    return BLOCK_DECODE_FUSED_DEFAULT


def warm_autodiff() -> None:
    """Run ``torch.func``'s vmap and grad once on a tiny CPU input. Their
    first call imports their machinery, which takes seconds: set-up, to be
    paid before a timed round loop starts."""
    fn = torch.func.vmap(torch.func.grad(lambda a, b: (a * b).sum()), in_dims=(None, 0))
    fn(torch.zeros(1), torch.zeros(1, 1))


def per_slot_grads(model, params, Xs, ys, n_lead: int):
    """Every slot's gradient tree, leaves [*lead, *leaf_shape]: one
    ``model.grad_sum`` per slot under ``torch.func.vmap`` (params
    unbatched), the ``n_lead`` leading dims of the stack flattened into one
    batch dim for the vmap and restored after."""
    lead = tuple(ys.shape[:n_lead])
    M = int(np.prod(lead))
    Xf = features_lib.reshape_lead(Xs, (M,))
    yf = ys.reshape((M,) + tuple(ys.shape[n_lead:]))
    grads = torch.func.vmap(model.grad_sum, in_dims=(None, 0, 0))(params, Xf, yf)
    return blocks_lib.tree_map(lambda l: l.reshape(lead + tuple(l.shape[1:])), grads)


def _layer_block_body(model, spec, contract: str) -> GradFn:
    """Treewise lowering of the blockwise step (the JAX package's
    step._layer_block_local_body): every slot's gradient tree packs into the
    zero-padded [*lead, L, width] block table (ops/blocks.py), which decodes
    as a one-leaf table: one launch of the decode kernel a round."""

    def grad(params, Xs, ys, ws):
        grads = per_slot_grads(model, params, Xs, ys, len(contract))
        table = blocks_lib.tree_to_blocks(grads, spec)  # [*lead, L, width]
        (g,) = kernels.fused_block_decode_leaves(ws, [table])
        return blocks_lib.blocks_to_tree(g, spec)

    return grad


def _fused_layer_block_body(model, spec, contract: str) -> GradFn:
    """Fused lowering of the blockwise step (the JAX package's
    step._fused_layer_block_local_body): no block table; every leaf of the
    per-slot gradient tree, as ``per_slot_grads`` returns it, decodes in
    place in one launch of the decode kernel a round, leaves in sorted-key
    order. The same scalars meet in the same order as in the treewise
    lowering, so the two are bitwise equal."""

    def grad(params, Xs, ys, ws):
        grads = per_slot_grads(model, params, Xs, ys, len(contract))
        out = kernels.fused_block_decode_leaves(ws, blocks_lib.tree_leaves(grads))
        return blocks_lib.tree_unflatten(spec.keys, out)

    return grad


def make_layer_block_grad_fn(model, spec, *, faithful: bool, fused: bool) -> GradFn:
    """Per-layer (blockwise) decoded gradient: drop-in for
    make_faithful_grad_fn / make_deduped_grad_fn on any model, taking the
    faithful worker-major stack with [W, S] weights or the partition-major
    stack with [P] weights. ``fused`` picks the lowering
    (:func:`resolve_block_decode`); on CUDA both decode through the kernel."""
    contract = "ws" if faithful else "p"
    body = _fused_layer_block_body if fused else _layer_block_body
    return _dq(body(model, spec, contract))


def staleness_slot_params(params, stale_params, pipeline_depth: int):
    """The params a round's gradient is taken at: the live params of a
    synchronous run (``pipeline_depth=0``), or, pipelined (tau=1), the
    second slot of the trainer's carry: the params the round's workers were
    dispatched with (the iterate that entered the previous round)."""
    return stale_params if pipeline_depth else params


def expand_slot_weights(
    message_weights: np.ndarray, coeffs: np.ndarray, slot_is_coded: np.ndarray
) -> np.ndarray:
    """[R?, W] per-message decode weights -> [R?, W, S] per-slot weights
    (host float64, the single home of this rule).

    Coded slots are scaled by the message's decode weight; separate slots
    (partial schemes' uncoded first parts) always contribute with weight 1
    (src/partial_coded.py:187-190)."""
    a = np.asarray(message_weights)[..., :, None]
    return np.where(slot_is_coded, a * coeffs, coeffs)


# ---------------------------------------------------------------------------
# trajectory cohorts: one data stack serves B trajectories a round
# (train/trainer.train_cohort). Params and weights lead with the trajectory
# axis [B]; X and y are shared. Each returned fn maps
# (params_B, X, y, weights_B) -> the B decoded gradients, leaves [B, ...].


def supports_cohort_matmul(model, X) -> bool:
    """The dedicated cohort body needs a closed-form GLM on a dense stack
    (the support surface of the hybrid margin-flat lowering)."""
    return supports_margin_flat(model, X)


def cohort_matmul_grad_fn(model) -> GradFn:
    """Dense closed-form GLM cohort body (the JAX package's
    step._cohort_matmul_local_body): the B trajectories' parameter vectors
    stack into an [F, B] operand, so the margins of the whole cohort are
    one [N, F] x [F, B] product and the decoded gradients one
    -[B, N] x [N, F] product (N = every row of every slot), float32 with
    TF32 off. X is read twice a round for the whole cohort, where B
    sequential rounds read it B times; only the reduction order differs
    from B sequential steps.

    A bfloat16 stack is widened to float32 once a round, for both products
    (a copy of X at 6 bytes an element moved: the port's GLM products all
    compute in float32 on bfloat16 data, where the JAX package casts the
    params down and accumulates in float32)."""

    def grad(params_B, Xs, ys, ws_B):
        B = ws_B.shape[0]
        R, F = ys.shape[-1], Xs.shape[-1]
        M = ys.numel() // R
        X2 = Xs.reshape(M * R, F)
        if X2.dtype != torch.float32:
            X2 = X2.float()
        margins = X2 @ params_B.t()  # [N, B]
        r = model.margin_residual(margins, ys.reshape(M * R, 1))  # [N, B]
        w_rows = ws_B.reshape(B, M, 1).expand(B, M, R).reshape(B, M * R)
        return -((w_rows * r.t()) @ X2)

    return grad


def batched_grad_fn(body: GradFn) -> GradFn:
    """The per-slot cohort body (the JAX package's step._batched_local_body):
    ``torch.func.vmap`` of a one-trajectory grad fn over (params, weights),
    X and y unbatched, so the math is the sequential step's."""

    def grad(params_B, Xs, ys, ws_B):
        return torch.func.vmap(lambda p, w: body(p, Xs, ys, w))(params_B, ws_B)

    return grad


def _cohort_layer_block_body(model, spec, contract: str, fused: bool) -> GradFn:
    """Blockwise cohort body: every trajectory's per-slot gradient trees
    (:func:`per_slot_grads` under ``torch.func.vmap`` over the params),
    then one launch of the decode kernel a round for the whole cohort
    (ops/kernels.fused_block_decode_cohort): every leaf in place
    (``fused``) or the packed [B, *lead, L, width] block table (treewise),
    bitwise equal to each other as in the one-trajectory step. A leaf that
    the vmap returns non-contiguous is copied here, explicitly: the kernel
    reads leaves in place and its wrapper refuses any other."""

    def grad(params_B, Xs, ys, ws_B):
        grads = torch.func.vmap(
            lambda p: per_slot_grads(model, p, Xs, ys, len(contract))
        )(params_B)
        if fused:
            leaves = [leaf.contiguous() for leaf in blocks_lib.tree_leaves(grads)]
            out = kernels.fused_block_decode_cohort(ws_B, leaves, contract)
            return blocks_lib.tree_unflatten(spec.keys, out)
        table = blocks_lib.tree_to_blocks(grads, spec)  # [B, *lead, L, width]
        (g,) = kernels.fused_block_decode_cohort(ws_B, [table], contract)
        return blocks_lib.blocks_to_tree(g, spec)

    return grad


def make_cohort_grad_fn(
    model, params_template, X, *, faithful: bool, layer_coding: str,
    block_decode: str, flat_grad: str,
):
    """The cohort's gradient fn and the name of its lowering, picked as the
    JAX trainer picks them (trainer._train_cohort_impl):
      - "layer_block_vmap": ``layer_coding`` resolves on: per-slot trees
        under vmap, one decode launch a round for the cohort
        (``block_decode`` picks the fused or treewise lowering);
      - "cohort_matmul": a closed-form GLM on a dense stack
        (:func:`cohort_matmul_grad_fn`);
      - "flat_vmap": ``flat_grad`` resolves on for the stack
        (:func:`resolve_flat_grad`; a FieldOnehot stack under "auto"): the
        flat body under vmap;
      - "per_slot_vmap": otherwise, the compute mode's one-trajectory grad
        fn under vmap (:func:`batched_grad_fn`).
    ``params_template`` is one trajectory's params (the block spec of the
    layer-coded lowering); ``X`` the cohort's device stack. Every body
    dequantizes an int8 stack once a round for the whole cohort."""
    contract = "ws" if faithful else "p"
    if resolve_layer_coding(layer_coding, model):
        spec = blocks_lib.model_block_spec(model, params_template)
        fused = resolve_block_decode(block_decode)
        body = _cohort_layer_block_body(model, spec, contract, fused)
        return _dq(body), "layer_block_vmap"
    if supports_cohort_matmul(model, X):
        return _dq(cohort_matmul_grad_fn(model)), "cohort_matmul"
    if resolve_flat_grad(flat_grad, model, X):
        return _dq(batched_grad_fn(_flat_local_body(model))), "flat_vmap"
    body = make_faithful_grad_fn(model) if faithful else make_deduped_grad_fn(model)
    return batched_grad_fn(body), "per_slot_vmap"
