"""The coded gradient step over the worker mesh.

In the JAX package (erasurehead_tpu/parallel/step.py) the step is a
``shard_map`` over a worker mesh axis: each chip computes the slot gradients
of its logical workers, contracts them with the collection weights, and a
``psum`` over the worker axis decodes. Here each process of the worker mesh
(parallel/mesh.py) holds its rank's slice of the stack and of the weights,
computes the local decoded gradient of that slice, and one
``all_reduce(SUM)`` over the group follows at exactly the places where the
JAX package psums (:func:`_psum`; ranks outside the worker group contribute
zeros). With no process group (``mesh`` None, or a mesh of world size 1
without a group) the W logical workers fold onto the one device, the
``psum`` is the identity and a round's device work is one op: the decoded
gradient of the whole stack.

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
package's ``_weighted_loss_grad`` (its psum is the factory's all-reduce).

Under a model-internal axis (a model made by ``for_mesh`` on a 2-D mesh:
tensor-, pipeline-, expert- or sequence-parallel, parallel/mesh.py) the
forward runs collectives, which ``torch.func`` cannot trace. The rank's
slots then flatten into one batch, so every collective runs once for the
whole batch, and one ``torch.autograd.grad`` of the weighted per-slot loss
sums gives the rank's gradient (:func:`_axis_grad_body`). The backward of the
forward's sum all-reduce all-reduces the cotangent, so every member of an
axis, computing the same loss, would get the axis size times its share: the
JAX package's explicit recipe (its ``_weighted_loss_grad`` without the
implicit psum) undoes that, scaling the loss by 1/axis size and then summing
every leaf over both mesh axes, which here is the factory's one all-reduce
over the world.

The faithful mode's ring transport (``stack_mode="ring"``,
:func:`make_ring_faithful_grad_fn`) keeps only the partition-major stack and
rebuilds each rank's worker-major slot buffer every round over ring hops
between the ranks (:func:`_ring_fill`), then runs any of the bodies above on
it; at world size 1 the plan has one hop and the fill is a local gather.

The bodies name their phases as the JAX package's do (utils/tracing.annotate,
host spans of a ``--trace-dir`` trace): ``eh_step/partial_grads`` around the
slot gradients, ``eh_step/decode`` around their weighted contraction.

Every body but the fused kernel's is wrapped by :func:`_dq`, so an int8
stack (ops/features.QuantizedStack) dequantizes at the top of the round and
every lowering below sees a dense stack; X may also be a PaddedRows or
FieldOnehot stack (ops/features.py).
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import numpy as np
import torch

from torch.utils import _pytree as pytree

from erasurehead_tpu_torch.ops import blocks as blocks_lib
from erasurehead_tpu_torch.ops import features as features_lib
from erasurehead_tpu_torch.ops import kernels
from erasurehead_tpu_torch.utils.tracing import annotate

GradFn = Callable[..., object]  # (params, X, y, weights) -> [F] or dict


def _psum(body: GradFn, mesh) -> GradFn:
    """``body``'s local decoded gradient summed over the worker mesh: the
    JAX package's ``lax.psum(g, WORKER_AXIS)`` as one all-reduce
    (mesh.WorkerMesh.all_reduce). A rank outside the worker group holds no
    slots and contributes zeros shaped like the params (a cohort's
    ``params_B``). The body itself without a process group."""
    if mesh is None or not mesh.distributed:
        return body

    def grad(params, Xs, ys, ws):
        if mesh.member:
            g = body(params, Xs, ys, ws)
        else:
            g = blocks_lib.tree_map(torch.zeros_like, params)
        with annotate("eh_step/decode"):
            return mesh.all_reduce(g)

    return grad


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


def _on_model_axis(model) -> bool:
    """Does this model run a model-internal mesh axis (a ``for_mesh`` copy)?"""
    return any(getattr(model, ax, None) is not None for ax in _MODEL_AXES)


def _axis_grad_body(model, contract: str) -> GradFn:
    """The rank's share of the decoded gradient of a model on a
    model-internal axis (module docstring): the stack's ``contract`` slot
    dims flatten into one, the weighted per-slot loss sums, scaled by
    1/axis size, take one backward pass through the forward's collectives.
    Summed over the world by the factory's all-reduce, the shares are the
    decoded gradient."""
    shards = model.mesh.shards

    def grad(params, Xs, ys, ws):
        lead = tuple(ys.shape[:len(contract)])
        M = int(np.prod(lead))
        X = features_lib.reshape_lead(Xs, (M,))
        y = ys.reshape((M,) + tuple(ys.shape[len(contract):]))
        leaves, spec = pytree.tree_flatten(params)
        with annotate("eh_step/partial_grads"), torch.enable_grad():
            live = [leaf.detach().requires_grad_() for leaf in leaves]
            per_slot = model.row_losses(pytree.tree_unflatten(live, spec), X, y).sum(-1)
            total = (ws.reshape(M).float() * per_slot).sum() / shards
            grads = torch.autograd.grad(total, live, materialize_grads=True)
        return pytree.tree_unflatten(list(grads), spec)

    return grad


def _weighted_loss_grad(model, params, Xs, ys, ws, contract: str):
    """Gradient of sum_slots w_slot * loss_sum(params, X_slot, y_slot): the
    decoded gradient of an autodiff family in one backward pass over the
    rank's slots (the JAX package's step._weighted_loss_grad; its psum is
    the factory's :func:`_psum`)."""

    def total(p):
        per = model.loss_sum
        for _ in contract:
            per = torch.func.vmap(per, in_dims=(None, 0, 0))
        return (ws.float() * per(p, Xs, ys)).sum()

    return torch.func.grad(total)(params)


def _weighted_sum(weights: torch.Tensor, grads: torch.Tensor, contract: str):
    """sum_i weights[i...] * grads[i..., :] over the leading axes."""
    return torch.einsum(f"{contract},{contract}f->f", weights, grads)


def make_faithful_grad_fn(model, mesh=None) -> GradFn:
    """Every logical worker computes all of its (redundant) slot gradients.

    Matches the reference's cost model: an FRC/MDS worker does (s+1)
    partitions' worth of matvec work each round.

    Args of the returned fn:
      params: [F] float32, or the deep families' dict of tensors.
      Xw, yw: the rank's worker-major stacks [Wl, S, rows, F] / [Wl, S, rows].
      slot_weights: [Wl, S] decode x coding weight per slot message.
    Every factory here all-reduces over ``mesh`` (:func:`_psum`).
    """

    if _on_model_axis(model):
        return _psum(_dq(_axis_grad_body(model, "ws")), mesh)

    def grad(params, Xw, yw, slot_weights):
        if _grads_via_loss(model):
            with annotate("eh_step/partial_grads"):
                return _weighted_loss_grad(model, params, Xw, yw, slot_weights, "ws")
        with annotate("eh_step/partial_grads"):
            per_slot = model.grad_sum(params, Xw, yw)  # [W, S, F]
        with annotate("eh_step/decode"):
            return _weighted_sum(slot_weights, per_slot, "ws")

    return _psum(_dq(grad), mesh)


def make_deduped_grad_fn(model, mesh=None) -> GradFn:
    """Each partition gradient once, combined with folded decode weights
    (CodingLayout.fold_slot_weights): the same decoded gradient as the
    faithful mode at 1/(s+1) the work.

    Args of the returned fn:
      params: [F] float32, or the deep families' dict of tensors.
      Xp, yp: the rank's partition-major stacks [Pl, rows, F] / [Pl, rows].
      part_weights: [Pl] folded per-partition weights.
    """

    if _on_model_axis(model):
        return _psum(_dq(_axis_grad_body(model, "p")), mesh)

    def grad(params, Xp, yp, part_weights):
        if _grads_via_loss(model):
            with annotate("eh_step/partial_grads"):
                return _weighted_loss_grad(model, params, Xp, yp, part_weights, "p")
        with annotate("eh_step/partial_grads"):
            per_part = model.grad_sum(params, Xp, yp)  # [P, F]
        with annotate("eh_step/decode"):
            return _weighted_sum(part_weights, per_part, "p")

    return _psum(_dq(grad), mesh)


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
    with annotate("eh_step/partial_grads"):
        X3 = features_lib._f32(Xs.reshape(M, R, F))
        p = features_lib.matvec(X3.reshape(M * R, F), params)
        r = model.margin_residual(p, ys.reshape(M * R))
        wr = ws.reshape(M, 1) * r.reshape(M, R)
        return -torch.einsum("mrf,mr->f", X3, wr)


def make_margin_flat_grad_fn(model, mesh=None) -> GradFn:
    """The hybrid lowering as a drop-in for make_faithful_grad_fn /
    make_deduped_grad_fn on dense closed-form stacks (the caller gates on
    :func:`supports_margin_flat`)."""
    return _psum(_dq(functools.partial(_hybrid_margin_flat_grad, model)), mesh)


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
        with annotate("eh_step/partial_grads"):
            Xf = features_lib.flatten_rows(Xs)
            wf = ws.reshape(M, 1).expand(M, R).reshape(M * R)
            r = model.margin_residual(features_lib.matvec(Xf, params), ys.reshape(M * R))
            return -features_lib.rmatvec(Xf, wf * r)

    return grad


def make_flat_grad_fn(model, mesh=None) -> GradFn:
    """The flat lowering as a drop-in for make_faithful_grad_fn (worker-major
    [W, S, rows, ...]) and make_deduped_grad_fn (partition-major
    [P, rows, ...]); the caller gates on :func:`supports_flat_grad`. Same
    math as the per-slot form in another reduction order."""
    return _psum(_dq(_flat_local_body(model)), mesh)


def make_fused_grad_fn(kind: str, mesh=None) -> GradFn:
    """The one-pass kernel (ops/kernels.py) as a drop-in for either grad fn
    above on dense GLM stacks: the worker-major [W, S, rows, F] or the
    partition-major [P, rows, F] stack, leading dims flattened into kernel
    slots (views, no copy). The decode is folded into the kernel's one
    pass, so its one region is ``eh_step/partial_grads`` (and the
    all-reduce's ``eh_step/decode`` over a mesh)."""

    def grad(params, Xs, ys, ws):
        M = int(np.prod(Xs.shape[:-2]))
        with annotate("eh_step/partial_grads"):
            return kernels.fused_glm_grad(
                params,
                Xs.reshape((M,) + tuple(Xs.shape[-2:])),
                ys.reshape(M, -1),
                ws.reshape(M),
                kind,
            )

    return _psum(grad, mesh)


# ---------------------------------------------------------------------------
# the ring transport (stack_mode="ring")

# Whether ring_pipeline="auto" resolves to the double-buffered schedule
# absent a cached ring_pipeline verdict: off, as in the JAX package (its
# RING_PIPELINE_DEFAULT). Both schedules move the same blocks in the same
# fill order, so the knob is a pure lowering choice.
RING_PIPELINE_DEFAULT = False


def resolve_ring_pipeline(ring_pipeline: str, model=None, X=None) -> bool:
    """Should a ring-transport run take the double-buffered schedule?
    "on"/"off" force; "auto" resolves a cached ``ring_pipeline`` race
    verdict at the run's shape on its device (``model`` and the
    partition-major stack ``X`` give the consult its signature), else
    :data:`RING_PIPELINE_DEFAULT`."""
    if ring_pipeline == "on":
        return True
    if ring_pipeline == "off":
        return False
    if model is not None and X is not None:
        choice = _tuned(
            "ring_pipeline", model, X,
            "pipelined" if RING_PIPELINE_DEFAULT else "sequential",
        )
        if choice is not None:
            return choice == "pipelined"
    return RING_PIPELINE_DEFAULT


def _ring_fill(plan, mesh, Xp, yp, pipeline: bool, index_cache: dict):
    """This rank's worker-major slot buffer ``([Wl, S, rows, ...],
    [Wl, S, rows])`` from its partition-major shard ``[Pl, rows, ...]``
    over ``plan.n_hops - 1`` ring shifts (the JAX package's
    step._ring_fill).

    Hop 0 fills from the rank's own block; each further hop shifts the
    visiting block one ring position (rank d receives rank d+1's block:
    mesh.WorkerMesh.ring_shift) and copies the slots the plan says that
    block owns into the buffer. The buffer is a temporary of the round.
    Values are moved, never transformed, so the buffer is bitwise the
    materialized stack's slice and the slot gradients downstream see the
    same inputs. At world size 1 the plan has one hop: a local gather of
    the resident stack, with no communication.

    ``pipeline`` (cfg.ring_pipeline): False sends hop t and then fills it;
    True posts hop t+1's shift before it fills hop t and waits on it after,
    so the transfer flies under the fill. Same shifts, same bytes, same
    fill order. ``index_cache`` holds each hop's (slot positions, block
    rows) index tensors per device, built at first use."""
    d = 0 if mesh is None else mesh.index
    Wl, S = plan.local_workers, plan.n_slots
    blk = (Xp, yp)
    dev = yp.device
    idx = index_cache.get(dev)
    if idx is None:
        idx = []
        for sel_h in plan.sel[d].reshape(plan.n_hops, Wl * S):
            pos = np.flatnonzero(sel_h >= 0)
            idx.append((
                torch.from_numpy(pos).to(dev), torch.from_numpy(sel_h[pos].astype(np.int64)).to(dev),
                pos.size == Wl * S,
            ))
        index_cache[dev] = idx

    def fill(buf, block, h):
        pos, src, whole = idx[h]
        if not len(pos):
            return buf
        if buf is None and whole:
            return pytree.tree_map(lambda leaf: leaf.index_select(0, src), block)
        if buf is None:
            buf = pytree.tree_map(
                lambda leaf: leaf.new_zeros((Wl * S,) + tuple(leaf.shape[1:])), block
            )
        pytree.tree_map(lambda b, leaf: b.index_copy_(0, pos, leaf.index_select(0, src)),
                        buf, block)
        return buf

    H = plan.n_hops
    with annotate("eh_step/ring_fill"):
        if pipeline and H > 1:
            pending = mesh.ring_shift(blk)
            buf = fill(None, blk, 0)
            for h in range(1, H):
                cur = pending()
                if h < H - 1:
                    pending = mesh.ring_shift(cur)
                buf = fill(buf, cur, h)
        else:
            buf = fill(None, blk, 0)
            for h in range(1, H):
                blk = mesh.ring_shift(blk)()
                buf = fill(buf, blk, h)
    Xb, yb = buf
    return features_lib.reshape_lead(Xb, (Wl, S)), yb.reshape((Wl, S) + tuple(yb.shape[1:]))


def make_ring_faithful_grad_fn(model, plan, mesh=None, local_body: GradFn = None,
                               pipeline: bool = False) -> GradFn:
    """The faithful decoded gradient from the partition-major stack
    (stack_mode="ring"): :func:`_ring_fill` rebuilds the rank's
    ``[Wl, S, rows, ...]`` slot buffer every round, then ``local_body``, any
    grad fn of this module built over the same ``mesh`` (the faithful
    default, the fused kernel, the flat, margin-flat and blockwise
    lowerings, a cohort body), runs on it exactly as on the materialized
    stack: the trajectories are bitwise the materialized run's.

    Args of the returned fn:
      params: as ``local_body`` takes them.
      Xp, yp: the rank's partition-major shards [Pl, rows, ...] / [Pl, rows].
      slot_weights: the rank's [Wl, S] (a cohort's [B, Wl, S]).
    A rank outside the worker group fills nothing and goes straight to the
    body's all-reduce."""
    body = local_body if local_body is not None else make_faithful_grad_fn(model, mesh)
    index_cache: dict = {}

    def grad(params, Xp, yp, slot_weights):
        if mesh is not None and not mesh.member:
            return body(params, Xp, yp, slot_weights)
        Xw, yw = _ring_fill(plan, mesh, Xp, yp, pipeline, index_cache)
        return body(params, Xw, yw, slot_weights)

    return grad


# Whether layer_coding="auto" resolves to the blockwise decode absent a
# cached tune verdict: off, as in the JAX package (its
# step.LAYER_CODING_DEFAULT); "on" forces it.
LAYER_CODING_DEFAULT = False

# Whether block_decode="auto" takes the fused per-leaf lowering absent an
# env override and a cached tune verdict. The JAX package's constant is
# treewise; here it is fused, the form whose decode reads the leaves in
# place with no packed table (both launch B2 once a round and are bitwise
# equal, so this is a pure lowering choice that the block_decode race
# re-decides per shape).
BLOCK_DECODE_FUSED_DEFAULT = True

#: operator override of block_decode="auto" ("fused" / "treewise")
BLOCK_DECODE_ENV = "ERASUREHEAD_BLOCK_DECODE"

_MODEL_AXES = ("seq_axis", "tp_axis", "pp_axis", "ep_axis")


def supports_layer_coding(model) -> bool:
    """Can this model's gradients take the blockwise decode?

    Deviation from the JAX package, whose gate refuses every autodiff family
    on jax >= 0.6: there, per-slot ``jax.grad`` w.r.t. replicated params
    inside ``shard_map`` implicitly psums cotangents per slot position, so
    per-slot grads would double-count. The port has no ``shard_map`` and
    no implicit psum (each rank differentiates its own slots and the
    all-reduce comes after the decode): per-slot ``torch.func.grad`` is
    exact for every family it has (the GLMs, mlp, deepmlp, moe). The other
    JAX exclusion stays: a model on a model-internal mesh axis takes the
    flattened-slot gradient (:func:`_axis_grad_body`), which decodes over
    the whole mesh, never per slot."""
    return not _on_model_axis(model)


def _tuned(race: str, model, X, fallback: str):
    """A cached verdict of ``race`` at the run's stack, on its device."""
    from erasurehead_tpu_torch import tune as tune_lib

    return tune_lib.lookup(
        race, tune_lib.run_shape_signature(model, X),
        device_kind=tune_lib.default_device_kind(tune_lib.stack_device(X)),
        fallback=fallback,
    )


def resolve_layer_coding(layer_coding: str, model, X=None) -> bool:
    """Should this run decode per layer block? ("on" validity is the
    caller's concern: this resolves the choice, it does not raise.)
    "auto" resolves cached tune decision -> hardcoded fallback: a
    ``layer_coding`` race verdict at this run's shape (tune/) wins over
    :data:`LAYER_CODING_DEFAULT`; the stack ``X`` gives the consult its
    shape signature and device."""
    if not supports_layer_coding(model):
        return False
    if layer_coding == "on":
        return True
    if layer_coding == "off":
        return False
    if X is not None:
        choice = _tuned(
            "layer_coding", model, X,
            "blockwise" if LAYER_CODING_DEFAULT else "treewise",
        )
        if choice is not None:
            return choice == "blockwise"
    return LAYER_CODING_DEFAULT


def resolve_block_decode(block_decode: str, model=None, X=None) -> bool:
    """Fused per-leaf decode (True) or the packed treewise table (False)?

    Resolution order (explicit > env > measured > hardcoded):
      1. ``block_decode`` = "fused"/"treewise" forces;
      2. the :data:`BLOCK_DECODE_ENV` env var forces (operator escape
         hatch);
      3. a cached ``block_decode`` tune verdict at this run's shape;
      4. :data:`BLOCK_DECODE_FUSED_DEFAULT`.
    Both reduce through the same kernel in the same order, so they are
    bitwise equal: a pure lowering choice."""
    if block_decode == "fused":
        return True
    if block_decode == "treewise":
        return False
    env = os.environ.get(BLOCK_DECODE_ENV, "")
    if env in ("fused", "treewise"):
        return env == "fused"
    if model is not None and X is not None:
        choice = _tuned(
            "block_decode", model, X,
            "fused" if BLOCK_DECODE_FUSED_DEFAULT else "treewise",
        )
        if choice is not None:
            return choice == "fused"
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
        with annotate("eh_step/partial_grads"):
            grads = per_slot_grads(model, params, Xs, ys, len(contract))
            table = blocks_lib.tree_to_blocks(grads, spec)  # [*lead, L, width]
        with annotate("eh_step/decode"):
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
        with annotate("eh_step/partial_grads"):
            grads = per_slot_grads(model, params, Xs, ys, len(contract))
        with annotate("eh_step/decode"):
            out = kernels.fused_block_decode_leaves(ws, blocks_lib.tree_leaves(grads))
        return blocks_lib.tree_unflatten(spec.keys, out)

    return grad


def make_layer_block_grad_fn(model, spec, *, faithful: bool, fused: bool,
                             mesh=None) -> GradFn:
    """Per-layer (blockwise) decoded gradient: drop-in for
    make_faithful_grad_fn / make_deduped_grad_fn on any model, taking the
    faithful worker-major stack with [W, S] weights or the partition-major
    stack with [P] weights. ``fused`` picks the lowering
    (:func:`resolve_block_decode`); on CUDA both decode through the kernel,
    each rank its own slots, and the decoded leaves are all-reduced after
    (the JAX package's per-leaf psum)."""
    contract = "ws" if faithful else "p"
    body = _fused_layer_block_body if fused else _layer_block_body
    return _psum(_dq(body(model, spec, contract)), mesh)


def lowering_signature(cfg, model, X) -> tuple:
    """The resolved gradient-lowering choice for (cfg, model, stack): the
    part of the executable-cache key (train/cache.py) that cfg alone cannot
    determine, as in the JAX package's step.lowering_signature. The
    resolvers read the model, the stack kind and the tune decision cache, so
    the tuple moves when a race verdict lands and a cached graph never
    outlives a changed lowering. The last entry names the stack's type: the
    port's (a tensor, PaddedRows, FieldOnehot, QuantizedStack), not JAX's."""
    return (
        bool(resolve_flat_grad(cfg.flat_grad, model, X)),
        bool(resolve_margin_flat(cfg.margin_flat, model, X)),
        bool(resolve_layer_coding(cfg.layer_coding, model, X)),
        bool(resolve_block_decode(getattr(cfg, "block_decode", "auto"), model, X)),
        type(X).__name__,
    )


def staleness_slot_params(params, stale_params, pipeline_depth: int):
    """The params a round's gradient is taken at: the live params of a
    synchronous run (``pipeline_depth=0``), or, pipelined (tau=1), the
    second slot of the trainer's carry: the params the round's workers were
    dispatched with (the iterate that entered the previous round)."""
    return stale_params if pipeline_depth else params


def expand_slot_weights(message_weights, coeffs, slot_is_coded):
    """[R?, W] per-message decode weights -> [R?, W, S] per-slot weights
    (the single home of this rule).

    Coded slots are scaled by the message's decode weight; separate slots
    (partial schemes' uncoded first parts) always contribute with weight 1
    (src/partial_coded.py:187-190). Numpy in, numpy out (the host float64
    control plane); a tensor in, a tensor out on its device, with
    ``coeffs`` and ``slot_is_coded`` tensors there (the on-device round of
    trainer.train_dynamic), as the JAX package's takes numpy or jnp."""
    if isinstance(message_weights, torch.Tensor):
        return torch.where(slot_is_coded, message_weights[..., :, None] * coeffs, coeffs)
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
        with annotate("eh_step/partial_grads"):
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
        with annotate("eh_step/partial_grads"):
            grads = torch.func.vmap(
                lambda p: per_slot_grads(model, p, Xs, ys, len(contract))
            )(params_B)
        if fused:
            leaves = [leaf.contiguous() for leaf in blocks_lib.tree_leaves(grads)]
            with annotate("eh_step/decode"):
                out = kernels.fused_block_decode_cohort(ws_B, leaves, contract)
            return blocks_lib.tree_unflatten(spec.keys, out)
        table = blocks_lib.tree_to_blocks(grads, spec)  # [B, *lead, L, width]
        with annotate("eh_step/decode"):
            (g,) = kernels.fused_block_decode_cohort(ws_B, [table], contract)
        return blocks_lib.blocks_to_tree(g, spec)

    return grad


def make_cohort_grad_fn(
    model, params_template, X, *, faithful: bool, layer_coding: str,
    block_decode: str, flat_grad: str, mesh=None,
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
    layer-coded lowering); ``X`` the cohort's device stack (the rank's
    slice, its weights ``[B, Wl, S]`` or ``[B, Pl]``). Every body
    dequantizes an int8 stack once a round for the whole cohort, and the
    B decoded gradients are all-reduced over ``mesh`` in one collective."""
    grad_fn, lowering = _cohort_body(model, params_template, X, faithful=faithful,
                                     layer_coding=layer_coding, block_decode=block_decode,
                                     flat_grad=flat_grad)
    return _psum(grad_fn, mesh), lowering


def looped_grad_fn(body: GradFn) -> GradFn:
    """The cohort body of a model on a model-internal axis: the
    one-trajectory grad fn once per trajectory, in order (its collectives
    cannot run under ``torch.func.vmap``), the B gradients stacked; the
    factory's all-reduce then sums all B in one collective."""

    def grad(params_B, Xs, ys, ws_B):
        outs = [body(blocks_lib.tree_map(lambda p: p[b], params_B), Xs, ys, ws_B[b])
                for b in range(ws_B.shape[0])]
        return pytree.tree_map(lambda *leaves: torch.stack(leaves), *outs)

    return grad


def _cohort_body(model, params_template, X, *, faithful: bool, layer_coding: str,
                 block_decode: str, flat_grad: str):
    contract = "ws" if faithful else "p"
    if _on_model_axis(model):
        # JAX's per_slot_vmap lowering, the trajectories in turn
        return looped_grad_fn(_dq(_axis_grad_body(model, contract))), "per_slot_vmap"
    if resolve_layer_coding(layer_coding, model, X):
        spec = blocks_lib.model_block_spec(model, params_template)
        fused = resolve_block_decode(block_decode, model, X)
        body = _cohort_layer_block_body(model, spec, contract, fused)
        return _dq(body), "layer_block_vmap"
    if supports_cohort_matmul(model, X):
        return _dq(cohort_matmul_grad_fn(model)), "cohort_matmul"
    if resolve_flat_grad(flat_grad, model, X):
        return _dq(batched_grad_fn(_flat_local_body(model))), "flat_vmap"
    body = make_faithful_grad_fn(model) if faithful else make_deduped_grad_fn(model)
    return batched_grad_fn(body), "per_slot_vmap"
