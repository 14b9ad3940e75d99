"""Post-hoc evaluation replay: loss/AUC curves over the whole iterate history.

The reference's master, after training, replays every saved iterate against
the full train and test sets (src/naive.py:157-198). As in
erasurehead_tpu/train/evaluate.py, the replay runs on the device: each
iterate's train loss, test loss and (for classifiers) Mann-Whitney AUC;
:func:`replay_batch` does the same for a trajectory axis of histories.

Deviations from the reference (those of the JAX package): the train loss is
over the full training set, and AUC is the Mann-Whitney form.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps
import torch

from erasurehead_tpu_torch.models import metrics
from erasurehead_tpu_torch.ops import blocks, features
from erasurehead_tpu_torch.utils.config import ModelKind


@dataclasses.dataclass
class EvalResult:
    training_loss: np.ndarray  # [rounds]
    testing_loss: np.ndarray  # [rounds]
    auc: np.ndarray  # [rounds]; NaN for regression (reference prints none)


def _replay(model, is_regression: bool, params_history, data) -> torch.Tensor:
    """[3, R] curves (train loss, test loss, AUC) of one history; ``data``
    is (X_train, y_train, X_test, y_test) on the history's device."""
    X_train, y_train, X_test, y_test = data
    leaves = blocks.tree_leaves(params_history)
    R = leaves[0].shape[0]
    out = torch.empty((3, R), dtype=torch.float32, device=leaves[0].device)
    with torch.no_grad():
        for i in range(R):
            params = blocks.tree_map(lambda h: h[i], params_history)
            out[0, i] = model.loss_mean(params, X_train, y_train)
            pred_test = model.predict(params, X_test)
            if is_regression:
                out[1, i] = metrics.mse_mean(y_test, pred_test)
                out[2, i] = float("nan")
            else:
                out[1, i] = metrics.log_loss_mean(y_test, pred_test)
                out[2, i] = metrics.auc(y_test, pred_test)
    return out


def _put(device, X_train, y_train, X_test, y_test):
    """The replay's data on ``device``, float32: a scipy sparse matrix as a
    PaddedRows stack (as the JAX package's replay converts it)."""

    def put(a):
        if sps.issparse(a):
            return features.to_device(features.PaddedRows.from_scipy(a), device, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    return tuple(put(a) for a in (X_train, y_train, X_test, y_test))


def replay(
    model,
    model_kind: ModelKind,
    params_history,
    X_train,
    y_train,
    X_test,
    y_test,
) -> EvalResult:
    """Loss (and AUC for classifiers) of every iterate in the history (an
    [R, F] tensor, or a dict of [R, ...] tensors for the deep families),
    through ``model.loss_mean`` and ``model.predict``, on the history's
    device. Dense numpy or tensor data, or scipy sparse matrices."""
    dev = blocks.tree_leaves(params_history)[0].device
    data = _put(dev, X_train, y_train, X_test, y_test)
    is_regression = ModelKind(model_kind) == ModelKind.LINEAR
    train_l, test_l, auc_l = _replay(model, is_regression, params_history, data).cpu().numpy()
    return EvalResult(training_loss=train_l, testing_loss=test_l, auc=auc_l)


def replay_batch(
    model,
    model_kind: ModelKind,
    histories,
    X_train,
    y_train,
    X_test,
    y_test,
) -> EvalResult:
    """:func:`replay` of a trajectory axis: ``histories`` leads with it
    ([B, R, ...] per leaf) and the curves come back [B, R]. Each lane is
    :func:`replay`'s arithmetic on that trajectory's history, so lane b
    equals ``replay`` of ``histories[b]``."""
    dev = blocks.tree_leaves(histories)[0].device
    data = _put(dev, X_train, y_train, X_test, y_test)
    is_regression = ModelKind(model_kind) == ModelKind.LINEAR
    B = blocks.tree_leaves(histories)[0].shape[0]
    curves = torch.stack([
        _replay(model, is_regression, blocks.tree_map(lambda h: h[b], histories), data)
        for b in range(B)
    ], dim=1)  # [3, B, R]
    train_l, test_l, auc_l = curves.cpu().numpy()
    return EvalResult(training_loss=train_l, testing_loss=test_l, auc=auc_l)
