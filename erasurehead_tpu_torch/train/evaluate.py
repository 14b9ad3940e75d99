"""Post-hoc evaluation replay: loss/AUC curves over the whole iterate history.

The reference's master, after training, replays every saved iterate against
the full train and test sets (src/naive.py:157-198). As in
erasurehead_tpu/train/evaluate.py, the replay runs on the device: each
iterate's train loss, test loss and (for classifiers) Mann-Whitney AUC.

Deviations from the reference (those of the JAX package): the train loss is
over the full training set, and AUC is the Mann-Whitney form.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from erasurehead_tpu_torch.models import metrics
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.utils.config import ModelKind


@dataclasses.dataclass
class EvalResult:
    training_loss: np.ndarray  # [rounds]
    testing_loss: np.ndarray  # [rounds]
    auc: np.ndarray  # [rounds]; NaN for regression (reference prints none)


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
    device. Dense numpy or tensor data."""
    leaves = blocks.tree_leaves(params_history)
    dev = leaves[0].device

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    X_train, y_train, X_test, y_test = map(put, (X_train, y_train, X_test, y_test))
    is_regression = ModelKind(model_kind) == ModelKind.LINEAR
    R = leaves[0].shape[0]
    out = torch.empty((3, R), dtype=torch.float32, device=dev)
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
    train_l, test_l, auc_l = out.cpu().numpy()
    return EvalResult(training_loss=train_l, testing_loss=test_l, auc=auc_l)
