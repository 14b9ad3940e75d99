"""Device selection and the float32 precision rule shared by every entry point.

Entry points (``train.trainer.train``, ``cli.main``) run on ``cuda`` unless the
caller asks for ``cpu``. There is no silent fallback: asking for the card where
none exists raises.

Precision is part of parity with the JAX reference, which pins HIGHEST matmul
precision because reduced-precision products, once amplified by MDS decode
weights, corrupt the GLM science (erasurehead_tpu/ops/features.py). Here that
means float32 products with TF32 off, for both cuBLAS and cuDNN.
"""

from __future__ import annotations

import torch


def pin_float32_precision() -> None:
    """Full float32 products: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The run's device: ``cuda`` by default, ``cpu`` only when asked for.

    Raises when ``cuda`` is asked for (explicitly or by default) and
    ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI: --device cpu) to run on the "
                "CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {dev.type!r}")
    pin_float32_precision()
    return dev
