"""PyTorch/CUDA port of erasurehead_tpu: coded gradient descent on one NVIDIA GPU.

Module paths mirror the JAX package's (``erasurehead_tpu``), which stays the
reference; this package never imports it or JAX.
"""


def train(cfg, dataset, **kw):
    """Convenience re-export of train.trainer.train (lazy, as in the JAX
    package: importing the package loads no trainer)."""
    from erasurehead_tpu_torch.train import trainer

    return trainer.train(cfg, dataset, **kw)


def train_dynamic(cfg, dataset, **kw):
    """Convenience re-export of train.trainer.train_dynamic (arrivals, masks
    and decode weights computed on the device inside the round)."""
    from erasurehead_tpu_torch.train import trainer

    return trainer.train_dynamic(cfg, dataset, **kw)


def train_measured(cfg, dataset, **kw):
    """Convenience re-export of train.trainer.train_measured (real
    per-worker arrival timing feeding the collection rules)."""
    from erasurehead_tpu_torch.train import trainer

    return trainer.train_measured(cfg, dataset, **kw)


def train_elastic(cfg, dataset, deaths, **kw):
    """Convenience re-export of parallel.failures.train_elastic (re-shard
    onto the survivors after permanent worker deaths and keep training)."""
    from erasurehead_tpu_torch.parallel import failures

    return failures.train_elastic(cfg, dataset, deaths, **kw)
