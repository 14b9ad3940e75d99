"""Declarative scheme registry (the port of erasurehead_tpu/schemes/).

A scheme is a frozen :class:`SchemeDescriptor` bundling its layout builder,
host collection rule, optimal-decode hook, capability flags and config
surface. The eleven builtins register on import; third-party codes
register through :func:`register` or the
``erasurehead_tpu_torch.schemes`` entry-point group
(:data:`ENTRY_POINT_GROUP`).

All scheme dispatch in the port resolves through :func:`get`
(tests/test_torch_schemes.py pins that).
"""

from erasurehead_tpu_torch.schemes.base import SchemeDescriptor
from erasurehead_tpu_torch.schemes.registry import (
    ENTRY_POINT_GROUP,
    descriptors,
    get,
    is_registered,
    load_entry_points,
    names,
    register,
    scheme_name,
    unregister,
)

# importing the package declares the builtins
from erasurehead_tpu_torch.schemes import builtin as _builtin  # noqa: F401,E402

__all__ = [
    "SchemeDescriptor",
    "ENTRY_POINT_GROUP",
    "descriptors",
    "get",
    "is_registered",
    "load_entry_points",
    "names",
    "register",
    "scheme_name",
    "unregister",
]
