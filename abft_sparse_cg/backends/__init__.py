"""Backend registry + targets.

Importing this package registers all available targets, in the order the
reference lists its contexts: the portable tier first, then accelerated
tiers, mirroring cpu -> arm32/ocl in the reference registries
(reference COO/CPUContext.cpp:383-388, CSR/OCLContext.cpp:84-87).
"""

from . import registry
from .registry import available, create, list_contexts, register

from . import jnp_backend  # noqa: F401  (registers "jnp")

try:  # native C++ backend: only if the shared library is built
    from . import cpp_backend  # noqa: F401  (registers "cpu")
except (ImportError, OSError):
    pass

from . import pallas_backend  # noqa: F401  (registers "pallas")

__all__ = ["registry", "available", "create", "list_contexts", "register"]
