"""Scheme plugin registry.

Importing this package registers every built-in scheme of the port:
``full``, ``lrf``, ``sq``, ``hash``, ``dpq``, ``mgqe``, ``rq`` and
``mpe`` — the JAX package's registry, kind for kind.
"""
from repro_torch.core.schemes.base import (ArtifactLeaf, QuantizedScheme,
                                           Scheme, get_scheme,
                                           register_scheme,
                                           registered_kinds, scheme_class)

# built-in schemes — importing the module registers the class
from repro_torch.core.schemes import baselines as _baselines  # noqa: F401
from repro_torch.core.schemes import dpq as _dpq              # noqa: F401
from repro_torch.core.schemes import mgqe as _mgqe            # noqa: F401
from repro_torch.core.schemes import mpe as _mpe              # noqa: F401
from repro_torch.core.schemes import rq as _rq                # noqa: F401

__all__ = ["ArtifactLeaf", "QuantizedScheme", "Scheme", "get_scheme",
           "register_scheme", "registered_kinds", "scheme_class"]
