"""sp_coupler — superparameterized atmosphere framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
CloudResolvingClimateModeling/sp-coupler (reference: /root/reference): a global
spectral-transform GCM (OpenIFS stand-in) coupled two-way to a fleet of
embedded anelastic LES instances (DALES stand-in), with the spcpl-style
per-column forcing/tendency exchange implemented as batched vmapped
transforms instead of per-instance RPC.

Architecture: one SPMD program. The GCM, every LES instance, and the coupler
are arrays and jitted transforms on a single device mesh; instance parallelism
is a leading batch axis sharded over devices, intra-instance parallelism is
spatial sharding with halo exchange, and the spectral transforms are
einsums (matmuls).
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401
