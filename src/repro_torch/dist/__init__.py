"""repro_torch.dist — the runtime layer of the cross-layer design (the port
of ``repro.dist``).

  sharding     divisibility-aware partition-spec rules for params / batches /
               decode caches on the production meshes, and their DTensor
               placements
  hints        ``sharding_rules(mesh)`` context + ``hint(x, *roles)`` — the
               in-model annotation hook every layer calls
  compression  int8 error-feedback gradient compression for DP collectives
  collectives  waited process-group collectives and the autograd rules of
               the sharded MoE
"""

from repro_torch.dist import collectives, compression, hints, sharding

__all__ = ["collectives", "compression", "hints", "sharding"]
