"""Distributed-execution layer: sharding inference for the SPMD runtime
(port of `repro.dist`).

``repro_torch.dist.sharding`` turns trees of tensors (train state,
batches, decode caches; ``meta`` tensors in the dry-run) into sharding
trees for any mesh the launch layer builds (host, single-pod, multi-pod),
and provides the activation / per-repetition weight constraint hooks the
model forward passes accept.
"""
from repro_torch.dist import sharding  # noqa: F401
