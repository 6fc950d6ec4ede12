"""PyTorch port of the HASFL reproduction, for one NVIDIA H100.

Mirrors `src/repro/` module for module and imports nothing of it (nor
JAX).  The HASFL edge simulator's main path — `api.Session` ->
`core.sfl.SFLEdgeSimulator` on the CNN family — runs on the card through
two hand-written kernels: the client-batched conv GEMM
(``csrc/batched_matmul.cu``) and the fused clip+SGD update of every leaf
of a round in one launch (``csrc/clip_sgd.cu``).  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
