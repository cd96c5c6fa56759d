"""PyTorch and CUDA port of the OptimES federated GNN system.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage and module names (``kernels``, ``graphs``, ``models``,
``core``, ``exchange``, ``gnnserve``) and imports nothing from it.  Its
entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the card the hot paths go through the hand-written kernels in
``repro_torch/csrc``.
"""
