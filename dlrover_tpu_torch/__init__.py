"""dlrover_tpu_torch — the PyTorch/CUDA port of ``dlrover_tpu``.

A second package beside the JAX one, written for an NVIDIA H100: plain
tensor code is PyTorch, and every kernel the JAX package wrote in Pallas
for the TPU is a CUDA kernel written by hand for Hopper (``sm_90a``).
The package imports nothing of JAX and nothing of ``dlrover_tpu``; where
it needs a piece of the JAX package's pure-Python modules it keeps its
own copy of that piece.

The port grows slice by slice (see ROADMAP.md). Its module layout mirrors
``dlrover_tpu`` so each module's counterpart is found at the same path.
"""

__version__ = "0.1.0"
