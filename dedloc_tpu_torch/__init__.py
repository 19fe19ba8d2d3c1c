"""dedloc_tpu_torch: the PyTorch/CUDA port of ``dedloc_tpu`` for an NVIDIA H100.

The package mirrors ``dedloc_tpu``'s module names, so each module's
counterpart is found under the same path. It imports ``torch`` and never JAX
or anything of ``dedloc_tpu``: what it needs from the JAX package it keeps as
its own copy. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; kernels are built at first launch, never at
import.
"""
