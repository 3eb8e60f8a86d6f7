"""gmpi_tpu_torch — the PyTorch/CUDA port of ``gmpi_tpu`` for NVIDIA Hopper.

Mirrors ``gmpi_tpu``'s module paths and names so each piece has an obvious
counterpart: ``gmpi_tpu_torch.core.renderer`` ports ``gmpi_tpu.core.renderer``
and so on.  Plain tensor code is PyTorch; every Pallas kernel of the JAX
package becomes a hand-written CUDA kernel under ``csrc/`` with a plain
PyTorch version beside it (``ops/fused_render.py``).

The package imports ``torch``, numpy and the standard library only — never
``jax`` and never ``gmpi_tpu``.  Entry points take an explicit ``device``
that defaults to ``"cuda"`` and raise when no card is present; the tests pass
``device="cpu"``.
"""

__version__ = "0.1.0"
