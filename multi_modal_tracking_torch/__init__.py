"""multi_modal_tracking_torch: the PyTorch / CUDA (NVIDIA H100) port of
multi_modal_tracking_tpu.

A package of its own beside the JAX package, with the same layout
(config/, ops/, models/, tracking/, eval/, utils/). It imports torch and
never jax, flax or anything of multi_modal_tracking_tpu; the JAX package is
its reference, and only the tests import both.

The entry points (eval.evaltracker.create_tracker, the tracker classes in
tracking.tracker, models.build.build_model) run on the GPU unless the
caller passes device="cpu", and raise when there is no GPU. The kernels
that replace the JAX package's Pallas kernels are hand-written CUDA in
csrc/, built with nvcc on first use (ops/_build.py); on CPU tensors their
wrappers run the plain PyTorch versions.
"""

__version__ = "0.1.0"
