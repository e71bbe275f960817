"""FiT in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``fit_tpu`` (JAX on a TPU), which stays the reference. It
mirrors ``fit_tpu``'s module names and never imports jax. Importing the
package builds nothing: a CUDA kernel is compiled at its first launch.
"""

__version__ = "0.1.0"
