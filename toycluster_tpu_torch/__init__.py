"""toycluster_tpu_torch: the galaxy-cluster initial-conditions engine in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``toycluster_tpu`` (JAX/Pallas for TPU), which stays in the
repository as its reference.  Module names mirror the JAX package's, and
each module names its counterpart.  Host-side float64 NumPy builds the
analytic setup tables; tensors on an explicit ``device`` carry the
particles; the block-sparse neighbour engine feeds two stream kernels
(``ops/stream_pair.py``, sources in ``csrc/``): the fused WVT density
solve + displacement, and the SPH curl of the magnetic field.

This package imports neither JAX nor ``toycluster_tpu``.
"""

__version__ = "0.1.0"

from .config import Config, parse_par_file  # noqa: F401
