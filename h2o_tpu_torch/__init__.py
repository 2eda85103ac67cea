"""h2o_tpu_torch — the PyTorch/CUDA port of ``h2o_tpu``.

Ports ``h2o_tpu/__init__.py``: the package version and the ``cloud()``
entry that names the device everything else runs on.  The JAX package
``h2o_tpu`` is the reference this port is held against; nothing here
imports it or JAX.

Importing this package builds no kernel and touches no device: the
CUDA histogram kernels (``ops/hist_kernels.py``) are compiled at their
first launch.
"""

from h2o_tpu_torch.core.device import cloud

__version__ = "0.1.0"

__all__ = ["cloud", "__version__"]
