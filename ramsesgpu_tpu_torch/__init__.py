"""ramsesgpu_tpu_torch — the PyTorch + CUDA port of ramsesgpu_tpu.

The port runs on an NVIDIA Hopper GPU (H100). It sits beside the JAX
package, which stays the reference every slice is tested against, and
reuses the JAX package's jax-free host modules (INI parsing, RunParams,
problem initial conditions, VTK output, timers) as they are.

Ported so far: the fully periodic 3D ideal MHD + constrained-transport
main path (HLLD face fluxes, 2D-HLLD corner EMFs), with its two device
kernels written by hand in CUDA (``csrc/``) and their whole-array PyTorch
twins (``solvers/``, ``ops/``). Everything outside that slice raises
NotImplementedError.

No module here imports jax.
"""

__version__ = "0.1.0"

from ramsesgpu_tpu.config.configmap import ConfigMap
from ramsesgpu_tpu.config.params import RunParams, params_from_config

__all__ = ["ConfigMap", "RunParams", "params_from_config", "__version__"]
