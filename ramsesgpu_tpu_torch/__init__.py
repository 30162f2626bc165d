"""ramsesgpu_tpu_torch — the PyTorch + CUDA port of ramsesgpu_tpu.

The port runs on an NVIDIA Hopper GPU (H100). It sits beside the JAX
package, which stays the reference every slice is tested against. It
imports nothing of that package: it keeps its own copies of the host
modules it needs (``config/``, ``core/``, ``problems/``, ``io/``,
``utils/``), and no module here imports jax.

Ported so far, each with its device kernels written by hand in CUDA
(``csrc/``) beside their whole-array PyTorch twins (``solvers/``,
``ops/``):

- the fully periodic 3D MHD + constrained-transport main path (HLLD face
  fluxes, 2D-HLLD corner EMFs; every MHD path also takes LLF or HLL faces
  and HLLA, HLLF or LLF corners);
- the MRI shearing box (rotating frame, sheared-periodic x faces), and the
  stratified MRI (BC_Z_STRATIFIED z faces, static vertical gravity);
- both MHD paths with viscosity and resistivity (the stratified box too),
  and with the Kahan-compensated state ([implementation] compensated);
- 3D hydro (approx / HLL / HLLC, slope_type 0-2, the isothermal EOS)
  with any mix of DIRICHLET / NEUMANN / PERIODIC faces.

Whole-array PyTorch on the device, as the JAX package has no kernel for
them: the 2D step, the forcing, the alternative schemes
(``solvers/alt_schemes.py``, ``alt_laxliu.py``, ``run2d_alt.py``), the
analysis tools (``analysis/``) and the live view (``gui/``). The step
profiler, the operation count and the memory planner are ``utils/``.

Everything outside those slices raises NotImplementedError.
"""

__version__ = "0.1.0"

from .config.configmap import ConfigMap
from .config.params import RunParams, params_from_config

__all__ = ["ConfigMap", "RunParams", "params_from_config", "__version__"]
