"""PyTorch / CUDA port of hifi_fusion_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (``config``, ``grid``, ``ops/*``,
``models/*``, ``parallel/{sharding, routing}``,
``runtime/{session, decode, native, sources}``,
``io/{pcd, ply, downloads}``, ``oracle/native``, ``utils/{synthetic,
profiling}``) and its public layouts: planar (3,N) points, flat
slot-major grid fields.  Its host libraries (``runtime/native``,
``oracle/native``) build with ``g++`` at first use.
Imports ``torch`` and numpy, never ``jax`` or ``hifi_fusion_tpu``.  The
device is explicit: a CUDA tensor runs the hand-written kernel of its op
(``csrc/``, built at first use by ``kernels``) or raises; a CPU tensor runs
the op's plain PyTorch version.
"""

from .config import FusionConfig, small_test_config
from .grid import GridState, grid_metrics, make_grid

__all__ = ["FusionConfig", "small_test_config", "GridState", "make_grid",
           "grid_metrics"]
