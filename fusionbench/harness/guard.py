"""The check that a run loaded neither JAX nor the JAX package.

Module names are compared by their top-level part (before the first dot),
whole: the program's package, ``hifi_fusion_tpu_torch``, begins with the
JAX package's name and must pass.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "hifi_fusion_tpu")


def forbidden_modules(names=None) -> list:
    """The loaded module names whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
