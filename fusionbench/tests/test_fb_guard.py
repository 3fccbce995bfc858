"""The whole-name check for JAX and the JAX package in ``sys.modules``."""

import sys

from fusionbench.harness import guard


def test_whole_names():
    names = ["hifi_fusion_tpu_torch", "hifi_fusion_tpu_torch.x",
             "jaxtyping", "jax_ok_not", "numpy", "flaxen.y"]
    assert guard.forbidden_modules(names) == []


def test_hits():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "hifi_fusion_tpu", "hifi_fusion_tpu.ops", "torch"]
    assert guard.forbidden_modules(names) == sorted(names[:-1])


def test_this_process_after_a_run():
    """A run (program, reference, judge) loads none of them."""
    from fusionbench.tests import tiny
    tiny.run("fusion1mm.pc2_scans")
    assert guard.forbidden_modules() == [], sorted(sys.modules)
