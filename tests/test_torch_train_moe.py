"""The port's train step against the JAX package's for the two MoE archs
(mixtral: top-2 with a sliding window; llama4: top-1 with the shared
expert), on the CPU: the twin of
tests/test_arch_smoke.py::test_train_step_reduces_loss that
tests/test_torch_train.py holds for the other eight archs, with its
tolerances. The reference runs op by op (``jax.disable_jit()``): compiled,
XLA rounds the router's input otherwise and a near-tie flips an expert
(tests/test_torch_lm.py measures it). The file is its own because that
mode's start-up alone takes ~20 s of a worker.
"""
import pytest

from test_torch_train import MOE, check_train_step


@pytest.mark.parametrize("name", MOE)
def test_moe_train_step_matches_jax(name):
    check_train_step(name)
