"""The port's 2-process DIS-MF step (FuseNet, 2 blocks x 16) against the
JAX package's step on a 2-device mesh run op by op (``jax.disable_jit``),
as tests/test_torch_parallel.py holds DIS-SF to the jitted one: the MF
tests' rule, since FuseNet's neighbour selection breaks exact ties by the
last bit of the geometry, which the jitted graph rounds otherwise.

The op-by-op JAX step compiles each operation at first use (~2 min on
this batch); accum_steps=2 runs on a batch of 16, whose two microbatches
have the accum_steps=1 batch's shapes and reuse those compilations."""
import pytest
import torch

from test_torch_parallel import BS, check_two_process_step


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("accum", [1, 2])
def test_two_process_mf_step_matches_the_jax_mesh_step(tmp_path, accum):
    check_two_process_step(tmp_path, "multi_frame", accum, BS * accum)
