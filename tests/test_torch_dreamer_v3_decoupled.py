"""The decoupled DreamerV3 world model of the PyTorch port against the JAX
package: the step-by-step decoupled scan, and the LN-GRU sequence path
(the JAX package's Pallas kernel in interpret mode against the port's
kernels' plain passes on the CPU). Harness and tolerances: see
test_torch_dreamer_v3.py."""
from test_torch_dreamer_v3 import burst_parity

DEC = ["algo.world_model.decoupled_rssm=True"]


def test_decoupled_burst_matches_jax():
    burst_parity(DEC, DEC)


def test_decoupled_sequence_kernel_burst_matches_jax():
    burst_parity(DEC + ["algo.world_model.pallas_gru=interpret"], DEC + ["algo.world_model.pallas_gru=True"])
