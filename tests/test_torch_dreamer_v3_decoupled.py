"""The decoupled DreamerV3 world model of the PyTorch port against the JAX
package: the step-by-step decoupled scan, and the LN-GRU sequence path
(the JAX package's Pallas kernel in interpret mode against the port's
kernels' plain passes on the CPU). Harness and tolerances: see
test_torch_dreamer_v3.py."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
from test_torch_dreamer_v3 import burst_parity

DEC = ["algo.world_model.decoupled_rssm=True"]


def test_decoupled_burst_matches_jax():
    burst_parity(DEC, DEC)


def test_decoupled_sequence_kernel_burst_matches_jax():
    burst_parity(DEC + ["algo.world_model.pallas_gru=interpret"], DEC + ["algo.world_model.pallas_gru=True"])


def test_decoupled_sequence_kernel_burst_above_the_resident_limit_matches_jax():
    """pallas_gru=True at a GRU width of 1024 (DreamerV3-M's, the streamed
    instance's in the port): the port's sequence path (its kernels' plain
    passes on the CPU) against the JAX package, which prints UNUSED there
    (its VMEM rule) and runs its decoupled scan: the ten metrics at rel
    1e-4. The updated parameters are not compared at this width: some
    gradient entries of the GRU's fused weight and of the decoder's first
    layer are of the size of f32 rounding (measured: 36 of 3,194,880 and 2
    of 266,240), their sign differs between the packages' summation orders,
    and a first Adam step moves such an entry by +lr in one and -lr in the
    other. The GRU's gradients at this width are held against the JAX
    package by test_torch_ln_gru.py::test_streamed_emulation_matches_jax."""
    wide = DEC + ["algo.world_model.pallas_gru=True", "algo.world_model.recurrent_model.recurrent_state_size=1024"]
    burst_parity(wide, wide, check_params=False)
