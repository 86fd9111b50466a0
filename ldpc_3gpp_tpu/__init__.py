"""Accelerator-native 3GPP NR LDPC simulation framework.

From-scratch JAX/XLA implementation of the TS38.212 shared-channel
coding chain with the capability surface of robmaunder/ldpc-3gpp-matlab.
See README.md, DESIGN.md, VALIDATION.md, COVERAGE.md.
"""
from .spec.params import LDPCParams
from .spec.tables import UnsupportedParameters

__all__ = [
    "LDPCParams",
    "UnsupportedParameters",
    # submodules (imported lazily by users to keep jax import optional here):
    # ldpc_3gpp_tpu.models.encoder.encode_transport_block
    # ldpc_3gpp_tpu.models.decoder.decode_transport_block / init_harq_state
    # ldpc_3gpp_tpu.models.chain.ChainConfig / simulate_batch
    # ldpc_3gpp_tpu.ops.modulation.modulate / demodulate
    # ldpc_3gpp_tpu.parallel.sweep.bler_vs_snr / snr_vs_a
    # ldpc_3gpp_tpu.parallel.montecarlo.MonteCarlo
]

__version__ = "0.1.0"
