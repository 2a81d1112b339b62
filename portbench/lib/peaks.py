"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit), against which roofline shares are
stated."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SMS = 132
MUFU_PER_SM_CLOCK = 16  # special-function results an SM a clock
MAX_SM_CLOCK_HZ = 1980e6
MUFU_OPS_PER_S = SMS * MUFU_PER_SM_CLOCK * MAX_SM_CLOCK_HZ


def least_seconds(nbytes: float, fp32_ops: float, mufu_ops: float = 0.0):
    """(the least time the card could take for this work, the bound that
    sets it: "bytes", "float32" or "mufu")."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "float32": fp32_ops / FP32_OPS_PER_S,
             "mufu": mufu_ops / MUFU_OPS_PER_S}
    term = max(terms, key=terms.get)
    return terms[term], term
