"""The least time the card could take for a job's counter work.

The work is fixed by the inputs, whatever kernel does it: 2 x the needed
pairs x the variable sites x the channels of the measure's minimal plan,
as int8 operations at the card's peak, or the codes read once at its
memory rate, whichever is longer.  Pairs that a kernel computes and the
output never needs (a diagonal block's lower half, one-row baselines,
padding) count as time, not as work.  It assumes the dense formulation:
a program that counts another way needs a new count here.
"""

import numpy as np

from reference.encoding import ENCODE

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

# Channels of each measure's plan in the JAX package (ops/features.py),
# frozen here: the sum of {-1, 0, 1} feature products that yields its
# counters.
CHANNELS = {"n": 14, "n_high": 14, "raw": 18, "jc69": 18, "k80": 6,
            "tn93": 5}

# The counter kernels by their device names: K5 (features), K6 (contract
# and its integer mix) and K1 (the counters straight from the codes).
COUNTER_KERNELS = ("features_kernel", "contract_kernel", "mix_kernel",
                   "counters_kernel")


def variable_sites(chars: np.ndarray) -> int:
    """Columns that are not one exact base (A, C, G or T, either case)
    across every record of ``chars``."""
    codes = ENCODE[chars]
    same = (codes == codes[0]).all(axis=0)
    exact = (codes[0] & 8) == 8
    return int(chars.shape[1] - np.count_nonzero(same & exact))


def counter_least_s(pairs: int, sites: int, records: int,
                    measure: str) -> float:
    """Seconds: the operations at the int8 peak, or the records' codes of
    the variable sites read once at the memory rate, the longer."""
    ops = 2.0 * pairs * sites * CHANNELS[measure] / PEAK_INT8_OPS
    moved = float(records) * sites / PEAK_BYTES
    return max(ops, moved)
