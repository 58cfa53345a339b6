"""A SARS-CoV-2-like alignment: one ancestor, a fixed number of point
mutations a genome, and a share of N and gap characters.

The recipe of the JAX package's ``bench.make_alignment`` and of
``chip_smoke.make_alignment``, drawn in the same order from the same
generator, so that a seed gives their matrix (as characters, not codes).
"""

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def make(cfg: dict, records: int, seed: int) -> np.ndarray:
    """A (records, sites) matrix of upper-case FASTA characters."""
    sites = int(cfg["sites"])
    rng = np.random.default_rng(seed)
    ancestor = rng.choice(BASES, size=sites)
    mat = np.tile(ancestor, (records, 1))
    n_mut = int(cfg["mutations_per_record"])
    rows = np.repeat(np.arange(records), n_mut)
    cols = rng.integers(0, sites, size=records * n_mut)
    mat[rows, cols] = rng.choice(BASES, size=records * n_mut)
    # ambiguous_share of the cells, in whole hundreds, become N or '-'
    n_amb = int(float(cfg["ambiguous_share"]) * records * sites / 100) * 100
    rows = rng.integers(0, records, size=n_amb)
    cols = rng.integers(0, sites, size=n_amb)
    mat[rows, cols] = np.where(rng.random(n_amb) < float(cfg["n_share"]),
                               ord("N"), ord("-")).astype(np.uint8)
    return mat
