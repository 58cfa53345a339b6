"""An HIV-1 pol-like alignment: a two-level tree of lineages with
population-sequencing mixtures.

A root of HIV-1's A-rich composition; cluster founders diverged from it;
members diverged from their founder, each member's founder drawn
uniformly.  A substitution is a transition with probability
``transition_share`` and else one of the two transversions, and each
site's rate is drawn from a gamma distribution of mean 1.  Then about
``mixture_share`` of the cells become a two-base IUPAC code (R and Y
most), ``n_share`` become N, and ``gap_codon_share`` of the codons become
a whole-codon gap.  Every draw is vectorised over the matrix.
"""

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
MIXTURES = np.frombuffer(b"RYKMSW", dtype=np.uint8)


def _evolve(rng, parents: np.ndarray, rate: np.ndarray,
            ts_share: float) -> np.ndarray:
    """Each cell of ``parents`` (base indices 0-3 for ACGT) substituted
    with probability ``rate`` of its site: A<->G and C<->T (index ^ 2) with
    probability ``ts_share``, else a transversion (index ^ 1 or ^ 3)."""
    out = parents.copy()
    hit = rng.random(parents.shape) < rate
    k = int(hit.sum())
    tv = rng.choice(np.array([1, 3], dtype=np.uint8), size=k)
    out[hit] ^= np.where(rng.random(k) < ts_share, np.uint8(2), tv)
    return out


def make(cfg: dict, records: int, seed: int) -> np.ndarray:
    """A (records, sites) matrix of upper-case FASTA characters."""
    sites = int(cfg["sites"])
    rng = np.random.default_rng(seed)
    freqs = np.asarray(cfg["base_freqs"], dtype=np.float64)
    root = rng.choice(4, size=sites, p=freqs / freqs.sum()).astype(np.uint8)
    shape = float(cfg["site_rate_shape"])
    rate = rng.gamma(shape, 1.0 / shape, size=sites)
    rate /= rate.mean()
    ts = float(cfg["transition_share"])
    founders = max(1, records // int(cfg["cluster_size_mean"]))
    f_rate = np.minimum(float(cfg["founder_divergence"]) * rate, 0.75)
    m_rate = np.minimum(float(cfg["member_divergence"]) * rate, 0.75)
    tops = _evolve(rng, np.broadcast_to(root, (founders, sites)), f_rate, ts)
    idx = _evolve(rng, tops[rng.integers(0, founders, size=records)], m_rate,
                  ts)
    mat = BASES[idx]
    cells = records * sites

    def scatter(share: float):
        k = int(round(share * cells))
        return rng.integers(0, records, size=k), rng.integers(0, sites,
                                                              size=k)

    rows, cols = scatter(float(cfg["mixture_share"]))
    weights = np.asarray(cfg["mixture_weights"], dtype=np.float64)
    mat[rows, cols] = rng.choice(MIXTURES, size=rows.size,
                                 p=weights / weights.sum())
    rows, cols = scatter(float(cfg["n_share"]))
    mat[rows, cols] = ord("N")
    codons = sites // 3
    k = int(round(float(cfg["gap_codon_share"]) * records * codons))
    rows = rng.integers(0, records, size=k)
    first = 3 * rng.integers(0, codons, size=k)
    for d in range(3):
        mat[rows, first + d] = ord("-")
    return mat
