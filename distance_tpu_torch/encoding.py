"""Paradis 8-bit bitwise nucleotide encoding.

Semantics match the reference table (reference/src/encoding.rs:4-41):
each IUPAC nucleotide byte maps to one uint8 code whose high nibble
(bits 7..4) is the candidacy set over {A, G, C, T} and whose bit 3 marks
"base known exactly".  Unmapped bytes encode to 0, which the I/O layer
treats as a hard error ("invalid nucleotide").

Bit layout (value 0bAGCT_Kxxx):

    bit 7: A candidate     bit 3: base known exactly
    bit 6: G candidate     bits 2..0: distinguish N / - / ?
    bit 5: C candidate
    bit 4: T candidate

Site predicates used by the measures (reference/src/measures.rs):

    certainly different :  (a & b) < 16     (candidacy sets disjoint)
    certainly same      :  a == b and (a & 8) == 8
    purine-set          :  (a & 55) == 0    (candidacy subset of {A, G})
    pyrimidine-set      :  (a & 199) == 0   (candidacy subset of {C, T})
    A<->G transition    :  (a | b) == 200   (within both-known sites)
    C<->T transition    :  (a | b) == 56
"""

from __future__ import annotations

import numpy as np

# Exact-base codes (candidacy bit + known bit).
A = 136  # 1000_1000
G = 72   # 0100_1000
C = 40   # 0010_1000
T = 24   # 0001_1000

# Ambiguity codes (candidacy sets, known bit clear).
R = 192  # A|G
M = 160  # A|C
W = 144  # A|T
S = 96   # G|C
K = 80   # G|T
Y = 48   # C|T
V = 224  # A|G|C
H = 176  # A|C|T
D = 208  # A|G|T
B = 112  # G|C|T
N = 240  # A|G|C|T
GAP = 244   # '-' : any base, bit 2 set
UNK = 242   # '?' : any base, bit 1 set

KNOWN_BIT = 8

_CHAR_CODES = {
    "A": A, "G": G, "C": C, "T": T,
    "R": R, "M": M, "W": W, "S": S, "K": K, "Y": Y,
    "V": V, "H": H, "D": D, "B": B, "N": N,
    "-": GAP, "?": UNK,
}


def encoding_array() -> np.ndarray:
    """256-entry byte -> Paradis-code lookup table (uint8).

    Upper- and lower-case letters map to the same code; every other byte
    maps to 0 (invalid).
    """
    table = np.zeros(256, dtype=np.uint8)
    for ch, code in _CHAR_CODES.items():
        table[ord(ch)] = code
        if ch.isalpha():
            table[ord(ch.lower())] = code
    return table


ENCODING = encoding_array()

# All 17 valid codes, for tests and feature-channel construction.
ALL_CODES = np.array(
    [A, G, C, T, R, M, W, S, K, Y, V, H, D, B, N, GAP, UNK], dtype=np.uint8
)

# Decoded (upper-case) character for each code, for round-tripping in tests.
CODE_TO_CHAR = {code: ch for ch, code in _CHAR_CODES.items()}
