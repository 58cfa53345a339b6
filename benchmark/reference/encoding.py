"""Paradis 8-bit nucleotide codes (a frozen copy of the reference CLI's
table).  High nibble: the candidate set over {A, G, C, T}; bit 3: the
base is known exactly; bits 2..0 tell N, '-' and '?' apart."""

import numpy as np

A, G, C, T = 136, 72, 40, 24
R, M, W, S, K, Y = 192, 160, 144, 96, 80, 48
V, H, D, B, N = 224, 176, 208, 112, 240
GAP, UNK = 244, 242

CHAR_CODES = {
    "A": A, "G": G, "C": C, "T": T,
    "R": R, "M": M, "W": W, "S": S, "K": K, "Y": Y,
    "V": V, "H": H, "D": D, "B": B, "N": N,
    "-": GAP, "?": UNK,
}


def table() -> np.ndarray:
    """Byte -> code; both cases of a letter share a code, other bytes 0."""
    t = np.zeros(256, dtype=np.uint8)
    for ch, code in CHAR_CODES.items():
        t[ord(ch)] = code
        if ch.isalpha():
            t[ord(ch.lower())] = code
    return t


ENCODE = table()
