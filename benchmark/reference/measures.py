"""The six measures' float64 closed forms and Rust's ``{:.12}`` output,
frozen copies of the reference CLI's (src/measures.rs, src/lib.rs).

``math.log``/``math.sqrt`` are glibc's, the functions Rust's ``f64::ln``
and ``sqrt`` lower to on linux-gnu; each expression keeps the reference's
order of operations, so values are bit for bit the reference's.  The
``*_f32`` forms are the same expressions in float32: the control, one
precision below what the configuration states.
"""

import math

import numpy as np


def div(a, b):
    if b == 0.0:
        if a == 0.0:
            return math.nan
        return math.inf if a > 0 else -math.inf
    return a / b


def ln(x: float) -> float:
    if x > 0.0:
        return math.log(x)
    if x == 0.0:
        return -math.inf
    return math.nan


def sqrt(x: float) -> float:
    return math.sqrt(x) if x >= 0.0 else math.nan


def raw(diff: int, same: int) -> float:
    return div(float(diff), float(same + diff))


def jc69(diff: int, same: int) -> float:
    p = raw(diff, same)
    return -0.75 * ln(1.0 - (4.0 / 3.0) * p)


def k80(same: int, ts: int, tv: int) -> float:
    count_l = same + ts + tv
    p = div(float(ts), float(count_l))
    q = div(float(tv), float(count_l))
    return -0.5 * ln((1.0 - 2.0 * p - q) * sqrt(1.0 - 2.0 * q))


def tn93(same: int, kk: int, p1_count: int, p2_count: int, qc, tc) -> float:
    """qc, tc: the two records' (A, T, G, C) tallies; kk the sites where
    both bases are known."""
    qa, qt, qg, qcc = (int(v) for v in qc)
    ta, tt, tg, tcc = (int(v) for v in tc)
    big_l = qa + qt + qg + qcc + ta + tt + tg + tcc
    g_a = div(float(ta) + float(qa), float(big_l))
    g_c = div(float(tcc) + float(qcc), float(big_l))
    g_g = div(float(tg) + float(qg), float(big_l))
    g_t = div(float(tt) + float(qt), float(big_l))
    g_r = div(float(ta) + float(qa) + float(tg) + float(qg), float(big_l))
    g_y = div(float(tcc) + float(qcc) + float(tt) + float(qt), float(big_l))
    k1 = div(2.0 * g_a * g_g, g_r)
    k2 = div(2.0 * g_t * g_c, g_y)
    k3 = 2.0 * (g_r * g_y - div(g_a * g_g * g_y, g_r)
                - div(g_t * g_c * g_r, g_y))
    count_d = kk - same
    p1 = div(float(p1_count), float(kk))
    p2 = div(float(p2_count), float(kk))
    q_rate = div(float(count_d - (p1_count + p2_count)), float(kk))
    w1 = 1.0 - div(p1, k1) - div(q_rate, 2.0 * g_r)
    w2 = 1.0 - div(p2, k2) - div(q_rate, 2.0 * g_y)
    w3 = 1.0 - div(q_rate, 2.0 * g_r * g_y)
    d = -k1 * ln(w1) - k2 * ln(w2) - k3 * ln(w3)
    if d == 0.0:
        d = 0.0
    return d


def _f(x):
    return np.float32(x)


def _ln32(x):
    x = _f(x)
    if x > 0:
        return _f(np.log(x))
    return _f(-np.inf) if x == 0 else _f(np.nan)


def _div32(a, b):
    a, b = _f(a), _f(b)
    if b == 0:
        return _f(np.nan) if a == 0 else _f(np.inf if a > 0 else -np.inf)
    return _f(a / b)


def raw_f32(diff: int, same: int) -> float:
    return float(_div32(diff, same + diff))


def jc69_f32(diff: int, same: int) -> float:
    p = _div32(diff, same + diff)
    return float(_f(-0.75) * _ln32(_f(1) - _f(4.0 / 3.0) * p))


def k80_f32(same: int, ts: int, tv: int) -> float:
    count_l = same + ts + tv
    p, q = _div32(ts, count_l), _div32(tv, count_l)
    s = _f(1) - _f(2) * q
    root = _f(np.sqrt(s)) if s >= 0 else _f(np.nan)
    return float(_f(-0.5) * _ln32((_f(1) - _f(2) * p - q) * root))


def tn93_f32(same: int, kk: int, p1_count: int, p2_count: int, qc, tc):
    qa, qt, qg, qcc = (_f(v) for v in qc)
    ta, tt, tg, tcc = (_f(v) for v in tc)
    big_l = qa + qt + qg + qcc + ta + tt + tg + tcc
    g_a, g_c = _div32(ta + qa, big_l), _div32(tcc + qcc, big_l)
    g_g, g_t = _div32(tg + qg, big_l), _div32(tt + qt, big_l)
    g_r = _div32(ta + qa + tg + qg, big_l)
    g_y = _div32(tcc + qcc + tt + qt, big_l)
    k1 = _div32(_f(2) * g_a * g_g, g_r)
    k2 = _div32(_f(2) * g_t * g_c, g_y)
    k3 = _f(2) * (g_r * g_y - _div32(g_a * g_g * g_y, g_r)
                  - _div32(g_t * g_c * g_r, g_y))
    p1, p2 = _div32(p1_count, kk), _div32(p2_count, kk)
    q_rate = _div32(kk - same - (p1_count + p2_count), kk)
    w1 = _f(1) - _div32(p1, k1) - _div32(q_rate, _f(2) * g_r)
    w2 = _f(1) - _div32(p2, k2) - _div32(q_rate, _f(2) * g_y)
    w3 = _f(1) - _div32(q_rate, _f(2) * g_r * g_y)
    d = -k1 * _ln32(w1) - k2 * _ln32(w2) - k3 * _ln32(w3)
    return 0.0 if d == 0 else float(d)


def format_value(v) -> str:
    """Rust's output of a distance: integers bare, floats ``{:.12}`` with
    its spellings NaN, inf, -inf and a kept sign of -0.0."""
    if isinstance(v, int):
        return str(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    return f"{v:.12f}"
