/* Native host runtime for distance_tpu_torch.
 *
 * The hot host-side loops of the engine live here, mirroring where the
 * reference keeps native code (the whole reference is native Rust):
 *
 *   - glibc log applied over arrays (exact-parity f64 finalization: Rust's
 *     f64::ln lowers to the same libm log on linux-gnu);
 *   - TSV row formatting with Rust-compatible float formatting
 *     ("{:.12}" fixed 12 decimals, "NaN"/"inf"/"-inf" spellings,
 *     reference/src/lib.rs:626-634);
 *   - FASTA parse + Paradis encode for the streaming path.
 *
 * Built as a plain shared library, loaded via ctypes (no pybind11 in the
 * image).  Everything here is deterministic and thread-free; parallelism
 * belongs to the device.
 */

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

/* ------------------------------------------------------------------ */
/* Exact finalization helpers                                          */
/* ------------------------------------------------------------------ */

/* raw: n/d with 0/0 => NaN (IEEE), measures.rs:56-69 */
void dt_finalize_raw(const int32_t *diff, const int32_t *same, double *out,
                     int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        double nd = (double)diff[i];
        double dd = (double)(same[i] + diff[i]);
        out[i] = nd / dd;
    }
}

/* jc69: -0.75 * ln(1 - (4/3) p), measures.rs:72-77 */
void dt_finalize_jc69(const int32_t *diff, const int32_t *same, double *out,
                      int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        double p = (double)diff[i] / (double)(same[i] + diff[i]);
        out[i] = -0.75 * log(1.0 - (4.0 / 3.0) * p);
    }
}

/* k80: -0.5 * ln((1 - 2P - Q) * sqrt(1 - 2Q)), measures.rs:80-113 */
void dt_finalize_k80(const int32_t *same, const int32_t *ts,
                     const int32_t *tv, double *out, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        double count_l = (double)(same[i] + ts[i] + tv[i]);
        double P = (double)ts[i] / count_l;
        double Q = (double)tv[i] / count_l;
        out[i] = -0.5 * log((1.0 - 2.0 * P - Q) * sqrt(1.0 - 2.0 * Q));
    }
}

/* tn93 closed form for one pair, measures.rs:116-193.  Counter inputs:
 * same/kk/p1/p2; q/t are the two records' (A,T,G,C) tallies.
 * kk == count_L; count_d = kk - same. */

/* ASCII characters str.split() treats as whitespace (header
 * tokenization parity with the Python parser): space, \t, \v, \f,
 * \r, and the separator controls 0x1c-0x1f. */
static inline int dt_hdr_ws(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\v' || c == '\f' ||
           c == '\r' || (c >= 0x1c && c <= 0x1f);
}

static inline double tn93_one(int32_t same, int32_t kk, int32_t p1c,
                              int32_t p2c, const int32_t *q,
                              const int32_t *t) {
    double qa = (double)q[0], qt = (double)q[1];
    double qg = (double)q[2], qcc = (double)q[3];
    double ta = (double)t[0], tt = (double)t[1];
    double tg = (double)t[2], tcc = (double)t[3];
    double L = qa + qt + qg + qcc + ta + tt + tg + tcc;

    double g_A = (ta + qa) / L;
    double g_C = (tcc + qcc) / L;
    double g_G = (tg + qg) / L;
    double g_T = (tt + qt) / L;
    double g_R = (ta + qa + tg + qg) / L;
    double g_Y = (tcc + qcc + tt + qt) / L;

    double k1 = 2.0 * g_A * g_G / g_R;
    double k2 = 2.0 * g_T * g_C / g_Y;
    double k3 = 2.0 * (g_R * g_Y - g_A * g_G * g_Y / g_R -
                       g_T * g_C * g_R / g_Y);

    double count_L = (double)kk;
    int32_t count_d = kk - same;
    double P1 = (double)p1c / count_L;
    double P2 = (double)p2c / count_L;
    double Q = (double)(count_d - (p1c + p2c)) / count_L;

    double w1 = 1.0 - P1 / k1 - Q / (2.0 * g_R);
    double w2 = 1.0 - P2 / k2 - Q / (2.0 * g_Y);
    double w3 = 1.0 - Q / (2.0 * g_R * g_Y);

    double d = -k1 * log(w1) - k2 * log(w2) - k3 * log(w3);
    if (d == 0.0) {
        d = 0.0; /* normalize -0.0, measures.rs:188-190 */
    }
    return d;
}

/* tn93 over a flat block of pairs, gathering each pair's two (A,T,G,C)
 * tally rows from the per-sequence tables by index.  The gather here (8
 * int32 loads/pair) replaces materialized per-pair tally arrays on the
 * host (64 B/pair of repeat/tile traffic) — the index arrays already
 * exist for id emission, so the tally plumbing is free. */
void dt_finalize_tn93_gather(const int32_t *same, const int32_t *kk,
                             const int32_t *p1c, const int32_t *p2c,
                             const int32_t *bcq, /* (nq,4) A,T,G,C */
                             const int32_t *iq,  /* (n,) query row index */
                             const int32_t *bct, /* (nt,4) A,T,G,C */
                             const int32_t *it,  /* (n,) target row index */
                             double *out, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        out[i] = tn93_one(same[i], kk[i], p1c[i], p2c[i],
                          bcq + 4 * (int64_t)iq[i],
                          bct + 4 * (int64_t)it[i]);
    }
}

/* Per-record code-pair histogram for the stream-mode variant-column
 * split.  ``colkey[c]`` is idx(a)*ncodes for columns where the loaded
 * alignment is invariant with code a, or the sentinel bin base for
 * variant columns; ``idx_lut`` maps a record byte to its code index.
 * One pass per record accumulates h[colkey[c] + idx_lut[row[c]]] — the
 * histogram (a few hundred int32 bins, L1-resident) then contracts with
 * each counter's code-pair weight table on the Python side. */
void dt_code_hist(const uint8_t *mat, int64_t rows, int64_t width,
                  const int16_t *colkey, const uint8_t *idx_lut,
                  int32_t *hist, int64_t nbins) {
    for (int64_t r = 0; r < rows; r++) {
        const uint8_t *row = mat + r * width;
        int32_t *h = hist + r * nbins;
        for (int64_t c = 0; c < width; c++) {
            h[colkey[c] + idx_lut[row[c]]]++;
        }
    }
}

/* Per-record counts of 4 specific code values (the tn93 ATGC tally,
 * fastaio.Alignment.count_bases).  One pass; the four equality
 * compares auto-vectorize (vs numpy's four full-matrix boolean
 * temporaries).  Callers parallelize over row ranges from Python
 * (ctypes releases the GIL).  out is (rows, 4) int32. */
void dt_count_bases(const uint8_t *mat, int64_t rows, int64_t width,
                    const uint8_t *codes4, int32_t *out) {
    const uint8_t cA = codes4[0], cT = codes4[1];
    const uint8_t cG = codes4[2], cC = codes4[3];
    for (int64_t r = 0; r < rows; r++) {
        const uint8_t *row = mat + r * width;
        int64_t a = 0, t = 0, g = 0, c = 0;
        for (int64_t j = 0; j < width; j++) {
            uint8_t v = row[j];
            a += (v == cA);
            t += (v == cT);
            g += (v == cG);
            c += (v == cC);
        }
        int32_t *o = out + r * 4;
        o[0] = (int32_t)a;
        o[1] = (int32_t)t;
        o[2] = (int32_t)g;
        o[3] = (int32_t)c;
    }
}

/* ------------------------------------------------------------------ */
/* TSV formatting                                                      */
/* ------------------------------------------------------------------ */

/* Format one f64 the way Rust's "{:.12}" does: fixed 12 decimals
 * (correctly rounded, matching glibc printf), specials spelled
 * NaN / inf / -inf.  Returns bytes written (no NUL guarantees needed). */
static int fmt_f64(char *buf, double v) {
    if (isnan(v)) {
        memcpy(buf, "NaN", 3);
        return 3;
    }
    if (isinf(v)) {
        if (v < 0) {
            memcpy(buf, "-inf", 4);
            return 4;
        }
        memcpy(buf, "inf", 3);
        return 3;
    }
    return snprintf(buf, 352, "%.12f", v);
}

/* Emit TSV rows "id1\tid2\tvalue\n" for a rectangular block of pairs.
 *
 * ids are passed as one concatenated byte blob + offsets (n+1 entries).
 * ``pair_i``/``pair_j`` give, per row to emit, the index into the two id
 * tables; ``values`` the distances in emission order.  Output is appended
 * into ``out`` (caller-sized); returns bytes written, or -1 if the buffer
 * would overflow. */
/* Direct-mapped memo for formatted f64 values, keyed on the bit
 * pattern.  Distances on real alignments repeat heavily (few distinct
 * counter tuples), so most rows skip snprintf entirely; collisions just
 * overwrite.  Strings longer than the slot (extreme magnitudes) bypass
 * the cache. */
#define F64_MEMO_BITS 16
#define F64_MEMO_SLOTS (1 << F64_MEMO_BITS)
#define F64_MEMO_STR 30
typedef struct {
    uint64_t bits;
    uint8_t len; /* 0 = empty slot */
    char s[F64_MEMO_STR];
} f64_memo_slot;

/* Thread-local and persistent across calls: bits -> "%.12f" string is a
 * pure mapping, so stale entries from earlier blocks remain valid. */
static __thread f64_memo_slot f64_memo[F64_MEMO_SLOTS];

int64_t dt_format_rows_f64(const char *ids1, const int64_t *off1,
                           const char *ids2, const int64_t *off2,
                           const int32_t *pair_i, const int32_t *pair_j,
                           const double *values, int64_t n_rows, char *out,
                           int64_t out_cap) {
    f64_memo_slot *memo = f64_memo;
    int64_t w = 0;
    for (int64_t r = 0; r < n_rows; r++) {
        int64_t i = pair_i[r], j = pair_j[r];
        int64_t l1 = off1[i + 1] - off1[i];
        int64_t l2 = off2[j + 1] - off2[j];
        if (w + l1 + l2 + 2 + 360 > out_cap) return -1;
        memcpy(out + w, ids1 + off1[i], l1);
        w += l1;
        out[w++] = '\t';
        memcpy(out + w, ids2 + off2[j], l2);
        w += l2;
        out[w++] = '\t';
        uint64_t bits;
        memcpy(&bits, &values[r], 8);
        f64_memo_slot *slot =
            &memo[(bits * UINT64_C(0x9E3779B97F4A7C15)) >>
                  (64 - F64_MEMO_BITS)];
        if (slot->len && slot->bits == bits) {
            memcpy(out + w, slot->s, slot->len);
            w += slot->len;
        } else {
            int fl = fmt_f64(out + w, values[r]);
            if (fl <= F64_MEMO_STR) {
                slot->bits = bits;
                slot->len = (uint8_t)fl;
                memcpy(slot->s, out + w, fl);
            }
            w += fl;
        }
        out[w++] = '\n';
    }
    return w;
}

/* Keyed-memo rank assignment: one pass over per-row value keys.
 * `rank` (keyspace entries) must arrive filled with -1.  Each new key
 * gets the next dense rank; its key and first-occurrence row are
 * recorded so the caller can gather one representative value per rank.
 * Replaces a bincount + scatter + gather numpy dance (~10x on slow
 * hosts).  Returns the number of distinct keys. */
int64_t dt_key_rank(const int32_t *keys, int64_t n, int32_t *rank,
                    int32_t *present_key, int64_t *first_row,
                    int32_t *vidx) {
    int64_t np = 0;
    for (int64_t r = 0; r < n; r++) {
        int32_t k = keys[r];
        int32_t rr = rank[k];
        if (rr < 0) {
            rr = (int32_t)np;
            rank[k] = rr;
            present_key[np] = k;
            first_row[np] = r;
            np++;
        }
        vidx[r] = rr;
    }
    return np;
}

/* Fused per-row byte length + exclusive prefix sum for the keyed
 * emission path: bounds[r+1] = bounds[r] + |id1| + |id2| + |value| + 3
 * (two tabs + newline).  bounds[0] must be preset by the caller. */
void dt_row_bounds(const int32_t *pair_i, const int32_t *pair_j,
                   const int32_t *vidx, const int32_t *idl1,
                   const int32_t *idl2, const int32_t *vlen, int64_t n,
                   int64_t *bounds) {
    int64_t acc = bounds[0];
    for (int64_t r = 0; r < n; r++) {
        acc += (int64_t)idl1[pair_i[r]] + idl2[pair_j[r]] + vlen[vidx[r]] + 3;
        bounds[r + 1] = acc;
    }
}

/* Assembly-only row emitter: values arrive pre-formatted as a string
 * table (vblob/voffs) plus a per-row index.  Low-diversity alignments
 * have few distinct distances, so the caller formats each unique value
 * once and this loop is pure memcpy. */
int64_t dt_format_rows_pre(const char *ids1, const int64_t *off1,
                           const char *ids2, const int64_t *off2,
                           const int32_t *pair_i, const int32_t *pair_j,
                           const char *vblob, const int64_t *voffs,
                           const int32_t *vidx, int64_t n_rows, char *out,
                           int64_t out_cap) {
    int64_t w = 0;
    for (int64_t r = 0; r < n_rows; r++) {
        int64_t i = pair_i[r], j = pair_j[r], v = vidx[r];
        int64_t l1 = off1[i + 1] - off1[i];
        int64_t l2 = off2[j + 1] - off2[j];
        int64_t lv = voffs[v + 1] - voffs[v];
        if (w + l1 + l2 + lv + 3 > out_cap) return -1;
        memcpy(out + w, ids1 + off1[i], l1);
        w += l1;
        out[w++] = '\t';
        memcpy(out + w, ids2 + off2[j], l2);
        w += l2;
        out[w++] = '\t';
        memcpy(out + w, vblob + voffs[v], lv);
        w += lv;
        out[w++] = '\n';
    }
    return w;
}

/* ------------------------------------------------------------------ */
/* FASTA parse + encode                                                */
/* ------------------------------------------------------------------ */

/* Parse a whole FASTA buffer into a pre-allocated (n_records x width)
 * Paradis-encoded matrix, with ids/descriptions copied into blobs.
 *
 * Line handling matches the Python parser (rust-bio trim_end semantics):
 * records start with '>' at a line start; id = first whitespace token,
 * description = rest of the header; sequence lines are concatenated with
 * only TRAILING whitespace trimmed — leading/embedded whitespace reaches
 * the encoder and errors.  Validation matches the reference: a byte that
 * encodes to 0 is an invalid nucleotide (reported with record index and
 * the byte), and a record whose length differs from `width` is ragged.
 *
 * Returns: 0 ok; 1 invalid nucleotide (err_a = record idx, err_b = byte);
 * 2 ragged (err_a = record idx, err_b = seen width); 3 junk before first
 * '>'; 4 capacity overflow (caller sized blobs wrong); 5 too many
 * records.  Partial fills are valid up to the failing record.
 *
 * `tallies` (optional, caller-zeroed (max_records x 4) int64): per
 * record counts of RAW bytes 'A','T','G','C' — upper-case only, the
 * reference's streamed tn93 quirk (its streamed encoder tallies chars,
 * not codes, reference/src/fastaio.rs:124-142).  NULL skips.
 */
/* Encode one whole sequence-line segment (no width overflow possible —
 * the caller checked col + seg <= width).  Writes Paradis codes to dst,
 * optionally tallies raw upper-case 'A','T','G','C' bytes (the
 * reference's streamed tn93 quirk), and returns nonzero iff ANY byte
 * encoded to 0 (invalid nucleotide) — the caller locates the exact
 * first offender with a cold scalar rescan, so error parity with the
 * careful loop is byte-identical.  On x86 the letter mapping runs as a
 * two-table vpshufb nibble LUT (case bit cleared first; '-' and '?'
 * blend in by direct compare), 32 bytes/iteration. */
static int dt_encode_seg(const uint8_t *src, uint8_t *dst, int64_t seg,
                         const uint8_t *enc_table, int64_t *tly) {
    int64_t p = 0;
    int any_zero = 0;
#if defined(__AVX2__)
    if (seg >= 32) {
        /* letter LUTs from the live table (uppercase rows; the case
         * bit is cleared before lookup and lower case encodes
         * identically — encoding.py pins that): lut0[k] =
         * enc('@'+k) for k in 0..15, lut1[k] = enc('P'+k) for k in
         * 0..9 ('Z'..'_' rows are 0). */
        uint8_t l0[16], l1[16];
        for (int k = 0; k < 16; k++) {
            l0[k] = enc_table[0x40 + k];
            l1[k] = (k < 10) ? enc_table[0x50 + k] : 0;
        }
        const __m256i lut0 = _mm256_broadcastsi128_si256(
            _mm_loadu_si128((const __m128i *)l0));
        const __m256i lut1 = _mm256_broadcastsi128_si256(
            _mm_loadu_si128((const __m128i *)l1));
        const __m256i case_mask = _mm256_set1_epi8((char)0xDF);
        const __m256i c40 = _mm256_set1_epi8(0x40);
        const __m256i c0f = _mm256_set1_epi8(0x0F);
        const __m256i c10 = _mm256_set1_epi8(0x10);
        const __m256i c09 = _mm256_set1_epi8(0x09);
        const __m256i dash = _mm256_set1_epi8('-');
        const __m256i qmark = _mm256_set1_epi8('?');
        const __m256i dash_code =
            _mm256_set1_epi8((char)enc_table[(unsigned char)'-']);
        const __m256i q_code =
            _mm256_set1_epi8((char)enc_table[(unsigned char)'?']);
        const __m256i zero = _mm256_setzero_si256();
        __m256i seen_zero = _mm256_setzero_si256();
        for (; p + 32 <= seg; p += 32) {
            const __m256i v =
                _mm256_loadu_si256((const __m256i *)(src + p));
            const __m256i u = _mm256_and_si256(v, case_mask);
            const __m256i idx = _mm256_sub_epi8(u, c40);
            /* idx in 0..15 -> lut0; MSB-poison every other byte so
             * vpshufb returns 0 (selector MSB set => 0).  cmpgt is
             * signed: idx >= 0x80 already has its MSB. */
            const __m256i s0 =
                _mm256_or_si256(idx, _mm256_cmpgt_epi8(idx, c0f));
            const __m256i t0 = _mm256_shuffle_epi8(lut0, s0);
            /* idx in 16..25 -> lut1 via idx-16 (wraps below 0x10 to
             * >= 0xF0, MSB set) */
            const __m256i i1 = _mm256_sub_epi8(idx, c10);
            const __m256i s1 =
                _mm256_or_si256(i1, _mm256_cmpgt_epi8(i1, c09));
            const __m256i t1 = _mm256_shuffle_epi8(lut1, s1);
            __m256i code = _mm256_or_si256(t0, t1);
            code = _mm256_or_si256(
                code, _mm256_and_si256(_mm256_cmpeq_epi8(v, dash),
                                       dash_code));
            code = _mm256_or_si256(
                code, _mm256_and_si256(_mm256_cmpeq_epi8(v, qmark),
                                       q_code));
            _mm256_storeu_si256((__m256i *)(dst + p), code);
            seen_zero = _mm256_or_si256(
                seen_zero, _mm256_cmpeq_epi8(code, zero));
            if (tly) {
                tly[0] += __builtin_popcount((unsigned)_mm256_movemask_epi8(
                    _mm256_cmpeq_epi8(v, _mm256_set1_epi8('A'))));
                tly[1] += __builtin_popcount((unsigned)_mm256_movemask_epi8(
                    _mm256_cmpeq_epi8(v, _mm256_set1_epi8('T'))));
                tly[2] += __builtin_popcount((unsigned)_mm256_movemask_epi8(
                    _mm256_cmpeq_epi8(v, _mm256_set1_epi8('G'))));
                tly[3] += __builtin_popcount((unsigned)_mm256_movemask_epi8(
                    _mm256_cmpeq_epi8(v, _mm256_set1_epi8('C'))));
            }
        }
        any_zero = (_mm256_movemask_epi8(seen_zero) != 0);
    }
#endif
    if (tly) {
        int64_t ta = 0, tt = 0, tg = 0, tc = 0;
        for (; p < seg; p++) {
            uint8_t ch = src[p];
            uint8_t code = enc_table[ch];
            dst[p] = code;
            any_zero |= (code == 0);
            ta += (ch == 'A');
            tt += (ch == 'T');
            tg += (ch == 'G');
            tc += (ch == 'C');
        }
        tly[0] += ta;
        tly[1] += tt;
        tly[2] += tg;
        tly[3] += tc;
    } else {
        for (; p < seg; p++) {
            uint8_t code = enc_table[src[p]];
            dst[p] = code;
            any_zero |= (code == 0);
        }
    }
    return any_zero;
}

int dt_parse_fasta_fill(const uint8_t *data, int64_t len, int64_t width,
                        int64_t max_records, const uint8_t *enc_table,
                        uint8_t *matrix, char *ids, int64_t ids_cap,
                        int64_t *id_offs, char *descs, int64_t descs_cap,
                        int64_t *desc_offs, int64_t *n_out, int64_t *err_a,
                        int64_t *err_b, int64_t *tallies) {
    int64_t i = 0;
    int64_t rec = -1;     /* current record index */
    int64_t col = 0;      /* sites filled in current record */
    int64_t id_w = 0, desc_w = 0;
    id_offs[0] = 0;
    desc_offs[0] = 0;

    while (i < len) {
        /* start of a line */
        if (data[i] == '>') {
            /* close previous record */
            if (rec >= 0 && col != width) {
                *n_out = rec;
                *err_a = rec;
                *err_b = col;
                return 2;
            }
            rec++;
            if (rec >= max_records) {
                *n_out = rec;
                return 5;
            }
            col = 0;
            i++;
            /* id token: mirror Python's str.split(maxsplit=1) — skip
             * LEADING ASCII whitespace after '>' (">  seq1" has id
             * "seq1", not ""), then the token runs to the next
             * whitespace (space, tab, \v, \f, \r) or EOL */
            while (i < len && data[i] != '\n' && dt_hdr_ws(data[i]))
                i++;
            int64_t start = i;
            while (i < len && data[i] != '\n' && !dt_hdr_ws(data[i]))
                i++;
            if (id_w + (i - start) > ids_cap) return 4;
            memcpy(ids + id_w, data + start, i - start);
            id_w += i - start;
            id_offs[rec + 1] = id_w;
            /* skip the separating whitespace run, then description till
             * EOL; only the EOL's trailing \r is trimmed (Python keeps
             * trailing spaces/tabs in the description verbatim) */
            while (i < len && data[i] != '\n' && dt_hdr_ws(data[i]))
                i++;
            start = i;
            while (i < len && data[i] != '\n') i++;
            int64_t dend = i;
            while (dend > start && data[dend - 1] == '\r')
                dend--;
            if (desc_w + (dend - start) > descs_cap) return 4;
            memcpy(descs + desc_w, data + start, dend - start);
            desc_w += dend - start;
            desc_offs[rec + 1] = desc_w;
            if (i < len) i++; /* consume newline */
        } else {
            /* sequence (or blank/junk) line */
            int64_t start = i;
            const uint8_t *nl = memchr(data + i, '\n', (size_t)(len - i));
            int64_t end = nl ? (int64_t)(nl - data) : len;
            i = nl ? end + 1 : len; /* consume newline */
            /* trim trailing whitespace only (rust-bio trim_end) */
            while (end > start &&
                   (data[end - 1] == '\r' || data[end - 1] == ' ' ||
                    data[end - 1] == '\t' || data[end - 1] == '\v' ||
                    data[end - 1] == '\f'))
                end--;
            if (start == end) continue; /* blank */
            if (rec < 0) {
                *n_out = 0;
                return 3;
            }
            uint8_t *row = matrix + rec * width;
            int64_t *tly = tallies ? tallies + rec * 4 : NULL;
            int64_t seg = end - start;
            if (col + seg <= width) {
                /* fast path (whole line fits): branchless LUT map.  An
                 * invalid byte encodes to 0; the loop only accumulates a
                 * flag, and the exact first offender (byte + position
                 * parity with the careful loop below) is located by a
                 * cold rescan.  On error the row holds garbage past the
                 * offender — contractually fine: "partial fills are
                 * valid up to the FAILING record", and every caller
                 * discards the failing record (replay/raise). */
                const uint8_t *src = data + start;
                uint8_t *dst = row + col;
                if (dt_encode_seg(src, dst, seg, enc_table, tly)) {
                    for (int64_t p = 0; p < seg; p++) {
                        if (enc_table[src[p]] == 0) {
                            *n_out = rec + 1;
                            *err_a = rec;
                            *err_b = src[p];
                            return 1;
                        }
                    }
                }
                col += seg;
                continue;
            }
            /* careful path: the line overflows `width` (ragged record —
             * keep counting so the error reports the full seen length,
             * like the Python path; an invalid byte still wins if it
             * comes first, code check before the width check) */
            for (int64_t p = start; p < end; p++) {
                uint8_t code = enc_table[data[p]];
                if (code == 0) {
                    *n_out = rec + 1;
                    *err_a = rec;
                    *err_b = data[p];
                    return 1;
                }
                if (tly) {
                    uint8_t ch = data[p];
                    if (ch == 'A') tly[0]++;
                    else if (ch == 'T') tly[1]++;
                    else if (ch == 'G') tly[2]++;
                    else if (ch == 'C') tly[3]++;
                }
                if (col >= width) {
                    col++;
                    continue;
                }
                row[col++] = code;
            }
        }
    }
    if (rec >= 0 && col != width) {
        *n_out = rec;
        *err_a = rec;
        *err_b = col;
        return 2;
    }
    *n_out = rec + 1;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Diff-encoded upload extraction (ops/diffup.py)                      */
/* ------------------------------------------------------------------ */

/* Count bytes differing from `ref` over `rows` consecutive rows of a
 * row-major (rows, l) matrix.  Bandwidth-bound single pass; callers
 * chunk rows across threads (ctypes releases the GIL). */
int64_t dt_diff_count(const uint8_t *mat, const uint8_t *ref, int64_t rows,
                      int64_t l) {
    int64_t total = 0;
    for (int64_t r = 0; r < rows; r++) {
        const uint8_t *row = mat + r * l;
        int64_t c = 0;
        for (int64_t i = 0; i < l; i++) c += row[i] != ref[i];
        total += c;
    }
    return total;
}

/* Write (linear index, value) pairs for every byte differing from `ref`
 * over `rows` consecutive rows; indices are `base + r*l + col` (callers
 * pass base = first_row * l so indices address the full matrix and the
 * whole emitted run is ascending).  Returns pairs written. */
int64_t dt_diff_fill(const uint8_t *mat, const uint8_t *ref, int64_t rows,
                     int64_t l, int64_t base, int32_t *idx, uint8_t *val) {
    int64_t w = 0;
    for (int64_t r = 0; r < rows; r++) {
        const uint8_t *row = mat + r * l;
        int64_t rb = base + r * l;
        for (int64_t i = 0; i < l; i++) {
            if (row[i] != ref[i]) {
                idx[w] = (int32_t)(rb + i);
                val[w] = row[i];
                w++;
            }
        }
    }
    return w;
}

/* rel4 host finish (ops/packing.py): expand one channel's 4-bit lane
 * rows [r0, r1) into int32 counters with the rank-1 baseline applied,
 * cropped to vc columns.  Returns the number of -8 sentinels seen in
 * the cropped region (the caller patches exception positions afterwards
 * and treats any remainder as saturation).  Replaces a 4-pass numpy
 * dance (nibble expand, sentinel mask, baseline broadcast add) with one
 * bandwidth-bound pass; callers chunk rows across threads. */
int64_t dt_rel4_expand_add(const int8_t *lanes, int64_t cols_half,
                           int64_t r0, int64_t r1, const int32_t *rb,
                           const int32_t *cb, int32_t cc, int64_t vc,
                           int32_t *out) {
    int64_t sent = 0;
    for (int64_t r = r0; r < r1; r++) {
        const uint8_t *lr = (const uint8_t *)lanes + r * cols_half;
        int32_t rbv = rb[r] - cc;
        int32_t *orow = out + r * vc;
        for (int64_t ch = 0; ch < cols_half; ch++) {
            uint8_t b = lr[ch];
            int64_t col = 2 * ch;
            if (col >= vc) break;
            int32_t lo = b & 0xF;
            lo -= (lo > 7) * 16; /* sign-extend the nibble */
            sent += (lo == -8);
            orow[col] = lo + rbv + cb[col];
            if (col + 1 < vc) {
                int32_t hi = (b >> 4) & 0xF;
                hi -= (hi > 7) * 16;
                sent += (hi == -8);
                orow[col + 1] = hi + rbv + cb[col + 1];
            }
        }
    }
    return sent;
}

/* Blocked int32 transpose with a per-output-row additive offset: for
 * c in [c0, c1), r in [0, rows): out[c*rows + r] = in[r*in_stride + c]
 * + add[c].  Stream emission is streamed-major but counters arrive
 * loaded-major; this replaces numpy's strided transpose copy plus a
 * broadcast add (two full passes) with one cache-blocked pass.  Callers
 * chunk [c0, c1) across threads. */
void dt_transpose_add_i32(const int32_t *in, int64_t rows,
                          int64_t in_stride, int64_t c0, int64_t c1,
                          const int32_t *add, int32_t *out) {
    const int64_t B = 64;
    for (int64_t cb = c0; cb < c1; cb += B) {
        int64_t ce = cb + B < c1 ? cb + B : c1;
        for (int64_t rb = 0; rb < rows; rb += B) {
            int64_t re = rb + B < rows ? rb + B : rows;
            for (int64_t c = cb; c < ce; c++) {
                int32_t a = add[c];
                int32_t *orow = out + c * rows;
                const int32_t *icol = in + c;
                for (int64_t r = rb; r < re; r++) {
                    orow[r] = icol[r * in_stride] + a;
                }
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* CPU reference byte loop (baseline proxy for benchmarking)           */
/* ------------------------------------------------------------------ */

/* The reference's `raw` site loop (measures.rs:56-69) over `n_pairs`
 * consecutive (i, j) pairs of rows of an (n, L) matrix, accumulating a
 * checksum so the loop cannot be optimized away.  Used by bench.py to
 * measure what a per-core CPU implementation achieves on this host. */
int64_t dt_cpu_raw_pairs(const uint8_t *mat, int64_t n, int64_t L,
                         const int32_t *pi, const int32_t *pj,
                         int64_t n_pairs) {
    int64_t sink = 0;
    for (int64_t p = 0; p < n_pairs; p++) {
        const uint8_t *a = mat + (int64_t)pi[p] * L;
        const uint8_t *b = mat + (int64_t)pj[p] * L;
        int64_t d = 0, nn = 0;
        for (int64_t i = 0; i < L; i++) {
            if ((a[i] & 8) == 8 && a[i] == b[i]) {
                d += 1;
            } else if ((a[i] & b[i]) < 16) {
                d += 1;
                nn += 1;
            }
        }
        sink += d + 31 * nn;
    }
    return sink;
}

int64_t dt_format_rows_i64(const char *ids1, const int64_t *off1,
                           const char *ids2, const int64_t *off2,
                           const int32_t *pair_i, const int32_t *pair_j,
                           const int64_t *values, int64_t n_rows, char *out,
                           int64_t out_cap) {
    int64_t w = 0;
    for (int64_t r = 0; r < n_rows; r++) {
        int64_t i = pair_i[r], j = pair_j[r];
        int64_t l1 = off1[i + 1] - off1[i];
        int64_t l2 = off2[j + 1] - off2[j];
        if (w + l1 + l2 + 2 + 32 > out_cap) return -1;
        memcpy(out + w, ids1 + off1[i], l1);
        w += l1;
        out[w++] = '\t';
        memcpy(out + w, ids2 + off2[j], l2);
        w += l2;
        out[w++] = '\t';
        w += snprintf(out + w, 24, "%lld", (long long)values[r]);
        out[w++] = '\n';
    }
    return w;
}

/* Fused strip-triangle gather + emission-index build for one row range.
 *
 * A square-mode strip holds counters for rows i0..i0+si-1 over a column
 * window starting at absolute column col0; row li's emitted region is
 * absolute columns i0+li+1 .. n-1, which is CONTIGUOUS in the strip.
 * This writes, for local rows [r0, r1):
 *   outc[g*total + starts[li] ..] = strip[g*gstride + li*rstride + lo ..]
 * (gstride/rstride = elements between counter planes / rows — strips
 * may be cropped views of larger buffers, e.g. fetched padded strips or
 * the out-of-core group buffer; only the column axis must be unit.)
 *   pair_i[starts[li] ..]  = i0 + li
 *   col_idx[starts[li] ..] = col0 + lo, col0 + lo + 1, ...
 * starts[] is the exclusive prefix sum of region lengths (starts[si] ==
 * total).  Disjoint row ranges write disjoint output spans, so the
 * caller parallelizes by chunking rows across threads (GIL released).
 * Replaces the numpy repeat/arange index build + per-row slice
 * concatenation — one pass, no temporaries. */
void dt_gather_strip_tri(const int32_t *strip, int64_t G, int64_t gstride,
                         int64_t rstride, int64_t hi, int64_t i0, int64_t col0,
                         const int64_t *starts, int64_t total,
                         int64_t r0, int64_t r1, int32_t *outc,
                         int32_t *pair_i, int32_t *col_idx, int64_t tri) {
    for (int64_t li = r0; li < r1; li++) {
        /* tri=1: square-mode upper triangle (row li emits columns >
         * i0+li); tri=0: full rows (rectangle / two-file mode) */
        int64_t lo = tri ? i0 + li + 1 - col0 : 0;
        if (lo < 0) lo = 0;
        if (lo > hi) lo = hi;
        int64_t len = hi - lo;
        if (len <= 0) continue;
        int64_t dst = starts[li];
        for (int64_t g = 0; g < G; g++)
            memcpy(outc + g * total + dst,
                   strip + g * gstride + li * rstride + lo,
                   (size_t)len * sizeof(int32_t));
        int32_t pi = (int32_t)(i0 + li);
        int32_t c0 = (int32_t)(col0 + lo);
        for (int64_t k = 0; k < len; k++) {
            pair_i[dst + k] = pi;
            col_idx[dst + k] = c0 + (int32_t)k;
        }
    }
}

/* Fused linear key build: out[i] = ca*a[i] + cb*b[i] (+ cc*c[i]) + c0,
 * computed in int64, stored int32 (callers guarantee the result fits —
 * it is a memo key < 2^26).  Every keyed measure's memo key is linear
 * in its counters given the constant width W:
 *   raw/jc69: key = d*nm + (W - d - same)      (nm = nonsame_max+1)
 *   k80:      key = (nonl*tm + ts)*vm + tv, nonl = W - same - ts - tv
 * One parallel pass replaces ~6 numpy temporary passes.  c may be NULL. */
void dt_keys_lin3(const int32_t *a, const int32_t *b, const int32_t *c,
                  int64_t n, int64_t ca, int64_t cb, int64_t cc, int64_t c0,
                  int32_t *out) {
    if (c) {
        for (int64_t i = 0; i < n; i++)
            out[i] = (int32_t)(ca * a[i] + cb * b[i] + cc * c[i] + c0);
    } else {
        for (int64_t i = 0; i < n; i++)
            out[i] = (int32_t)(ca * a[i] + cb * b[i] + c0);
    }
}

/* tn93 keyed memo: fold the two sides' tally ranks into the counter
 * key.  A pair's tn93 value is a pure function of (counters, tally_q +
 * tally_t); equal (counter key, rank_q, rank_t) implies equal tally
 * rows (ranks are dense over DISTINCT rows) hence an equal value, so
 * the keyed writer can finalize one representative per combined key.
 *   out[k] = keyc[k] * (rq_card * rt_card)
 *            + rank_q[pair_i[k]] * rt_card + rank_t[pair_j[k]]        */
void dt_keys_rank2(const int32_t *keyc, const int32_t *pair_i,
                   const int32_t *pair_j, const int32_t *rank_q,
                   const int32_t *rank_t, int64_t n, int64_t rq_card,
                   int64_t rt_card, int32_t *out) {
    const int64_t m = rq_card * rt_card;
    for (int64_t k = 0; k < n; k++) {
        out[k] = (int32_t)((int64_t)keyc[k] * m +
                           (int64_t)rank_q[pair_i[k]] * rt_card +
                           rank_t[pair_j[k]]);
    }
}

/* Hash-rank variant of dt_keys_rank2 for key products beyond the dense
 * rank table (tn93: counter-space x Rq x Rt routinely exceeds the
 * dense cap even when the OCCURRING combinations are few).  Phase 1 of
 * three (the serial single-pass version was the measured tail of the
 * tn93 composed emission at 401 M rows — 5.2 s): rows [r0, r1) combine
 * their 64-bit key and claim a slot in the SHARED open-address table
 * with a CAS, writing out[k] = slot index.  Chunks run concurrently;
 * each key lands in exactly one slot because every prober walks the
 * same probe path and either wins the CAS or observes the winner's key
 * at that slot.  `key_tab` (1<<table_bits int64 entries) must arrive
 * filled with -1 (keys are non-negative); `nd` is the shared atomic
 * distinct counter.  Returns 0, or -1 once distinct keys exceed
 * `max_distinct` (the memo would not pay; all chunks bail promptly).
 * Rank values are assigned from the final table by the caller in
 * ascending-key order, so results are deterministic regardless of racy
 * slot placement. */
int dt_keys_hashrank_slots(const int32_t *keyc, const int32_t *pair_i,
                           const int32_t *pair_j, const int32_t *rank_q,
                           const int32_t *rank_t, int64_t r0, int64_t r1,
                           int64_t rq_card, int64_t rt_card,
                           int64_t *key_tab, int64_t table_bits,
                           int64_t max_distinct, int64_t *nd,
                           int32_t *out) {
    const int64_t m = rq_card * rt_card;
    const uint64_t mask = (UINT64_C(1) << table_bits) - 1;
    for (int64_t k = r0; k < r1; k++) {
        int64_t k64 = (int64_t)keyc[k] * m +
                      (int64_t)rank_q[pair_i[k]] * rt_card +
                      rank_t[pair_j[k]];
        uint64_t h = ((uint64_t)k64 * UINT64_C(0x9E3779B97F4A7C15)) >>
                     (64 - table_bits);
        for (;;) {
            int64_t cur = __atomic_load_n(&key_tab[h], __ATOMIC_ACQUIRE);
            if (cur == -1) {
                if (__atomic_compare_exchange_n(&key_tab[h], &cur, k64, 0,
                                                __ATOMIC_ACQ_REL,
                                                __ATOMIC_ACQUIRE)) {
                    if (__atomic_add_fetch(nd, 1, __ATOMIC_RELAXED) >
                        max_distinct)
                        return -1;
                    out[k] = (int32_t)h;
                    break;
                }
                /* CAS failed: cur now holds the winner's key. */
            }
            if (cur == k64) {
                out[k] = (int32_t)h;
                break;
            }
            h = (h + 1) & mask;
        }
        if ((k & 0x3FFFF) == 0 &&
            __atomic_load_n(nd, __ATOMIC_RELAXED) > max_distinct)
            return -1; /* another chunk overflowed; stop early */
    }
    return 0;
}

/* Phase 3 of the hash-rank: map each slot index to its rank, in place.
 * (Phase 2 — ascending-key rank assignment over the <= 2^20 occupied
 * slots — is a trivial numpy argsort in the caller.) */
void dt_map_i32(const int32_t *tab, int64_t r0, int64_t r1, int32_t *buf) {
    for (int64_t k = r0; k < r1; k++) buf[k] = tab[buf[k]];
}

/* Parallel-friendly min/max of an int32 array (range [r0, r1)). */
void dt_minmax_i32(const int32_t *a, int64_t r0, int64_t r1,
                   int32_t *mn, int32_t *mx) {
    int32_t lo = a[r0], hi = a[r0];
    for (int64_t i = r0 + 1; i < r1; i++) {
        int32_t v = a[i];
        if (v < lo) lo = v;
        if (v > hi) hi = v;
    }
    *mn = lo;
    *mx = hi;
}
