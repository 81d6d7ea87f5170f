/* Copy of rag_application_tpu/native/jbig2.c. */

/* JBIG2 MQ arithmetic decoder + generic-region decoding (ITU-T T.88
 * 6.2.5.7 / Annex E), the hot inner loop of scanned-PDF JBIG2 images.
 *
 * The Python side (ingest/jbig2.py) parses the embedded segment
 * structure and calls jbig2_generic_decode once per region; a full
 * 300-dpi page is ~8M pixels x ~16 context loads, which is why this
 * loop is C (ctypes, built on first use like native/analyzer.c).
 *
 * Parity anchor: the reference rasterizes scanned PDFs through
 * pdf2image/poppler (IndexerAPI/src/core/processors/utils.py:16-22);
 * here the codec is native so no system dependency is needed.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---------------------------------------------------------- MQ coder */

static const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
    0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
    0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
    0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
static const uint8_t NMPS[47] = {
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
static const uint8_t NLPS[47] = {
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15,
    16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
    31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
static const uint8_t SWITCH_[47] = {
    1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0};

typedef struct {
    uint32_t c, a;
    int ct;
    long bp;
    const uint8_t *data;
    long n;
} MQ;

static uint8_t mq_b(const MQ *m, long i) {
    return i < m->n ? m->data[i] : 0xFF; /* past-end feeds marker bytes */
}

static void mq_bytein(MQ *m) {
    if (mq_b(m, m->bp) == 0xFF) {
        if (mq_b(m, m->bp + 1) > 0x8F) {
            m->c += 0xFF00;
            m->ct = 8;
        } else {
            m->bp++;
            m->c += (uint32_t)mq_b(m, m->bp) << 9;
            m->ct = 7;
        }
    } else {
        m->bp++;
        m->c += (uint32_t)mq_b(m, m->bp) << 8;
        m->ct = 8;
    }
}

static void mq_init(MQ *m, const uint8_t *data, long n) {
    m->data = data;
    m->n = n;
    m->bp = 0;
    m->c = (uint32_t)mq_b(m, 0) << 16;
    mq_bytein(m);
    m->c <<= 7;
    m->ct -= 7;
    m->a = 0x8000;
}

/* cx packs (index, mps) per context: low 7 bits index, bit 7 mps */
static int mq_decode(MQ *m, uint8_t *cx) {
    int i = *cx & 0x7F;
    int mps = *cx >> 7;
    uint32_t q = QE[i];
    int d;
    m->a -= q;
    if (((m->c >> 16) & 0xFFFF) < q) {
        if (m->a < q) {
            d = mps;
            *cx = (uint8_t)((mps << 7) | NMPS[i]);
        } else {
            d = 1 - mps;
            if (SWITCH_[i]) mps ^= 1;
            *cx = (uint8_t)((mps << 7) | NLPS[i]);
        }
        m->a = q;
        do {
            if (m->ct == 0) mq_bytein(m);
            m->a <<= 1;
            m->c <<= 1;
            m->ct--;
        } while (!(m->a & 0x8000));
    } else {
        m->c -= q << 16;
        if (!(m->a & 0x8000)) {
            if (m->a < q) {
                d = 1 - mps;
                if (SWITCH_[i]) mps ^= 1;
                *cx = (uint8_t)((mps << 7) | NLPS[i]);
            } else {
                d = mps;
                *cx = (uint8_t)((mps << 7) | NMPS[i]);
            }
            do {
                if (m->ct == 0) mq_bytein(m);
                m->a <<= 1;
                m->c <<= 1;
                m->ct--;
            } while (!(m->a & 0x8000));
        } else {
            d = mps;
        }
    }
    return d;
}

/* ------------------------------------------------- generic region */

/* coding templates (T.88 fig. 4, 8-10), AT pixels appended; the
 * context is the template pixels in raster (y, x) order, MSB first */
typedef struct {
    int x, y;
} Pt;

static int build_template(int gbtemplate, const signed char *at, Pt *tmpl) {
    static const Pt t0[] = {{-1, -2}, {0, -2}, {1, -2}, {-2, -1}, {-1, -1},
                            {0, -1},  {1, -1}, {2, -1}, {-4, 0},  {-3, 0},
                            {-2, 0},  {-1, 0}};
    static const Pt t1[] = {{-1, -2}, {0, -2}, {1, -2}, {2, -2},
                            {-2, -1}, {-1, -1}, {0, -1}, {1, -1},
                            {2, -1},  {-3, 0},  {-2, 0}, {-1, 0}};
    static const Pt t2[] = {{-1, -2}, {0, -2}, {1, -2}, {-2, -1}, {-1, -1},
                            {0, -1},  {1, -1}, {-2, 0}, {-1, 0}};
    static const Pt t3[] = {{-3, -1}, {-2, -1}, {-1, -1}, {0, -1}, {1, -1},
                            {-4, 0},  {-3, 0},  {-2, 0},  {-1, 0}};
    int n = 0, nat = gbtemplate == 0 ? 4 : 1, i, j;
    const Pt *base;
    int nbase;
    switch (gbtemplate) {
        case 0: base = t0; nbase = 12; break;
        case 1: base = t1; nbase = 12; break;
        case 2: base = t2; nbase = 9; break;
        default: base = t3; nbase = 9; break;
    }
    for (i = 0; i < nbase; i++) tmpl[n++] = base[i];
    for (i = 0; i < nat; i++) {
        Pt p = {at[2 * i], at[2 * i + 1]};
        tmpl[n++] = p;
    }
    /* stable sort by (y, x) — insertion sort, n <= 16 */
    for (i = 1; i < n; i++) {
        Pt key = tmpl[i];
        j = i - 1;
        while (j >= 0 && (tmpl[j].y > key.y ||
                          (tmpl[j].y == key.y && tmpl[j].x > key.x))) {
            tmpl[j + 1] = tmpl[j];
            j--;
        }
        tmpl[j + 1] = key;
    }
    return n;
}

/* core loop over a caller-provided MQ state + GB context bank (so a
 * symbol dictionary's bitmaps share one arithmetic stream, T.88 6.5.8) */
static int generic_into(MQ *mq, uint8_t *cx, uint8_t *out, int w, int h,
                        int gbtemplate, int tpgdon, const signed char *at) {
    Pt tmpl[16];
    int ntmpl, x, y, k, ltp = 0;
    uint32_t ctx;
    static const uint32_t sltp_ctx[4] = {0x9B25, 0x0795, 0x00E5, 0x0195};
    if (gbtemplate < 0 || gbtemplate > 3 || w <= 0 || h <= 0) return -1;
    ntmpl = build_template(gbtemplate, at, tmpl);
    (void)ntmpl;
    memset(out, 0, (size_t)w * h);
    for (y = 0; y < h; y++) {
        if (tpgdon) {
            ltp ^= mq_decode(mq, &cx[sltp_ctx[gbtemplate]]);
            if (ltp) {
                if (y > 0) memcpy(out + (size_t)y * w, out + (size_t)(y - 1) * w, w);
                continue;
            }
        }
        for (x = 0; x < w; x++) {
            ctx = 0;
            for (k = 0; k < ntmpl; k++) {
                int px = x + tmpl[k].x, py = y + tmpl[k].y;
                uint32_t bit = 0;
                if (px >= 0 && px < w && py >= 0 && py < h)
                    bit = out[(size_t)py * w + px];
                ctx = (ctx << 1) | bit;
            }
            out[(size_t)y * w + x] = (uint8_t)mq_decode(mq, &cx[ctx]);
        }
    }
    return 0;
}

/* out: w*h bytes, 0/1. Returns 0 on success. */
int jbig2_generic_decode(const uint8_t *data, long n, int w, int h,
                         int gbtemplate, int tpgdon, const signed char *at,
                         uint8_t *out) {
    MQ mq;
    uint8_t *cx;
    int rc;
    if (gbtemplate < 0 || gbtemplate > 3 || w <= 0 || h <= 0) return -1;
    cx = (uint8_t *)calloc(1L << 16, 1);
    if (!cx) return -2;
    mq_init(&mq, data, n);
    rc = generic_into(&mq, cx, out, w, h, gbtemplate, tpgdon, at);
    free(cx);
    return rc;
}

/* --------------------- resumable decoder handle (symbol/text regions)
 *
 * A symbol dictionary (T.88 6.5) interleaves Annex-A integer decisions
 * (IADH/IADW/IAEX/...) with per-symbol generic-region bitmaps on ONE
 * arithmetic stream; the Python side (ingest/jbig2.py) drives the
 * control flow and calls back here for every per-pixel / per-bit loop.
 */

void *jbig2_mq_new(const uint8_t *data, long n) {
    MQ *m = (MQ *)malloc(sizeof(MQ));
    if (!m) return 0;
    mq_init(m, data, n);
    return m;
}

void jbig2_mq_free(void *h) { free(h); }

/* Annex A.2 integer decoding; cx is the caller's 512-byte context bank
 * for one IAx class. Returns 1 = value in *out, 0 = OOB. */
int jbig2_int_decode(void *h, uint8_t *cx, int32_t *out) {
    MQ *m = (MQ *)h;
    uint32_t prev = 1;
    int s, i, nbits;
    int64_t v = 0, off = 0;
#define IBIT()                                                       \
    ({                                                               \
        int _b = mq_decode(m, &cx[prev]);                            \
        prev = prev < 256 ? ((prev << 1) | (uint32_t)_b)             \
                          : (((((prev << 1) | (uint32_t)_b)) & 511)  \
                             | 256);                                 \
        _b;                                                          \
    })
    s = IBIT();
    if (!IBIT()) { nbits = 2; off = 0; }
    else if (!IBIT()) { nbits = 4; off = 4; }
    else if (!IBIT()) { nbits = 6; off = 20; }
    else if (!IBIT()) { nbits = 8; off = 84; }
    else if (!IBIT()) { nbits = 12; off = 340; }
    else { nbits = 32; off = 4436; }
    for (i = 0; i < nbits; i++) v = (v << 1) | (uint32_t)IBIT();
#undef IBIT
    v += off;
    if (s && v == 0) return 0; /* OOB */
    *out = (int32_t)(s ? -v : v);
    return 1;
}

/* Annex A.3 symbol-ID decoding; cx sized 1 << (symcodelen + 1). */
int jbig2_iaid_decode(void *h, uint8_t *cx, int symcodelen) {
    MQ *m = (MQ *)h;
    uint32_t prev = 1;
    int i;
    for (i = 0; i < symcodelen; i++)
        prev = (prev << 1) | (uint32_t)mq_decode(m, &cx[prev]);
    return (int)(prev - (1U << symcodelen));
}

/* One generic region on the shared stream with the caller's GB context
 * bank (64 KiB covers every template). */
int jbig2_generic_into(void *h, uint8_t *cx, uint8_t *out, int w, int hh,
                       int gbtemplate, int tpgdon, const signed char *at) {
    return generic_into((MQ *)h, cx, out, w, hh, gbtemplate, tpgdon, at);
}

/* --------------------------------------- refinement decoding (6.3.5)
 *
 * Context: coding-template pixels from the in-progress bitmap, then
 * reference-template pixels from the reference bitmap shifted by
 * (-dx, -dy), MSB-first in the listed order (same convention as
 * pdf.js/jbig2dec). Template 0 appends AT1 to the coding list and AT2
 * to the reference list. TPGRON is handled by the caller (unsupported
 * upstream -> raises before reaching here). cx needs 1 << 13 bytes. */
int jbig2_refine_into(void *h, uint8_t *cx, uint8_t *out, int w, int hh,
                      int grtemplate, const signed char *at,
                      const uint8_t *ref, int rw, int rh,
                      int dx, int dy) {
    static const Pt c0[] = {{0, -1}, {1, -1}, {-1, 0}};
    static const Pt r0[] = {{0, -1}, {1, -1}, {-1, 0}, {0, 0},
                            {1, 0},  {-1, 1}, {0, 1},  {1, 1}};
    static const Pt c1[] = {{-1, -1}, {0, -1}, {1, -1}, {-1, 0}};
    static const Pt r1[] = {{0, -1}, {-1, 0}, {0, 0}, {1, 0},
                            {0, 1},  {1, 1}};
    Pt ct[8], rt[16];
    int nc, nr, x, y, k;
    uint32_t ctx;
    MQ *m = (MQ *)h;
    if (w <= 0 || hh <= 0 || (grtemplate != 0 && grtemplate != 1))
        return -1;
    if (grtemplate == 0) {
        for (nc = 0; nc < 3; nc++) ct[nc] = c0[nc];
        ct[nc].x = at[0]; ct[nc].y = at[1]; nc++;
        for (nr = 0; nr < 8; nr++) rt[nr] = r0[nr];
        rt[nr].x = at[2]; rt[nr].y = at[3]; nr++;
    } else {
        for (nc = 0; nc < 4; nc++) ct[nc] = c1[nc];
        for (nr = 0; nr < 6; nr++) rt[nr] = r1[nr];
    }
    memset(out, 0, (size_t)w * hh);
    for (y = 0; y < hh; y++) {
        for (x = 0; x < w; x++) {
            ctx = 0;
            for (k = 0; k < nc; k++) {
                int px = x + ct[k].x, py = y + ct[k].y;
                uint32_t bit = 0;
                if (px >= 0 && px < w && py >= 0 && py < hh)
                    bit = out[(size_t)py * w + px];
                ctx = (ctx << 1) | bit;
            }
            for (k = 0; k < nr; k++) {
                int px = x + rt[k].x - dx, py = y + rt[k].y - dy;
                uint32_t bit = 0;
                if (px >= 0 && px < rw && py >= 0 && py < rh)
                    bit = ref[(size_t)py * rw + px];
                ctx = (ctx << 1) | bit;
            }
            out[(size_t)y * w + x] = (uint8_t)mq_decode(m, &cx[ctx]);
        }
    }
    return 0;
}
