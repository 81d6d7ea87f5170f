/* Copy of rag_application_tpu/native/jpeg.c. */

/* Baseline-JPEG decoder (ITU T.81 sequential DCT, Huffman entropy).
 *
 * The reference accepts any image format through torchvision/PIL
 * (app/core/models/imagebind/imagebind_handler.py:23-32) and
 * rasterizes PDF pages to JPEG for its VLM
 * (IndexerAPI/src/core/processors/utils.py:16-22). This repo decodes
 * rasters natively (models/image.py does PNG); this file closes the
 * JPEG gap: DCTDecode PDF images, MJPEG-AVI video frames and
 * image_url data URLs all reach the multimodal tower without any
 * external decoder.
 *
 * Scope: baseline (SOF0) + extended sequential (SOF1), 8-bit samples,
 * 1 or 3 components, any sampling factors 1-4 (covers 4:4:4, 4:2:2,
 * 4:2:0, 4:4:0), restart intervals, 8/16-bit quant tables. Progressive
 * (SOF2) and arithmetic coding return ERR_UNSUPPORTED so the Python
 * wrapper can raise JPEGError (callers fall back exactly as for other
 * unsupported codecs).
 *
 * Driven via ctypes from models/jpeg.py (same pattern as jbig2.c).
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ERR_FORMAT -1      /* malformed / not a JPEG */
#define ERR_UNSUPPORTED -2 /* progressive, arithmetic, 12-bit, CMYK */
#define ERR_TRUNCATED -3
#define ERR_ARGS -4        /* caller buffer does not match the SOF dims */

/* ------------------------------------------------------------ tables */

static void make_zigzag(int *zz) {
    int x = 0, y = 0, i;
    for (i = 0; i < 64; i++) {
        zz[i] = y * 8 + x;
        if (((x + y) & 1) == 0) {          /* moving up-right */
            if (x == 7) y++;
            else if (y == 0) x++;
            else { x++; y--; }
        } else {                            /* moving down-left */
            if (y == 7) x++;
            else if (x == 0) y++;
            else { x--; y++; }
        }
    }
}

/* ----------------------------------------------------------- huffman */

typedef struct {
    int mincode[17];
    int maxcode[18];   /* -1 where no codes of that length */
    int valptr[17];
    unsigned char vals[256];
    int defined;
} Huff;

static int huff_build(Huff *h, const unsigned char *counts,
                      const unsigned char *vals, int nvals) {
    int code = 0, k = 0, l;
    if (nvals > 256) return ERR_FORMAT;
    memcpy(h->vals, vals, (size_t)nvals);
    for (l = 1; l <= 16; l++) {
        if (counts[l - 1] == 0) {
            h->maxcode[l] = -1;
        } else {
            h->valptr[l] = k;
            h->mincode[l] = code;
            code += counts[l - 1];
            k += counts[l - 1];
            h->maxcode[l] = code - 1;
            if (code > (1 << l)) return ERR_FORMAT; /* over-full code */
        }
        code <<= 1;
    }
    if (k != nvals) return ERR_FORMAT;
    h->defined = 1;
    return 0;
}

/* --------------------------------------------------------- bitreader */

typedef struct {
    const unsigned char *p, *end;
    uint32_t buf;
    int cnt;
    int marker;   /* 0 = none; 0xFFxx once a marker byte is seen */
} BR;

static void br_init(BR *br, const unsigned char *p,
                    const unsigned char *end) {
    br->p = p; br->end = end; br->buf = 0; br->cnt = 0; br->marker = 0;
}

/* Pull one byte of entropy data, honouring 0xFF00 stuffing. Once a
 * real marker is reached the reader feeds zero bits (spec F.2.2.5 —
 * the tail of the last MCU may legitimately read past the data). */
static int br_byte(BR *br) {
    int b, b2;
    if (br->marker) return 0;
    if (br->p >= br->end) { br->marker = 0xFFD9; return 0; }
    b = *br->p++;
    if (b != 0xFF) return b;
    b2 = (br->p < br->end) ? *br->p : 0xD9;
    if (b2 == 0x00) { br->p++; return 0xFF; }
    br->p--;                     /* leave the marker in the stream */
    br->marker = 0xFF00 | b2;
    return 0;
}

static int br_bit(BR *br) {
    if (br->cnt == 0) { br->buf = (uint32_t)br_byte(br); br->cnt = 8; }
    br->cnt--;
    return (int)((br->buf >> br->cnt) & 1u);
}

static int br_bits(BR *br, int n) {
    int v = 0;
    while (n--) v = (v << 1) | br_bit(br);
    return v;
}

static int huff_decode(BR *br, const Huff *h) {
    int code = br_bit(br), l = 1;
    if (!h->defined) return -1;
    while (code > h->maxcode[l]) {
        code = (code << 1) | br_bit(br);
        if (++l > 16) return -1;
    }
    return h->vals[h->valptr[l] + code - h->mincode[l]];
}

/* F.2.2.1 EXTEND: map an s-bit magnitude to its signed value. */
static int receive_extend(BR *br, int s) {
    int v;
    if (s == 0) return 0;
    v = br_bits(br, s);
    if (v < (1 << (s - 1))) v += ((-1) << s) + 1;
    return v;
}

/* Byte-align and consume the next marker (for restart intervals). */
static int br_marker(BR *br) {
    int m;
    br->cnt = 0;
    if (br->marker) { m = br->marker; br->marker = 0; br->p += 2; return m; }
    while (br->p + 1 < br->end && br->p[0] != 0xFF) br->p++; /* resync */
    while (br->p + 1 < br->end && br->p[1] == 0xFF) br->p++; /* fill */
    if (br->p + 1 >= br->end) return ERR_TRUNCATED;
    m = 0xFF00 | br->p[1];
    br->p += 2;
    return m;
}

/* -------------------------------------------------------------- idct */

/* Separable float IDCT: sample[x] = sum_u C(u)/2 * F[u] * cos((2x+1)u pi/16).
 * Basis matrix precomputed once. Accuracy comfortably exceeds the
 * T.83 conformance bound; output biased +128 and clamped by caller. */
static float g_idct_m[8][8]; /* [x][u] */
static int g_idct_init = 0;

static void idct_init(void) {
    int x, u;
    if (g_idct_init) return;
    for (x = 0; x < 8; x++)
        for (u = 0; u < 8; u++) {
            double cu = (u == 0) ? (1.0 / sqrt(2.0)) : 1.0;
            g_idct_m[x][u] = (float)(0.5 * cu *
                cos((2.0 * x + 1.0) * u * M_PI / 16.0));
        }
    g_idct_init = 1;
}

static void idct8x8(const float in[64], float out[64]) {
    float tmp[64];
    int x, y, u;
    /* rows: for each coefficient row v (index y), transform along u */
    for (y = 0; y < 8; y++)
        for (x = 0; x < 8; x++) {
            float s = 0.0f;
            for (u = 0; u < 8; u++) s += g_idct_m[x][u] * in[y * 8 + u];
            tmp[y * 8 + x] = s;
        }
    /* columns */
    for (x = 0; x < 8; x++)
        for (y = 0; y < 8; y++) {
            float s = 0.0f;
            for (u = 0; u < 8; u++) s += g_idct_m[y][u] * tmp[u * 8 + x];
            out[y * 8 + x] = s;
        }
}

/* ----------------------------------------------------------- decoder */

typedef struct {
    int id, hs, vs, tq;
    int td, ta;
    int dc_pred;
    int pw, ph;             /* allocated plane dims (multiples of 8) */
    unsigned char *plane;
} Comp;

typedef struct {
    int w, h, ncomp, hmax, vmax, restart;
    int sof_seen, progressive;
    uint16_t qt[4][64];     /* natural order */
    int qt_def[4];
    Huff hdc[4], hac[4];
    Comp comp[4];
} JState;

static int u16(const unsigned char *p) { return (p[0] << 8) | p[1]; }

static int decode_block(BR *br, Comp *c, JState *st, float *coef) {
    static int zz[64];
    static int zz_init = 0;
    const uint16_t *qt = st->qt[c->tq];
    int t, diff, k, rs, r, s;
    if (!zz_init) { make_zigzag(zz); zz_init = 1; }
    memset(coef, 0, 64 * sizeof(float));
    t = huff_decode(br, &st->hdc[c->td]);
    if (t < 0 || t > 15) return ERR_FORMAT;
    diff = receive_extend(br, t);
    c->dc_pred += diff;
    coef[0] = (float)(c->dc_pred * (int)qt[0]);
    k = 1;
    while (k < 64) {
        rs = huff_decode(br, &st->hac[c->ta]);
        if (rs < 0) return ERR_FORMAT;
        r = rs >> 4; s = rs & 15;
        if (s == 0) {
            if (r == 15) { k += 16; continue; }   /* ZRL */
            break;                                 /* EOB */
        }
        k += r;
        if (k > 63) return ERR_FORMAT;
        coef[zz[k]] = (float)(receive_extend(br, s) * (int)qt[zz[k]]);
        k++;
    }
    return 0;
}

static int parse_dht(JState *st, const unsigned char *p, int len) {
    int pos = 0;
    while (pos + 17 <= len) {
        int tc = p[pos] >> 4, th = p[pos] & 15, n = 0, i, rc;
        if (tc > 1 || th > 3) return ERR_FORMAT;
        for (i = 0; i < 16; i++) n += p[pos + 1 + i];
        if (pos + 17 + n > len) return ERR_FORMAT;
        rc = huff_build(tc ? &st->hac[th] : &st->hdc[th],
                        p + pos + 1, p + pos + 17, n);
        if (rc) return rc;
        pos += 17 + n;
    }
    return pos == len ? 0 : ERR_FORMAT;
}

static int parse_dqt(JState *st, const unsigned char *p, int len) {
    static int zz[64];
    static int zz_init = 0;
    int pos = 0, i;
    if (!zz_init) { make_zigzag(zz); zz_init = 1; }
    while (pos < len) {
        int pq = p[pos] >> 4, tq = p[pos] & 15;
        pos++;
        if (tq > 3 || pq > 1) return ERR_FORMAT;
        if (pos + (pq ? 128 : 64) > len) return ERR_FORMAT;
        for (i = 0; i < 64; i++) {
            int v = pq ? u16(p + pos + 2 * i) : p[pos + i];
            st->qt[tq][zz[i]] = (uint16_t)v;
        }
        st->qt_def[tq] = 1;
        pos += pq ? 128 : 64;
    }
    return 0;
}

static int parse_sof(JState *st, const unsigned char *p, int len,
                     int progressive) {
    int i;
    if (len < 6) return ERR_FORMAT;
    if (p[0] != 8) return ERR_UNSUPPORTED;        /* 12-bit */
    st->h = u16(p + 1); st->w = u16(p + 3); st->ncomp = p[5];
    st->progressive = progressive;
    if (st->w <= 0 || st->h <= 0) return ERR_FORMAT;
    if (st->ncomp != 1 && st->ncomp != 3) return ERR_UNSUPPORTED;
    if (len < 6 + 3 * st->ncomp) return ERR_FORMAT;
    st->hmax = st->vmax = 1;
    for (i = 0; i < st->ncomp; i++) {
        Comp *c = &st->comp[i];
        c->id = p[6 + 3 * i];
        c->hs = p[7 + 3 * i] >> 4;
        c->vs = p[7 + 3 * i] & 15;
        c->tq = p[8 + 3 * i];
        if (c->hs < 1 || c->hs > 4 || c->vs < 1 || c->vs > 4 || c->tq > 3)
            return ERR_FORMAT;
        if (c->hs > st->hmax) st->hmax = c->hs;
        if (c->vs > st->vmax) st->vmax = c->vs;
    }
    st->sof_seen = 1;
    return 0;
}

/* Walk the marker stream. Returns offset of entropy data (just past
 * SOS header) or a negative error. */
static long parse_headers(JState *st, const unsigned char *d, long n,
                          long start, int *scan_comp_ids) {
    long pos = start;
    while (pos + 4 <= n) {
        int m, len;
        if (d[pos] != 0xFF) return ERR_FORMAT;
        m = d[pos + 1];
        pos += 2;
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) continue; /* SOI/RST */
        if (m == 0xD9) return ERR_TRUNCATED;                 /* EOI early */
        if (m == 0xFF) { pos--; continue; }                  /* fill byte */
        if (pos + 2 > n) return ERR_TRUNCATED;
        len = u16(d + pos);
        if (len < 2 || pos + len > n) return ERR_TRUNCATED;
        switch (m) {
        case 0xC0: case 0xC1: {                 /* SOF0/1 */
            int rc = parse_sof(st, d + pos + 2, len - 2, 0);
            if (rc) return rc;
            break;
        }
        case 0xC2:                               /* progressive */
            return ERR_UNSUPPORTED;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
            return ERR_UNSUPPORTED;  /* lossless / arithmetic / hier. */
        case 0xC4: {                             /* DHT */
            int rc = parse_dht(st, d + pos + 2, len - 2);
            if (rc) return rc;
            break;
        }
        case 0xDB: {                             /* DQT */
            int rc = parse_dqt(st, d + pos + 2, len - 2);
            if (rc) return rc;
            break;
        }
        case 0xDD:                               /* DRI */
            if (len < 4) return ERR_FORMAT;
            st->restart = u16(d + pos + 2);
            break;
        case 0xDA: {                             /* SOS */
            int ns, i;
            const unsigned char *p = d + pos + 2;
            if (!st->sof_seen) return ERR_FORMAT;
            ns = p[0];
            if (ns < 1 || ns > 4 || len < 2 + 1 + 2 * ns + 3)
                return ERR_FORMAT;
            if (ns != st->ncomp) return ERR_UNSUPPORTED; /* multi-scan */
            for (i = 0; i < ns; i++) {
                int cid = p[1 + 2 * i], j, found = 0;
                for (j = 0; j < st->ncomp; j++)
                    if (st->comp[j].id == cid) {
                        st->comp[j].td = p[2 + 2 * i] >> 4;
                        st->comp[j].ta = p[2 + 2 * i] & 15;
                        if (st->comp[j].td > 3 || st->comp[j].ta > 3)
                            return ERR_FORMAT;
                        scan_comp_ids[i] = j;
                        found = 1;
                        break;
                    }
                if (!found) return ERR_FORMAT;
            }
            return pos + len;                    /* entropy data starts */
        }
        default:                                  /* APPn, COM, ... */
            break;
        }
        pos += len;
    }
    return ERR_TRUNCATED;
}

int jpeg_probe(const unsigned char *d, long n, int *w, int *h,
               int *ncomp) {
    JState st;
    int ids[4];
    long rc;
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return ERR_FORMAT;
    memset(&st, 0, sizeof(st));
    rc = parse_headers(&st, d, n, 0, ids);
    if (rc < 0 && !(rc == ERR_UNSUPPORTED && st.sof_seen) &&
        !(rc == ERR_TRUNCATED && st.sof_seen))
        return (int)rc;
    if (!st.sof_seen) return ERR_FORMAT;
    *w = st.w; *h = st.h; *ncomp = st.ncomp;
    return 0;
}

int jpeg_decode(const unsigned char *d, long n, unsigned char *out,
                int out_w, int out_h) {
    JState st;
    int ids[4];
    long data_off;
    int i, rc = 0, mcux, mcuy, mx, my, mcu_count = 0;
    BR br;
    float coef[64], px[64];

    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return ERR_FORMAT;
    idct_init();
    memset(&st, 0, sizeof(st));
    data_off = parse_headers(&st, d, n, 0, ids);
    if (data_off < 0) return (int)data_off;
    if (st.w != out_w || st.h != out_h) return ERR_ARGS;
    for (i = 0; i < st.ncomp; i++) {
        if (!st.qt_def[st.comp[i].tq]) return ERR_FORMAT;
        if (!st.hdc[st.comp[i].td].defined ||
            !st.hac[st.comp[i].ta].defined) return ERR_FORMAT;
    }

    mcux = (st.w + 8 * st.hmax - 1) / (8 * st.hmax);
    mcuy = (st.h + 8 * st.vmax - 1) / (8 * st.vmax);
    for (i = 0; i < st.ncomp; i++) {
        Comp *c = &st.comp[i];
        c->pw = mcux * c->hs * 8;
        c->ph = mcuy * c->vs * 8;
        c->plane = (unsigned char *)malloc((size_t)c->pw * c->ph);
        if (!c->plane) { rc = ERR_FORMAT; goto done; }
        c->dc_pred = 0;
    }

    br_init(&br, d + data_off, d + n);
    for (my = 0; my < mcuy && rc == 0; my++) {
        for (mx = 0; mx < mcux && rc == 0; mx++) {
            if (st.restart && mcu_count && mcu_count % st.restart == 0) {
                int m = br_marker(&br);
                if (m < 0xFFD0 || m > 0xFFD7) { rc = ERR_TRUNCATED; break; }
                for (i = 0; i < st.ncomp; i++) st.comp[i].dc_pred = 0;
            }
            for (i = 0; i < st.ncomp; i++) {
                Comp *c = &st.comp[i];
                int bv, bh2;
                for (bv = 0; bv < c->vs; bv++)
                    for (bh2 = 0; bh2 < c->hs; bh2++) {
                        int ox = (mx * c->hs + bh2) * 8;
                        int oy = (my * c->vs + bv) * 8;
                        int x, y;
                        rc = decode_block(&br, c, &st, coef);
                        if (rc) goto done;
                        idct8x8(coef, px);
                        for (y = 0; y < 8; y++)
                            for (x = 0; x < 8; x++) {
                                float v = px[y * 8 + x] + 128.0f;
                                int s = (int)(v + (v >= 0 ? 0.5f : -0.5f));
                                if (s < 0) s = 0;
                                if (s > 255) s = 255;
                                c->plane[(size_t)(oy + y) * c->pw +
                                         ox + x] = (unsigned char)s;
                            }
                    }
            }
            mcu_count++;
        }
    }

    /* upsample + colour convert */
    if (rc == 0) {
        int x, y;
        if (st.ncomp == 1) {
            Comp *c = &st.comp[0];
            for (y = 0; y < st.h; y++)
                for (x = 0; x < st.w; x++) {
                    unsigned char v = c->plane[(size_t)y * c->pw + x];
                    unsigned char *o = out + ((size_t)y * st.w + x) * 3;
                    o[0] = o[1] = o[2] = v;
                }
        } else {
            Comp *cy = &st.comp[0], *cb = &st.comp[1], *cr = &st.comp[2];
            for (y = 0; y < st.h; y++) {
                size_t yY = (size_t)y * cy->pw;
                size_t yB = (size_t)(y * cb->vs / st.vmax) * cb->pw;
                size_t yR = (size_t)(y * cr->vs / st.vmax) * cr->pw;
                for (x = 0; x < st.w; x++) {
                    float Y = cy->plane[yY + x * cy->hs / st.hmax];
                    float B = cb->plane[yB + x * cb->hs / st.hmax] - 128.0f;
                    float R = cr->plane[yR + x * cr->hs / st.hmax] - 128.0f;
                    float r = Y + 1.402f * R;
                    float g = Y - 0.344136f * B - 0.714136f * R;
                    float b = Y + 1.772f * B;
                    unsigned char *o = out + ((size_t)y * st.w + x) * 3;
                    o[0] = r < 0 ? 0 : r > 255 ? 255 : (unsigned char)(r + 0.5f);
                    o[1] = g < 0 ? 0 : g > 255 ? 255 : (unsigned char)(g + 0.5f);
                    o[2] = b < 0 ? 0 : b > 255 ? 255 : (unsigned char)(b + 0.5f);
                }
            }
        }
    }

done:
    for (i = 0; i < st.ncomp; i++) free(st.comp[i].plane);
    return rc;
}
