/* Copy of rag_application_tpu/native/wordpiece.c. */
/* Native WordPiece: the host-side hot loop of checkpoint-parity encoding.
 *
 * Same pipeline as models/wordpiece.py (BERT basic tokenizer + greedy
 * longest-match-first WordPiece, itself parity-tested byte-for-byte
 * against transformers.BertTokenizer): clean -> whitespace split ->
 * punctuation split -> lowercase -> wordpiece -> [CLS] ids [SEP].
 *
 * Scope: this is the **ASCII fast path**. Any text containing a byte
 * >= 0x80 is rejected (wp_encode returns -1; batch marks the row) and
 * the Python implementation handles it — full Unicode (NFD accent
 * stripping, category tables, CJK ranges) stays in Python where the
 * tables live. For typical English corpora this covers ~all rows.
 *
 * Exposed via ctypes (no pybind11 in the image): native/wordpiece.py.
 * Parity: tests/test_wordpiece.py compares against the Python pipeline
 * (and transitively the HF oracle) token for token.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---------------------------------------------------------- hash table */

typedef struct {
    int32_t off;   /* offset into blob */
    int32_t len;   /* token byte length */
    int32_t id;    /* vocab id */
} Slot;

typedef struct {
    char *blob;        /* owned copy of '\n'-joined vocab */
    int64_t blob_len;
    Slot *slots;       /* open addressing, power-of-two size */
    int64_t n_slots;
    int32_t unk_id, pad_id, cls_id, sep_id;
    int lowercase;
} WP;

static uint64_t fnv1a(const char *s, size_t n) {
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < n; i++) {
        h ^= (unsigned char)s[i];
        h *= 1099511628211ull;
    }
    return h;
}

static int32_t wp_lookup(const WP *w, const char *s, size_t n) {
    uint64_t mask = (uint64_t)w->n_slots - 1;
    uint64_t i = fnv1a(s, n) & mask;
    for (;;) {
        const Slot *sl = &w->slots[i];
        if (sl->len < 0) return -1; /* empty */
        if ((size_t)sl->len == n && memcmp(w->blob + sl->off, s, n) == 0)
            return sl->id;
        i = (i + 1) & mask;
    }
}

static void wp_insert(WP *w, int32_t off, int32_t len, int32_t id) {
    uint64_t mask = (uint64_t)w->n_slots - 1;
    uint64_t i = fnv1a(w->blob + off, (size_t)len) & mask;
    while (w->slots[i].len >= 0) {
        Slot *sl = &w->slots[i];
        if ((size_t)sl->len == (size_t)len &&
            memcmp(w->blob + sl->off, w->blob + off, (size_t)len) == 0) {
            sl->id = id; /* last occurrence wins (python dict semantics) */
            return;
        }
        i = (i + 1) & mask;
    }
    w->slots[i].off = off;
    w->slots[i].len = len;
    w->slots[i].id = id;
}

void *wp_new(const char *vocab_blob, int64_t blob_len, int lowercase) {
    WP *w = (WP *)calloc(1, sizeof(WP));
    if (!w) return NULL;
    w->blob = (char *)malloc((size_t)blob_len);
    if (!w->blob) { free(w); return NULL; }
    memcpy(w->blob, vocab_blob, (size_t)blob_len);
    w->blob_len = blob_len;
    w->lowercase = lowercase;

    /* count tokens */
    int64_t n = 0;
    for (int64_t i = 0; i < blob_len; i++)
        if (w->blob[i] == '\n') n++;
    int64_t cap = 16;
    while (cap < 2 * (n + 1)) cap <<= 1;
    w->n_slots = cap;
    w->slots = (Slot *)malloc((size_t)cap * sizeof(Slot));
    if (!w->slots) { free(w->blob); free(w); return NULL; }
    for (int64_t i = 0; i < cap; i++) w->slots[i].len = -1;

    int32_t id = 0, start = 0;
    for (int64_t i = 0; i <= blob_len; i++) {
        if (i == blob_len || w->blob[i] == '\n') {
            if (i > start) wp_insert(w, start, (int32_t)(i - start), id);
            if (i > start || i < blob_len) id++;
            start = (int32_t)(i + 1);
        }
    }
    w->unk_id = wp_lookup(w, "[UNK]", 5);
    w->pad_id = wp_lookup(w, "[PAD]", 5);
    w->cls_id = wp_lookup(w, "[CLS]", 5);
    w->sep_id = wp_lookup(w, "[SEP]", 5);
    if (w->pad_id < 0) w->pad_id = 0;
    if (w->unk_id < 0) w->unk_id = 0;
    return w;
}

void wp_free(void *h) {
    WP *w = (WP *)h;
    if (!w) return;
    free(w->blob);
    free(w->slots);
    free(w);
}

int32_t wp_pad_id(void *h) { return ((WP *)h)->pad_id; }

/* ------------------------------------------------------ classification */

static int is_ascii_punct(unsigned char c) {
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
           (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

#define MAX_WORD 100

/* wordpiece one lowercased word into ids; returns count (>=1) */
static int64_t piece_word(const WP *w, const char *word, size_t len,
                          int32_t *out, int64_t cap, int64_t n) {
    if (len > MAX_WORD) {
        if (n < cap) out[n] = w->unk_id;
        return n + 1;
    }
    char buf[MAX_WORD + 3];
    int64_t first = n;
    size_t start = 0;
    while (start < len) {
        size_t end = len;
        int32_t cur = -1;
        while (start < end) {
            const char *sub;
            size_t sl;
            if (start > 0) {
                buf[0] = '#'; buf[1] = '#';
                memcpy(buf + 2, word + start, end - start);
                sub = buf; sl = end - start + 2;
            } else {
                sub = word + start; sl = end - start;
            }
            cur = wp_lookup(w, sub, sl);
            if (cur >= 0) break;
            end--;
        }
        if (cur < 0) { /* whole word -> single UNK */
            if (first < cap) out[first] = w->unk_id;
            return first + 1;
        }
        if (n < cap) out[n] = cur;
        n++;
        start = end;
    }
    return n;
}

/* Encode one text: [CLS] pieces [SEP], truncated to max_len total.
 * Returns token count written (<= max_len), or -1 for non-ASCII input.
 * out must hold max_len entries. */
int64_t wp_encode(void *h, const char *text, int64_t text_len,
                  int32_t max_len, int32_t *out) {
    WP *w = (WP *)h;
    for (int64_t i = 0; i < text_len; i++)
        if ((unsigned char)text[i] >= 0x80) return -1;

    if (max_len < 2) { /* no room for [CLS] ... [SEP]: write what fits */
        if (max_len >= 1) out[0] = w->cls_id >= 0 ? w->cls_id : w->unk_id;
        return max_len > 0 ? max_len : 0;
    }
    int64_t body_cap = max_len - 2;
    int32_t *body = out + 1; /* write body in place after [CLS] slot */
    int64_t n = 0;

    char word[MAX_WORD + 1];
    size_t wl = 0;
    int overlong = 0;
    for (int64_t i = 0; i <= text_len; i++) {
        unsigned char c = i < text_len ? (unsigned char)text[i] : ' ';
        /* clean: control chars skipped; \t\n\r + space are separators */
        int is_sep = (c == ' ' || c == '\t' || c == '\n' || c == '\r');
        int is_ctl = (c < 32 && !is_sep) || c == 127 || c == 0;
        if (is_ctl) continue;
        int is_punct = is_ascii_punct(c);
        if (is_sep || is_punct) {
            if (wl > 0 || overlong) {
                if (overlong) {
                    n++; /* UNK for the overlong word */
                    if (n - 1 < body_cap) body[n - 1] = w->unk_id;
                } else {
                    n = piece_word(w, word, wl, body, body_cap, n);
                }
                wl = 0; overlong = 0;
            }
            if (is_punct) {
                char p = (char)c;
                int32_t pid = wp_lookup(w, &p, 1);
                if (n < body_cap) body[n] = pid >= 0 ? pid : w->unk_id;
                n++;
            }
            continue;
        }
        /* word char */
        if (w->lowercase && c >= 'A' && c <= 'Z') c = (unsigned char)(c + 32);
        if (wl < MAX_WORD) word[wl++] = (char)c;
        else overlong = 1; /* > MAX_WORD chars -> single UNK */
    }
    if (n > body_cap) n = body_cap;
    out[0] = w->cls_id >= 0 ? w->cls_id : w->unk_id;
    out[n + 1] = w->sep_id >= 0 ? w->sep_id : w->unk_id;
    return n + 2;
}

/* Batch: texts concatenated in buf with offsets[n+1]; out is
 * (n, max_len) int32 pre-filled by caller with pad_id; lens[i] gets the
 * token count or -1 (non-ASCII row, caller re-encodes in Python). */
void wp_encode_batch(void *h, const char *buf, const int64_t *offsets,
                     int64_t n_texts, int32_t max_len,
                     int32_t *out, int64_t *lens) {
    for (int64_t i = 0; i < n_texts; i++) {
        lens[i] = wp_encode(h, buf + offsets[i],
                            offsets[i + 1] - offsets[i], max_len,
                            out + i * max_len);
    }
}
