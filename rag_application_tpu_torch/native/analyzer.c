/* Copy of rag_application_tpu/native/analyzer.c. */
/* Native text analyzer: tokenize -> stopwords -> stem -> term ids.
 *
 * The host-side hot loop of sparse ingest. The Python Analyzer
 * (index/analyzer.py) costs ~80 us/doc (regex + dict); at millions of
 * documents that is minutes of single-core time per rebuild. This C
 * implementation does the same pipeline (ASCII-alnum tokenization,
 * English stopword removal, light suffix stemming, insertion-ordered
 * vocabulary ids) in one pass over the bytes, ~20x faster.
 *
 * Exposed via ctypes (no pybind11 in the image): see native/__init__.py.
 * Semantics must match index/analyzer.py exactly — the parity tests in
 * tests/test_native.py compare both token streams term for term.
 */

#include <ctype.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------- stopwords */

static const char *STOPWORDS[] = {
    "a",  "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
    "in", "into", "is", "it", "no", "not", "of", "on", "or", "such",
    "that", "the", "their", "then", "there", "these", "they", "this",
    "to", "was", "will", "with",
};
#define N_STOPWORDS (sizeof(STOPWORDS) / sizeof(STOPWORDS[0]))

static int is_stopword(const char *tok, size_t len) {
    for (size_t i = 0; i < N_STOPWORDS; i++) {
        if (strlen(STOPWORDS[i]) == len && memcmp(STOPWORDS[i], tok, len) == 0)
            return 1;
    }
    return 0;
}

/* ---------------------------------------------------------------- stemmer */

typedef struct { const char *suf; size_t len; int add_i; } Suffix;
/* order matches index/analyzer.py _SUFFIXES */
static const Suffix SUFFIXES[] = {
    {"ational", 7, 0}, {"iveness", 7, 0}, {"fulness", 7, 0},
    {"ousness", 7, 0}, {"ization", 7, 0}, {"ations", 6, 0},
    {"ingly", 5, 0},   {"ements", 6, 0},  {"ments", 5, 0},
    {"ation", 5, 0},   {"ness", 4, 0},    {"ing", 3, 0},
    {"ies", 3, 1},     {"ied", 3, 1},     {"ed", 2, 0},
    {"es", 2, 0},      {"s", 1, 0},
};
#define N_SUFFIXES (sizeof(SUFFIXES) / sizeof(SUFFIXES[0]))

/* stems tok in place; returns new length */
static size_t light_stem(char *tok, size_t len) {
    if (len <= 3) return len;
    for (size_t i = 0; i < N_SUFFIXES; i++) {
        const Suffix *s = &SUFFIXES[i];
        if (len > s->len && len - s->len >= 3 &&
            memcmp(tok + len - s->len, s->suf, s->len) == 0) {
            len -= s->len;
            if (s->add_i) tok[len++] = 'i';
            tok[len] = '\0';
            return len;
        }
    }
    return len;
}

/* ------------------------------------------------------------------ vocab */

typedef struct {
    char **keys;       /* owned term strings, indexed by id */
    int32_t *table;    /* open-addressing: slot -> id or -1 */
    uint64_t *hashes;  /* slot -> hash (for fast compare) */
    size_t cap;        /* table capacity (power of two) */
    size_t size;       /* number of terms */
    size_t keys_cap;
} Vocab;

static uint64_t fnv1a(const char *s, size_t len) {
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < len; i++) {
        h ^= (unsigned char)s[i];
        h *= 1099511628211ULL;
    }
    return h;
}

static void vocab_rehash(Vocab *v, size_t new_cap) {
    int32_t *table = malloc(new_cap * sizeof(int32_t));
    uint64_t *hashes = malloc(new_cap * sizeof(uint64_t));
    for (size_t i = 0; i < new_cap; i++) table[i] = -1;
    for (size_t id = 0; id < v->size; id++) {
        uint64_t h = fnv1a(v->keys[id], strlen(v->keys[id]));
        size_t slot = h & (new_cap - 1);
        while (table[slot] != -1) slot = (slot + 1) & (new_cap - 1);
        table[slot] = (int32_t)id;
        hashes[slot] = h;
    }
    free(v->table);
    free(v->hashes);
    v->table = table;
    v->hashes = hashes;
    v->cap = new_cap;
}

typedef struct {
    Vocab vocab;
    int stem;
    int stopwords;
} Analyzer;

void *analyzer_new(int stem, int stopwords) {
    Analyzer *a = calloc(1, sizeof(Analyzer));
    a->stem = stem;
    a->stopwords = stopwords;
    a->vocab.cap = 1 << 16;
    a->vocab.table = malloc(a->vocab.cap * sizeof(int32_t));
    a->vocab.hashes = malloc(a->vocab.cap * sizeof(uint64_t));
    for (size_t i = 0; i < a->vocab.cap; i++) a->vocab.table[i] = -1;
    a->vocab.keys_cap = 1 << 12;
    a->vocab.keys = malloc(a->vocab.keys_cap * sizeof(char *));
    return a;
}

void analyzer_free(void *handle) {
    Analyzer *a = handle;
    for (size_t i = 0; i < a->vocab.size; i++) free(a->vocab.keys[i]);
    free(a->vocab.keys);
    free(a->vocab.table);
    free(a->vocab.hashes);
    free(a);
}

int64_t analyzer_vocab_size(void *handle) {
    return (int64_t)((Analyzer *)handle)->vocab.size;
}

/* returns id, or -1 when grow=0 and unseen */
static int32_t vocab_lookup(Analyzer *a, const char *tok, size_t len, int grow) {
    Vocab *v = &a->vocab;
    uint64_t h = fnv1a(tok, len);
    size_t slot = h & (v->cap - 1);
    while (v->table[slot] != -1) {
        if (v->hashes[slot] == h) {
            const char *key = v->keys[v->table[slot]];
            if (strlen(key) == len && memcmp(key, tok, len) == 0)
                return v->table[slot];
        }
        slot = (slot + 1) & (v->cap - 1);
    }
    if (!grow) return -1;
    if (v->size * 2 >= v->cap) {
        vocab_rehash(v, v->cap * 2);
        slot = h & (v->cap - 1);
        while (v->table[slot] != -1) slot = (slot + 1) & (v->cap - 1);
    }
    if (v->size == v->keys_cap) {
        v->keys_cap *= 2;
        v->keys = realloc(v->keys, v->keys_cap * sizeof(char *));
    }
    char *copy = malloc(len + 1);
    memcpy(copy, tok, len);
    copy[len] = '\0';
    v->keys[v->size] = copy;
    v->table[slot] = (int32_t)v->size;
    v->hashes[slot] = h;
    return (int32_t)v->size++;
}

/* term of the id (borrowed pointer, NUL-terminated) */
const char *analyzer_term(void *handle, int32_t id) {
    Analyzer *a = handle;
    if (id < 0 || (size_t)id >= a->vocab.size) return "";
    return a->vocab.keys[id];
}

/* pre-register a term (vocab import); returns its id */
int32_t analyzer_intern(void *handle, const char *term) {
    return vocab_lookup((Analyzer *)handle, term, strlen(term), 1);
}

#define MAX_TOKEN 64

/* Encode one text into out_ids (caller-allocated, out_cap slots).
 * Returns number of ids written (truncates at out_cap). */
int64_t analyzer_encode(void *handle, const char *text, int64_t text_len,
                        int grow, int32_t *out_ids, int64_t out_cap) {
    Analyzer *a = handle;
    int64_t n_out = 0;
    char tok[MAX_TOKEN + 8];
    size_t tok_len = 0;
    for (int64_t i = 0; i <= text_len; i++) {
        unsigned char c = (i < text_len) ? (unsigned char)text[i] : 0;
        if (c >= 'A' && c <= 'Z') c = (unsigned char)(c - 'A' + 'a');
        if ((c >= 'a' && c <= 'z') || (c >= '0' && c <= '9')) {
            if (tok_len < MAX_TOKEN) tok[tok_len++] = (char)c;
            continue;
        }
        if (tok_len) {
            tok[tok_len] = '\0';
            size_t len = tok_len;
            tok_len = 0;
            if (a->stopwords && is_stopword(tok, len)) continue;
            if (a->stem) len = light_stem(tok, len);
            int32_t id = vocab_lookup(a, tok, len, grow);
            if (id >= 0 && n_out < out_cap) out_ids[n_out++] = id;
            if (n_out == out_cap) return n_out;
        }
    }
    return n_out;
}

/* Batch encode into a flat buffer with row offsets.
 * texts: concatenated bytes; offsets: n+1 entries delimiting each text.
 * out_ids: flat output; out_offsets: n+1 entries. Returns total ids. */
int64_t analyzer_encode_batch(void *handle, const char *texts,
                              const int64_t *offsets, int64_t n, int grow,
                              int32_t *out_ids, int64_t out_cap,
                              int64_t *out_offsets) {
    int64_t total = 0;
    out_offsets[0] = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t wrote = analyzer_encode(
            handle, texts + offsets[i], offsets[i + 1] - offsets[i], grow,
            out_ids + total, out_cap - total);
        total += wrote;
        out_offsets[i + 1] = total;
    }
    return total;
}
