/* Copy of rag_application_tpu/native/analyzer.c, with one added entry,
 * analyzer_encode_queries (a batch of queries straight to fixed-width term
 * rows), and the helpers it shares with analyzer_encode: the tokenizer as
 * one function, the stopwords' lengths stored, and each vocabulary slot
 * holding its key's length and a short key itself. The token streams are
 * the same. */
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
 * tests/test_native.py and tests/test_torch_sparse_encode.py compare both
 * token streams term for term.
 */

#include <ctype.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------- stopwords */

typedef struct { const char *word; size_t len; } Stopword;
#define SW(w) {w, sizeof(w) - 1}
static const Stopword STOPWORDS[] = {
    SW("a"),     SW("an"),    SW("and"),   SW("are"),  SW("as"),
    SW("at"),    SW("be"),    SW("but"),   SW("by"),   SW("for"),
    SW("if"),    SW("in"),    SW("into"),  SW("is"),   SW("it"),
    SW("no"),    SW("not"),   SW("of"),    SW("on"),   SW("or"),
    SW("such"),  SW("that"),  SW("the"),   SW("their"), SW("then"),
    SW("there"), SW("these"), SW("they"),  SW("this"), SW("to"),
    SW("was"),   SW("will"),  SW("with"),
};
#undef SW
#define N_STOPWORDS (sizeof(STOPWORDS) / sizeof(STOPWORDS[0]))
#define MAX_STOPWORD 5

/* the letters stopwords start with, as bits of 'a'..'z' */
#define BIT(c) (1u << ((c) - 'a'))
#define STOPWORD_FIRST \
    (BIT('a') | BIT('b') | BIT('f') | BIT('i') | BIT('n') | BIT('o') | \
     BIT('s') | BIT('t') | BIT('w'))

/* length and first letter before the bytes: most tokens fail those */
static int is_stopword(const char *tok, size_t len) {
    unsigned char c = (unsigned char)tok[0];
    if (len > MAX_STOPWORD || c < 'a' || c > 'z' || !(STOPWORD_FIRST & BIT(c)))
        return 0;
    for (size_t i = 0; i < N_STOPWORDS; i++) {
        if (STOPWORDS[i].len == len && STOPWORDS[i].word[0] == tok[0] &&
            memcmp(STOPWORDS[i].word, tok, len) == 0)
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
        /* the last byte first: it rules out most suffixes without a call */
        if (len > s->len && len - s->len >= 3 &&
            tok[len - 1] == s->suf[s->len - 1] &&
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

/* A table slot holds what a probe compares: the hash, the length and, up to
 * INLINE_KEY bytes, the key itself, so a lookup of a short term touches one
 * cache line of the table and no string elsewhere. */
#define INLINE_KEY 16

typedef struct {
    uint64_t hash;     /* the key's hash */
    int32_t id;        /* term id, or -1 for an empty slot */
    uint32_t len;      /* the key's length */
    char key[INLINE_KEY]; /* the key when len <= INLINE_KEY, else keys[id] */
} Slot;

typedef struct {
    char **keys;       /* owned term strings, indexed by id */
    Slot *table;       /* open addressing */
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

static Slot *slots_new(size_t cap) {
    Slot *table = malloc(cap * sizeof(Slot));
    for (size_t i = 0; i < cap; i++) table[i].id = -1;
    return table;
}

static void vocab_rehash(Vocab *v, size_t new_cap) {
    Slot *table = slots_new(new_cap);
    for (size_t i = 0; i < v->cap; i++) {
        if (v->table[i].id == -1) continue;
        size_t slot = v->table[i].hash & (new_cap - 1);
        while (table[slot].id != -1) slot = (slot + 1) & (new_cap - 1);
        table[slot] = v->table[i];
    }
    free(v->table);
    v->table = table;
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
    a->vocab.table = slots_new(a->vocab.cap);
    a->vocab.keys_cap = 1 << 12;
    a->vocab.keys = malloc(a->vocab.keys_cap * sizeof(char *));
    return a;
}

void analyzer_free(void *handle) {
    Analyzer *a = handle;
    for (size_t i = 0; i < a->vocab.size; i++) free(a->vocab.keys[i]);
    free(a->vocab.keys);
    free(a->vocab.table);
    free(a);
}

int64_t analyzer_vocab_size(void *handle) {
    return (int64_t)((Analyzer *)handle)->vocab.size;
}

/* the slot of tok (hash h): where it is, or the empty slot where it would go */
static size_t vocab_probe(const Vocab *v, const char *tok, size_t len,
                          uint64_t h) {
    size_t slot = h & (v->cap - 1);
    for (;; slot = (slot + 1) & (v->cap - 1)) {
        const Slot *s = &v->table[slot];
        if (s->id == -1) return slot;
        if (s->hash == h && s->len == len &&
            memcmp(len <= INLINE_KEY ? s->key : v->keys[s->id], tok, len) == 0)
            return slot;
    }
}

/* returns id, or -1 when grow=0 and unseen; grow=0 only reads */
static int32_t vocab_lookup(Analyzer *a, const char *tok, size_t len, int grow) {
    Vocab *v = &a->vocab;
    uint64_t h = fnv1a(tok, len);
    size_t slot = vocab_probe(v, tok, len, h);
    if (v->table[slot].id != -1) return v->table[slot].id;
    if (!grow) return -1;
    if (v->size * 2 >= v->cap) {
        vocab_rehash(v, v->cap * 2);
        slot = vocab_probe(v, tok, len, h);
    }
    if (v->size == v->keys_cap) {
        v->keys_cap *= 2;
        v->keys = realloc(v->keys, v->keys_cap * sizeof(char *));
    }
    char *copy = malloc(len + 1);
    memcpy(copy, tok, len);
    copy[len] = '\0';
    v->keys[v->size] = copy;
    Slot *s = &v->table[slot];
    s->hash = h;
    s->id = (int32_t)v->size;
    s->len = (uint32_t)len;
    if (len <= INLINE_KEY) memcpy(s->key, tok, len);
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

/* The next analyzed term of text[*pos:text_len] into tok (NUL-terminated,
 * MAX_TOKEN + 8 bytes): an ASCII-alnum run, lowercased and cut to
 * MAX_TOKEN bytes, then stopword removal and stemming. Returns its length,
 * or 0 at the end of the text; *pos moves past the run. */
static size_t next_term(const Analyzer *a, const char *text, int64_t text_len,
                        int64_t *pos, char *tok) {
    int64_t i = *pos;
    for (;;) {
        size_t len = 0;
        for (; i < text_len; i++) {
            unsigned char c = (unsigned char)text[i];
            unsigned char lower = c | 0x20; /* folds exactly 'A'..'Z' */
            int alpha = (unsigned char)(lower - 'a') < 26;
            if (alpha || (unsigned char)(c - '0') < 10) {
                if (len < MAX_TOKEN) tok[len++] = (char)(alpha ? lower : c);
            } else if (len) {
                break;
            }
        }
        if (!len) {
            *pos = i;
            return 0;
        }
        tok[len] = '\0';
        if (a->stopwords && is_stopword(tok, len)) continue;
        if (a->stem) len = light_stem(tok, len);
        *pos = i;
        return len;
    }
}

/* Encode one text into out_ids (caller-allocated, out_cap slots).
 * Returns number of ids written (truncates at out_cap). */
int64_t analyzer_encode(void *handle, const char *text, int64_t text_len,
                        int grow, int32_t *out_ids, int64_t out_cap) {
    Analyzer *a = handle;
    int64_t n_out = 0, pos = 0;
    char tok[MAX_TOKEN + 8];
    size_t len;
    while (n_out < out_cap && (len = next_term(a, text, text_len, &pos, tok))) {
        int32_t id = vocab_lookup(a, tok, len, grow);
        if (id >= 0) out_ids[n_out++] = id;
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

/* Terms a query pass reads ahead: their slots are prefetched together, so
 * the table's cache misses overlap instead of following one another. */
#define LOOKAHEAD 16

/* Encode a batch of queries straight into (n, T) term rows, row-major:
 * each query's known terms (the vocabulary is only read, so callers may
 * run at once), each term once in first-occurrence order, at most T. A
 * query's kept terms go to rows and terms with valid 1; the rest of its
 * row gets pad_row, -2 and 0. texts and offsets as in encode_batch. */
void analyzer_encode_queries(void *handle, const char *texts,
                             const int64_t *offsets, int64_t n, int64_t T,
                             int32_t pad_row, int32_t *rows, int32_t *terms,
                             uint8_t *valid) {
    const Analyzer *a = handle;
    const Vocab *v = &a->vocab;
    char tok[LOOKAHEAD][MAX_TOKEN + 8];
    size_t len[LOOKAHEAD];
    uint64_t h[LOOKAHEAD];
    for (int64_t q = 0; q < n; q++) {
        const char *text = texts + offsets[q];
        int64_t text_len = offsets[q + 1] - offsets[q], pos = 0, m = 0, got;
        int32_t *row = rows + q * T, *term = terms + q * T;
        do {
            for (got = 0; got < LOOKAHEAD; got++) {
                len[got] = next_term(a, text, text_len, &pos, tok[got]);
                if (!len[got]) break;
                h[got] = fnv1a(tok[got], len[got]);
                __builtin_prefetch(&v->table[h[got] & (v->cap - 1)]);
            }
            for (int64_t b = 0; b < got && m < T; b++) {
                int32_t id = v->table[vocab_probe(v, tok[b], len[b], h[b])].id;
                if (id < 0) continue;
                int64_t j = 0;
                while (j < m && term[j] != id) j++;
                if (j == m) term[m++] = id;
            }
        } while (got == LOOKAHEAD && m < T);
        for (int64_t j = 0; j < T; j++) {
            if (j >= m) term[j] = -2;
            row[j] = j < m ? term[j] : pad_row;
            valid[q * T + j] = j < m;
        }
    }
}
