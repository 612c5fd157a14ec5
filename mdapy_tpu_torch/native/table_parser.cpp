// Fast columnar parser for whitespace-separated table bodies (LAMMPS dump
// "ITEM: ATOMS" bodies, XYZ bodies).
//
// A copy of mdapy_tpu/native/table_parser.cpp (whole; parse_double skips
// leading zeros, ROADMAP C13). The reference routes uniform dump bodies
// through Polars' multithreaded Rust CSV reader (reference
// load_save.py:42-64); this is the equivalent host-side native component:
// OpenMP threads split the text at line boundaries, count rows, then parse
// with std::from_chars (no locale, no per-token malloc) straight into
// caller-provided numeric and fixed-width string matrices.
//
// Contract: rows are non-empty lines; each row must contain exactly
// `ncols` tokens. Columns flagged in `is_str` are copied as zero-padded
// fixed-width byte strings (token longer than str_width -> error); the
// rest must parse fully as float64. Rows with global index >= max_rows
// are ignored (a multi-frame dump's next header follows the body in the
// same buffer). Any malformed row among the first max_rows aborts with a
// negative return so Python can fall back to the general parser.

#include <charconv>
#include <cstdint>
#include <cstring>
#include <omp.h>

namespace {

inline bool is_ws(char c) { return c == ' ' || c == '\t' || c == '\r'; }

inline bool line_has_content(const char* s, const char* e) {
    for (const char* p = s; p < e; ++p)
        if (!is_ws(*p)) return true;
    return false;
}

// Count non-empty lines in [begin, end) of text — memchr-paced: the
// per-line content check only scans when the line starts with whitespace
// (blank-ish lines are rare in table bodies).
long long count_rows(const char* text, long long begin, long long end) {
    long long rows = 0;
    const char* p = text + begin;
    const char* stop = text + end;
    while (p < stop) {
        const char* nl =
            static_cast<const char*>(memchr(p, '\n', stop - p));
        const char* eol = nl ? nl : stop;
        if (eol > p && (!is_ws(*p) || line_has_content(p, eol))) ++rows;
        if (!nl) break;
        p = nl + 1;
    }
    return rows;
}

// Clinger fast-path decimal parser: mantissa and power of ten both exact
// in double => one correctly-rounded multiply, bit-identical to strtod.
// Falls back to std::from_chars (slow but fully general) for long
// mantissas, big exponents, nan/inf. GCC's own from_chars<double> routes
// through strtod + locale (~60 MB/s) — too slow to be the primary path.
const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                         1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                         1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// Returns pointer past the number, or nullptr on parse failure.
inline const char* parse_double(const char* p, const char* end, double* out) {
    const char* tok = p;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) {
        neg = (*p == '-');
        ++p;
    }
    // Leading zeros are not digits of the mantissa: counting them would
    // drop the last significant digits of a short value such as
    // 0.0010992856888165524 (17 significant digits after 3 zeros) and
    // round it from a truncated mantissa. The JAX package's copy counts
    // them (ROADMAP C13).
    uint64_t mant = 0;
    int ndig = 0, exp10 = 0;
    bool any = false;
    while (p < end && (unsigned)(*p - '0') <= 9u) {
        if (mant == 0 && *p == '0') {
            // a leading zero of the integer part
        } else if (ndig < 19) {
            mant = mant * 10 + (unsigned)(*p - '0');
            ++ndig;
        } else {
            ++exp10;
        }
        ++p;
        any = true;
    }
    if (p < end && *p == '.') {
        ++p;
        while (p < end && (unsigned)(*p - '0') <= 9u) {
            if (mant == 0 && *p == '0') {
                --exp10;  // a leading zero of the fraction
            } else if (ndig < 19) {
                mant = mant * 10 + (unsigned)(*p - '0');
                ++ndig;
                --exp10;
            }
            ++p;
            any = true;
        }
    }
    if (p < end && any && (*p == 'e' || *p == 'E')) {
        const char* back = p;
        ++p;
        bool eneg = false;
        if (p < end && (*p == '-' || *p == '+')) {
            eneg = (*p == '-');
            ++p;
        }
        int e = 0;
        bool eany = false;
        while (p < end && (unsigned)(*p - '0') <= 9u && e < 100000) {
            e = e * 10 + (*p - '0');
            ++p;
            eany = true;
        }
        if (!eany)
            p = back;  // bare 'e' belongs to the next token ("1.0e" no)
        else
            exp10 += eneg ? -e : e;
    }
    if (any && mant < (1ull << 53) && exp10 >= -22 && exp10 <= 22) {
        double v = static_cast<double>(mant);
        v = exp10 >= 0 ? v * kPow10[exp10] : v / kPow10[-exp10];
        *out = neg ? -v : v;
        return p;
    }
    // General fallback (rare): long mantissa, huge exponent, nan/inf.
    auto res = std::from_chars(tok, end, *out);
    if (res.ec != std::errc()) return nullptr;
    return res.ptr;
}

struct ColMap {
    const int8_t* is_str;  // per input column
    const int32_t* slot;   // per input column: index among its own kind
    long long ncols, n_num, n_str, str_width;
    long long col_stride;  // rows capacity; outputs are column-major so
                           // Python reads each column as a zero-copy view
};

// Parse rows in [begin, end); the chunk's first row has global index
// `row0`. Stops once global index reaches max_rows. Returns false on a
// malformed row (< max_rows).
bool parse_chunk(const char* text, long long begin, long long end,
                 long long row0, long long max_rows, const ColMap& cm,
                 double* out_num, char* out_str) {
    long long row = row0;
    long long i = begin;
    while (i < end && row < max_rows) {
        while (i < end && (is_ws(text[i]) || text[i] == '\n')) ++i;
        if (i >= end) break;
        for (long long c = 0; c < cm.ncols; ++c) {
            while (i < end && is_ws(text[i])) ++i;
            if (i >= end || text[i] == '\n') return false;  // short row
            if (cm.is_str && cm.is_str[c]) {
                long long tok = i;
                while (i < end && !is_ws(text[i]) && text[i] != '\n') ++i;
                long long len = i - tok;
                if (len > cm.str_width) return false;  // token too wide
                char* d = out_str +
                          (cm.slot[c] * cm.col_stride + row) * cm.str_width;
                std::memcpy(d, text + tok, len);
                std::memset(d + len, 0, cm.str_width - len);
            } else {
                double v;
                const char* np = parse_double(text + i, text + end, &v);
                if (!np) return false;  // non-numeric token
                i = np - text;
                if (i < end && !is_ws(text[i]) && text[i] != '\n')
                    return false;  // junk glued to the number ("1.5x")
                out_num[cm.slot[c] * cm.col_stride + row] = v;
            }
        }
        while (i < end && is_ws(text[i])) ++i;
        if (i < end && text[i] != '\n') return false;  // extra tokens
        ++row;
    }
    return true;
}

}  // namespace

extern "C" {

// Returns min(total rows, max_rows) on success, -1 on any malformed row
// among the first max_rows. `is_str`/`slot` have `ncols` entries. Outputs
// are COLUMN-major with a column stride of max_rows: numeric values land
// in out_num[slot*max_rows + row], strings in fixed-width cells at
// out_str[(slot*max_rows + row)*str_width] — so the caller can hand each
// column to numpy as a zero-copy contiguous view.
long long parse_table_mixed(const char* text, long long nbytes,
                            long long ncols, const int8_t* is_str,
                            const int32_t* slot, long long n_num,
                            long long n_str, long long str_width,
                            long long max_rows, double* out_num,
                            char* out_str, int num_threads) {
    if (ncols <= 0 || max_rows < 0) return -1;
    int nt = num_threads > 0 ? num_threads : omp_get_max_threads();
    if (nbytes < (1 << 16)) nt = 1;  // tiny body: skip thread setup
    if (nt > 256) nt = 256;

    ColMap cm{is_str, slot, ncols, n_num, n_str, str_width, max_rows};

    // Chunk boundaries aligned to the character after a newline.
    long long starts[257];
    starts[0] = 0;
    for (int t = 1; t < nt; ++t) {
        long long s = nbytes * t / nt;
        while (s < nbytes && text[s] != '\n') ++s;
        starts[t] = (s < nbytes) ? s + 1 : nbytes;
    }
    starts[nt] = nbytes;

    long long rows_in[256];
#pragma omp parallel for num_threads(nt) schedule(static, 1)
    for (int t = 0; t < nt; ++t)
        rows_in[t] = count_rows(text, starts[t], starts[t + 1]);

    long long row0[257];
    row0[0] = 0;
    for (int t = 0; t < nt; ++t) row0[t + 1] = row0[t] + rows_in[t];
    long long total = row0[nt];
    long long produced = total < max_rows ? total : max_rows;

    int ok = 1;
#pragma omp parallel for num_threads(nt) schedule(static, 1) \
    reduction(&& : ok)
    for (int t = 0; t < nt; ++t) {
        if (row0[t] < max_rows)
            ok = ok && parse_chunk(text, starts[t], starts[t + 1], row0[t],
                                   max_rows, cm, out_num, out_str);
    }
    return ok ? produced : -1;
}

// Locate the byte offset just past the `nrows`-th non-empty line starting
// at `begin` — lets Python slice a frame body out of a multi-frame file
// without splitting the whole text into lines.
long long skip_rows(const char* text, long long nbytes, long long begin,
                    long long nrows) {
    long long rows = 0;
    const char* base = text;
    const char* p = text + begin;
    const char* stop = text + nbytes;
    while (p < stop && rows < nrows) {
        const char* nl =
            static_cast<const char*>(memchr(p, '\n', stop - p));
        const char* eol = nl ? nl : stop;
        if (eol > p && (!is_ws(*p) || line_has_content(p, eol))) ++rows;
        p = nl ? nl + 1 : stop;
    }
    return (rows == nrows) ? p - base : -1;
}

}  // extern "C"
