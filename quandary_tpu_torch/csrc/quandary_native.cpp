// Native runtime support for quandary_tpu_torch (the IO and RNG library of
// native/quandary_native.cpp, kept as the port's own copy).
//
// 1. Fast formatted trajectory-file IO. The reference writes its trajectory
//    dumps from C++ (output.cpp:203-273); the Python fallback formatter is
//    orders of magnitude slower for fullstate dumps (ntime x N^2 doubles).
//    These writers produce byte-identical formats.
//
// 2. Reference-exact PRNG: std::mt19937 + std::uniform_real_distribution
//    exactly as the reference's random control initialization
//    (main.cpp:45-54 seeds; oscillator.cpp:164-189 draws). Using the same
//    libstdc++ facilities guarantees bit parity with a Linux-built
//    reference binary, which pure-numpy code cannot (numpy's MT19937
//    seeding and double-generation differ).
//
// Built with g++ at first use into build/quandary_tpu_torch/ and loaded via
// ctypes (quandary_tpu_torch/io/native.py); everything here is plain C ABI.

#include <cstdio>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// Write rows "time  v v v ..." with the reference's "%1.10e  " cell format
// (output.cpp:256-262). data is row-major (nrows x ncols); rows are written
// for i = 0, decim, 2*decim, ... < nrows.
int qtpu_write_state_rows(const char* path, const char* header,
                          const double* times, const double* data,
                          int64_t nrows, int64_t ncols, int64_t decim) {
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    if (header && header[0]) fputs(header, f);
    std::vector<char> buf;
    buf.resize(32 * (ncols + 2));
    for (int64_t i = 0; i < nrows; i += (decim > 0 ? decim : 1)) {
        char* p = buf.data();
        p += snprintf(p, 32, "%.8f  ", times[i]);
        const double* row = data + i * ncols;
        for (int64_t j = 0; j < ncols; j++) {
            p += snprintf(p, 32, "%1.10e  ", row[j]);
        }
        *p++ = '\n';
        fwrite(buf.data(), 1, p - buf.data(), f);
    }
    fclose(f);
    return 0;
}

// Write rows "time v v ..." with "%1.14e" cells and a per-file separator
// convention (expected/population files, output.cpp:208-243).
int qtpu_write_obs_rows(const char* path, const char* header,
                        const double* times, const double* data,
                        int64_t nrows, int64_t ncols, int64_t decim,
                        const char* sep) {
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    if (header && header[0]) fputs(header, f);
    for (int64_t i = 0; i < nrows; i += (decim > 0 ? decim : 1)) {
        fprintf(f, "%.8f", times[i]);
        const double* row = data + i * ncols;
        for (int64_t j = 0; j < ncols; j++) {
            fprintf(f, "%s%1.14e", sep, row[j]);
        }
        fputc('\n', f);
    }
    fclose(f);
    return 0;
}

// Reference-exact uniform draws: mt19937 seeded with `seed`, n draws from
// std::uniform_real_distribution<double>(0,1). The engine state is NOT
// shared between calls — matching the reference's pass-by-value engine copy
// (oscillator ctor signature, oscillator.hpp / main.cpp:240), which restarts
// the stream for every oscillator.
void qtpu_mt19937_uniform(uint32_t seed, int64_t n, double* out) {
    std::mt19937 eng(seed);
    std::uniform_real_distribution<double> dist(0.0, 1.0);
    for (int64_t i = 0; i < n; i++) out[i] = dist(eng);
}

// Stateful variant for callers that need one continuous stream.
struct QtpuRng {
    std::mt19937 eng;
    std::uniform_real_distribution<double> dist{0.0, 1.0};
};

void* qtpu_rng_new(uint32_t seed) { return new QtpuRng{std::mt19937(seed)}; }
void qtpu_rng_free(void* h) { delete static_cast<QtpuRng*>(h); }
void qtpu_rng_uniform(void* h, int64_t n, double* out) {
    auto* r = static_cast<QtpuRng*>(h);
    for (int64_t i = 0; i < n; i++) out[i] = r->dist(r->eng);
}

// Sparse-triplet Hamiltonian file reader (hamiltonian_Hsys.dat /
// hamiltonian_Hc.dat, the formats quandary.py:__dump writes). Lines are
// "row col re im" (ncols_id = 2) or "osc row col re im" (ncols_id = 3);
// '#' starts a comment. Fills parallel arrays of ids (int64, ncols_id per
// entry) and values (re, im per entry); returns the number of triplets
// read, or -1 on open failure. The reference reads these files with
// C++ streams on rank 0 (hamiltonianfilereader.cpp:21-105); the Python
// fallback parser is ~40x slower on million-line custom Hamiltonians.
int64_t qtpu_read_triplets(const char* path, int ncols_id,
                           int64_t* ids, double* vals, int64_t maxn) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    int64_t n = 0;
    char line[512];
    bool continuation = false;   // mid-line chunk of an over-long line
    while (n < maxn && fgets(line, sizeof line, f)) {
        bool has_eol = strchr(line, '\n') != nullptr;
        if (continuation) {      // skip the rest of an over-long line:
            continuation = !has_eol;   // its fragments are not triplets
            continue;
        }
        continuation = !has_eol;
        char* p = line;
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '#' || *p == '\n' || *p == '\0') continue;
        char* end = p;
        bool ok = true;
        for (int c = 0; c < ncols_id; c++) {
            long long v = strtoll(p, &end, 10);
            if (end == p) { ok = false; break; }
            ids[n * ncols_id + c] = (int64_t)v;
            p = end;
        }
        if (!ok) continue;
        double re = strtod(p, &end);
        if (end == p) continue;
        p = end;
        double im = strtod(p, &end);
        if (end == p) im = 0.0;
        vals[n * 2] = re;
        vals[n * 2 + 1] = im;
        n++;
    }
    fclose(f);
    return n;
}

// Fast whitespace-separated table reader (golden-file comparisons and
// warm-start params.dat loading). Returns number of values read, or -1.
int64_t qtpu_read_table(const char* path, double* out, int64_t maxn) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    int64_t n = 0;
    char tok[512];
    while (n < maxn && fscanf(f, "%511s", tok) == 1) {
        if (tok[0] == '#') {   // comment: skip to end of line
            int c;
            while ((c = fgetc(f)) != EOF && c != '\n') {}
            continue;
        }
        char* end = nullptr;
        double v = strtod(tok, &end);
        if (end != tok) out[n++] = v;
    }
    fclose(f);
    return n;
}

}  // extern "C"
