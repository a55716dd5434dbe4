// The port's native host builder: the gather path's degree-bucketed layout
// and the SBM1 sparse binary file format.  A copy of the JAX package's
// native/layout.cpp without its dense-pair accumulation and quantization,
// which the port does not call (its pair build sums over the observed
// cells only, ops/dense_gram.py).
//
// Built at first use by native/__init__.py with the host C++ compiler
// (g++ -O3 -fPIC -shared) into the package's _build/ and bound with
// ctypes through a plain C interface.  Its outputs equal the NumPy
// builders' (ops/layout.py, ops/sparse.py) bit for bit.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Phase 1: piece planning.
// Splits each instance's observation run into pieces: floor(deg / wmax)
// full pieces of the widest width wmax and a remainder piece, assigned to
// the narrowest bucket width that holds it.  Writes every instance's
// degree and each width's piece count, so the caller can allocate.
// Returns the number of pieces, or -1 on a bad width list or an index out
// of range.
// ---------------------------------------------------------------------------
int64_t bdf_plan_layout(
    int64_t nnz, int32_t n_modes, int32_t mode, int64_t n_instances,
    const int32_t* idx,            // [nnz, n_modes] row-major
    const int64_t* widths, int32_t n_widths,   // ascending
    int64_t* deg_out,              // [n_instances]
    int64_t* pieces_per_width_out  // [n_widths]
) {
    if (n_widths <= 0) return -1;
    const int64_t wmax = widths[n_widths - 1];
    memset(deg_out, 0, sizeof(int64_t) * n_instances);
    for (int64_t n = 0; n < nnz; ++n) {
        int32_t i = idx[n * n_modes + mode];
        if (i < 0 || i >= n_instances) return -1;
        deg_out[i]++;
    }
    memset(pieces_per_width_out, 0, sizeof(int64_t) * n_widths);
    int64_t total = 0;
    for (int64_t i = 0; i < n_instances; ++i) {
        int64_t d = deg_out[i];
        if (d == 0) continue;
        int64_t full = d / wmax, rem = d - full * wmax;
        pieces_per_width_out[n_widths - 1] += full;
        if (rem > 0) {
            int32_t c = 0;
            while (widths[c] < rem) ++c;
            pieces_per_width_out[c]++;
        }
        total += full + (rem > 0);
    }
    return total;
}

// ---------------------------------------------------------------------------
// Phase 2: fill the caller's zeroed bucket arrays in one pass.
// Per bucket c of width W: inst[rows_c], part[(n_modes - 1)][rows_c * W],
// val[rows_c * W] and mask[rows_c * W], passed as arrays of pointers.
// Values are float32, vals[obs] - mean rounded once.  Observations are
// taken in CSR-by-instance order (a stable counting sort), each
// instance's pieces in order, so the layout is the NumPy builder's.
// Returns 0.
// ---------------------------------------------------------------------------
int32_t bdf_fill_layout(
    int64_t nnz, int32_t n_modes, int32_t mode, int64_t n_instances,
    const int32_t* idx, const double* vals, double mean,
    const int64_t* widths, int32_t n_widths,
    const int64_t* deg,            // from bdf_plan_layout
    int32_t** inst_ptrs,           // [n_widths] -> int32[rows_c]
    int32_t** part_ptrs,           // [n_widths * (n_modes - 1)]
    float** val_ptrs,              // [n_widths] -> float[rows_c * W]
    float** mask_ptrs              // [n_widths] -> float[rows_c * W]
) {
    const int64_t wmax = widths[n_widths - 1];
    std::vector<int64_t> ptr(n_instances + 1, 0);
    for (int64_t i = 0; i < n_instances; ++i) ptr[i + 1] = ptr[i] + deg[i];
    std::vector<int64_t> order(nnz);
    {
        std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
        for (int64_t n = 0; n < nnz; ++n) {
            int32_t i = idx[n * n_modes + mode];
            order[cur[i]++] = n;
        }
    }
    std::vector<int64_t> next_row(n_widths, 0);  // next free row a bucket

    const int32_t n_other = n_modes - 1;
    for (int64_t i = 0; i < n_instances; ++i) {
        int64_t off = ptr[i], remaining = deg[i];
        while (remaining > 0) {
            int64_t len = remaining > wmax ? wmax : remaining;
            int32_t c = n_widths - 1;
            if (remaining <= wmax) {
                c = 0;
                while (widths[c] < len) ++c;
            }
            const int64_t W = widths[c];
            const int64_t r = next_row[c]++;
            inst_ptrs[c][r] = (int32_t)i;
            float* vrow = val_ptrs[c] + r * W;
            float* mrow = mask_ptrs[c] + r * W;
            for (int64_t w = 0; w < len; ++w) {
                const int64_t obs = order[off + w];
                vrow[w] = (float)(vals[obs] - mean);
                mrow[w] = 1.0f;
                int32_t k = 0;
                for (int32_t d = 0; d < n_modes; ++d) {
                    if (d == mode) continue;
                    part_ptrs[c * n_other + k][r * W + w] =
                        idx[obs * n_modes + d];
                    ++k;
                }
            }
            off += len;
            remaining -= len;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// SBM1 files (ops/sparse.py): the magic "SBM1", nrow, ncol and nnz as
// int64, then the rows and the cols as int32 (little-endian hosts).
// ---------------------------------------------------------------------------
int64_t bdf_read_sbm_header(const char* path, int64_t* shape_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char magic[4];
    int64_t hdr[3];
    if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "SBM1", 4) != 0 ||
        fread(hdr, 8, 3, f) != 3) {
        fclose(f);
        return -1;
    }
    shape_out[0] = hdr[0];
    shape_out[1] = hdr[1];
    fclose(f);
    return hdr[2];  // nnz
}

int32_t bdf_read_sbm(const char* path, int64_t nnz,
                     int32_t* rows, int32_t* cols) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 4 + 24, SEEK_SET);
    size_t ok = fread(rows, 4, nnz, f);
    ok += fread(cols, 4, nnz, f);
    fclose(f);
    return ok == (size_t)(2 * nnz) ? 0 : -1;
}

int32_t bdf_write_sbm(const char* path, int64_t nrow, int64_t ncol,
                      int64_t nnz, const int32_t* rows,
                      const int32_t* cols) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    int64_t hdr[3] = {nrow, ncol, nnz};
    size_t ok = fwrite("SBM1", 1, 4, f) == 4 && fwrite(hdr, 8, 3, f) == 3 &&
                fwrite(rows, 4, nnz, f) == (size_t)nnz &&
                fwrite(cols, 4, nnz, f) == (size_t)nnz;
    return (fclose(f) == 0 && ok) ? 0 : -1;
}

}  // extern "C"
