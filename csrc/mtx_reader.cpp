// Native MatrixMarket coordinate reader.
//
// Counterpart of the reference's host-side fast_matrix_market
// ingestion (spgemm.cu:43-110): a multithreaded text parser that fills raw
// COO triplet arrays. Symmetry generalization and complex->real reduction
// are done by the Python caller on the raw triplets (vectorized numpy),
// mirroring how the reference lets fast_matrix_market generalize symmetry.
//
// C ABI (used via ctypes, no pybind11 dependency):
//   mtx_read_header(path, &nrows, &ncols, &nnz, &field, &symmetry) -> 0/err
//   mtx_read_data(path, rows, cols, vals, cap, nthreads) -> nnz parsed or -err
//
// field:    0=real 1=integer 2=pattern 3=complex
// symmetry: 0=general 1=symmetric 2=skew-symmetric 3=hermitian

#include <algorithm>
#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Header {
  int64_t nrows = 0, ncols = 0, nnz = 0;
  int field = 0;     // real
  int symmetry = 0;  // general
  int64_t data_offset = 0;  // byte offset of first data line
};

// Reads the whole file into a buffer. Returns false on IO error.
bool slurp(const char* path, std::string& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) { std::fclose(f); return false; }
  out.resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(out.data(), 1, out.size(), f) : 0;
  std::fclose(f);
  return got == out.size();
}

const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

int parse_header(const std::string& buf, Header& h) {
  const char* p = buf.data();
  const char* end = p + buf.size();
  // Banner: %%MatrixMarket matrix coordinate <field> <symmetry>
  if (buf.size() < 14 || std::strncmp(p, "%%MatrixMarket", 14) != 0) return 1;
  const char* eol = p;
  while (eol < end && *eol != '\n') ++eol;
  std::string banner(p, eol);
  for (auto& c : banner) c = static_cast<char>(std::tolower(c));
  if (banner.find("coordinate") == std::string::npos) return 2;  // no dense
  if (banner.find("complex") != std::string::npos) h.field = 3;
  else if (banner.find("integer") != std::string::npos) h.field = 1;
  else if (banner.find("pattern") != std::string::npos) h.field = 2;
  else h.field = 0;
  if (banner.find("skew-symmetric") != std::string::npos) h.symmetry = 2;
  else if (banner.find("symmetric") != std::string::npos) h.symmetry = 1;
  else if (banner.find("hermitian") != std::string::npos) h.symmetry = 3;
  else h.symmetry = 0;
  p = next_line(p, end);
  // Comments
  while (p < end && *p == '%') p = next_line(p, end);
  // Size line
  p = skip_ws(p, end);
  auto r1 = std::from_chars(p, end, h.nrows);
  if (r1.ec != std::errc()) return 3;
  p = skip_ws(r1.ptr, end);
  auto r2 = std::from_chars(p, end, h.ncols);
  if (r2.ec != std::errc()) return 3;
  p = skip_ws(r2.ptr, end);
  auto r3 = std::from_chars(p, end, h.nnz);
  if (r3.ec != std::errc()) return 3;
  p = next_line(r3.ptr, end);
  h.data_offset = p - buf.data();
  return 0;
}

// Parses data lines in [begin, end). Indices converted to 0-base.
// Returns number of entries written; writes at out_* starting at slot 0.
int64_t parse_range(const char* p, const char* end, int field,
                    int32_t* out_r, int32_t* out_c, double* out_v,
                    int64_t cap) {
  int64_t n = 0;
  while (p < end && n < cap) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') { ++p; continue; }
    if (*p == '%') { p = next_line(p, end); continue; }
    int64_t i = 0, j = 0;
    auto ri = std::from_chars(p, end, i);
    if (ri.ec != std::errc()) { p = next_line(p, end); continue; }
    p = skip_ws(ri.ptr, end);
    auto rj = std::from_chars(p, end, j);
    if (rj.ec != std::errc()) { p = next_line(p, end); continue; }
    p = rj.ptr;
    double v = 1.0;
    if (field != 2) {  // not pattern: parse first numeric token (real part)
      p = skip_ws(p, end);
      auto rv = std::from_chars(p, end, v);
      if (rv.ec != std::errc()) { p = next_line(p, end); continue; }
      p = rv.ptr;  // complex: imaginary part skipped with rest of line
    }
    out_r[n] = static_cast<int32_t>(i - 1);
    out_c[n] = static_cast<int32_t>(j - 1);
    out_v[n] = v;
    ++n;
    p = next_line(p, end);
  }
  return n;
}

}  // namespace

extern "C" {

int mtx_read_header(const char* path, int64_t* nrows, int64_t* ncols,
                    int64_t* nnz, int* field, int* symmetry) {
  std::string buf;
  if (!slurp(path, buf)) return -1;
  Header h;
  int err = parse_header(buf, h);
  if (err) return -10 - err;
  *nrows = h.nrows; *ncols = h.ncols; *nnz = h.nnz;
  *field = h.field; *symmetry = h.symmetry;
  return 0;
}

// Fills rows/cols/vals (caller-allocated, capacity cap >= declared nnz).
// Returns entries parsed, or negative error code.
int64_t mtx_read_data(const char* path, int32_t* rows, int32_t* cols,
                      double* vals, int64_t cap, int nthreads) {
  std::string buf;
  if (!slurp(path, buf)) return -1;
  Header h;
  int err = parse_header(buf, h);
  if (err) return -10 - err;

  const char* data = buf.data() + h.data_offset;
  const char* end = buf.data() + buf.size();
  int64_t bytes = end - data;
  if (nthreads < 1) nthreads = 1;
  if (bytes < (1 << 20)) nthreads = 1;  // small file: no thread overhead

  if (nthreads == 1) {
    return parse_range(data, end, h.field, rows, cols, vals, cap);
  }

  // Split into newline-aligned chunks; each thread parses into a local
  // buffer (entry counts per chunk are unknown until parsed), then results
  // are concatenated in order.
  std::vector<const char*> starts(nthreads + 1);
  starts[0] = data;
  for (int t = 1; t < nthreads; ++t) {
    const char* p = data + bytes * t / nthreads;
    while (p < end && *p != '\n') ++p;
    starts[t] = p < end ? p + 1 : end;
  }
  starts[nthreads] = end;

  std::vector<std::vector<int32_t>> lr(nthreads), lc(nthreads);
  std::vector<std::vector<double>> lv(nthreads);
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&, t]() {
      int64_t chunk_cap = cap;  // upper bound; vectors grow as needed
      int64_t approx = (starts[t + 1] - starts[t]) / 8 + 16;
      if (approx < chunk_cap) chunk_cap = approx * 2 + 64;
      lr[t].resize(chunk_cap); lc[t].resize(chunk_cap); lv[t].resize(chunk_cap);
      int64_t n = parse_range(starts[t], starts[t + 1], h.field,
                              lr[t].data(), lc[t].data(), lv[t].data(),
                              chunk_cap);
      lr[t].resize(n); lc[t].resize(n); lv[t].resize(n);
    });
  }
  for (auto& th : threads) th.join();

  int64_t total = 0;
  for (int t = 0; t < nthreads; ++t) {
    int64_t n = static_cast<int64_t>(lr[t].size());
    if (total + n > cap) n = cap - total;
    if (n <= 0) break;
    std::memcpy(rows + total, lr[t].data(), n * sizeof(int32_t));
    std::memcpy(cols + total, lc[t].data(), n * sizeof(int32_t));
    std::memcpy(vals + total, lv[t].data(), n * sizeof(double));
    total += n;
  }
  return total;
}

}  // extern "C"
