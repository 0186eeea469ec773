// Native result-dump writer: the reference's four-file COO text layout
// (/tmp/SPGEMM_RESULT_{NNZ,ROWS,COLS,VALS}.txt, spgemm.cu:1527-1560) at
// C++ stream speed.  The reference highlights multi-GiB dumps (README.md:
// 43-44: webbase-1M's A^2 text output exceeds 1.5 GiB); numpy savetxt
// writes these ~100x slower than a buffered formatter.
//
// ctypes ABI (see pem_spgemm/io/mtx.py):
//   int64 write_result_files(const char* dir, const char* prefix,
//                            const int32* rows, const int32* cols,
//                            const double* vals, int64 nnz, int nthreads)
// Returns nnz on success, -1 on failure.  Values print at max_digits10
// (17 significant digits), matching the reference's precision choice.

#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Each thread formats a contiguous slice into its own buffer, then slices
// are written in order: parallel formatting, sequential IO.
template <typename T, typename Fmt>
bool write_column(const std::string& path, const T* data, int64_t n,
                  int nthreads, Fmt fmt) {
  if (nthreads < 1) nthreads = 1;
  std::vector<std::string> parts(nthreads);
  std::vector<std::thread> threads;
  int64_t per = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&, t]() {
      int64_t lo = t * per;
      int64_t hi = lo + per < n ? lo + per : n;
      if (lo >= hi) return;
      std::string& out = parts[t];
      out.reserve(static_cast<size_t>((hi - lo) * 26));
      char buf[384];   // %.17f of the largest double is ~330 chars
      for (int64_t i = lo; i < hi; ++i) {
        int len = fmt(buf, data[i]);
        out.append(buf, len);
      }
    });
  }
  for (auto& th : threads) th.join();

  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) return false;
  bool ok = true;
  for (auto& p : parts) {
    if (!p.empty() && std::fwrite(p.data(), 1, p.size(), f) != p.size()) {
      ok = false;
      break;
    }
  }
  std::fclose(f);
  return ok;
}

}  // namespace

extern "C" int64_t write_result_files(const char* dir, const char* prefix,
                                      const int32_t* rows,
                                      const int32_t* cols,
                                      const double* vals, int64_t nnz,
                                      int nthreads) {
  std::string base = std::string(dir) + "/" + prefix + "_";

  {
    FILE* f = std::fopen((base + "NNZ.txt").c_str(), "wb");
    if (!f) return -1;
    std::fprintf(f, "%" PRId64 "\n", nnz);
    std::fclose(f);
  }
  auto int_fmt = [](char* buf, int32_t v) {
    return std::snprintf(buf, 384, "%d\n", v);
  };
  // Fixed notation, 17 digits after the point: byte-identical to the
  // reference's std::fixed << setprecision(max_digits10) dump format
  // (spgemm.cu:1545-1560), e.g. 0.50000000000000000 rather than 0.5.
  auto val_fmt = [](char* buf, double v) {
    return std::snprintf(buf, 384, "%.17f\n", v);
  };
  if (!write_column(base + "ROWS.txt", rows, nnz, nthreads, int_fmt))
    return -1;
  if (!write_column(base + "COLS.txt", cols, nnz, nthreads, int_fmt))
    return -1;
  if (!write_column(base + "VALS.txt", vals, nnz, nthreads, val_fmt))
    return -1;
  return nnz;
}
