// Native (C++) binary-cube and source-catalog I/O of c2ray_tpu_torch, the
// port's own copy of the JAX package's reader (c2ray_tpu/native/
// io_native.cpp), bound with ctypes by c2ray_tpu_torch/native.
//
// Production density, clumping and LLS slices are multi-GB
// Fortran-ordered cubes read once per redshift slice (the reference's
// read_sm3d.f90, density_module.F90:203-243).  read_cube_f32 mmaps the
// file and does the Fortran -> C transpose with the fused unit conversion
// and empty-cell floor (density_module.F90:275-282) in cache blocks on
// every host thread.  read_source_catalog parses a source list (first
// line the count, one source a line) in one pass on every thread.
//
// A plain C ABI for ctypes.  g++ builds it at first use
// (c2ray_tpu_torch/native: g++ -O3 -std=c++17 -fPIC -pthread -shared).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr int kBlock = 64;  // cache-blocked transpose tile

// Transpose a Fortran-ordered (n1,n2,n3) float32 cube into C order with an
// optional affine conversion out = max(src*conv, floor_val) fused in.
void transpose_block(const float* src, float* dst, int64_t n1, int64_t n2,
                     int64_t n3, double conv, double floor_val, int64_t i_lo,
                     int64_t i_hi) {
  for (int64_t ib = i_lo; ib < i_hi; ib += kBlock) {
    int64_t ie = std::min(ib + int64_t(kBlock), i_hi);
    for (int64_t kb = 0; kb < n3; kb += kBlock) {
      int64_t ke = std::min(kb + int64_t(kBlock), n3);
      for (int64_t j = 0; j < n2; ++j) {
        for (int64_t i = ib; i < ie; ++i) {
          const float* s = src + i + n1 * j;
          float* d = dst + (i * n2 + j) * n3;
          for (int64_t k = kb; k < ke; ++k) {
            double v = double(s[n1 * n2 * k]) * conv;
            if (v <= 0.0) v = floor_val;
            d[k] = float(v);
          }
        }
      }
    }
  }
}

int n_threads() {
  unsigned hc = std::thread::hardware_concurrency();
  return hc ? int(hc) : 4;
}

}  // namespace

extern "C" {

// Read a stream-access float32 cube (optional 3x int32 mesh header),
// Fortran order on disk -> C order in `out`, with fused conversion
// out = max(v * conv, floor_val) (floor applied where v <= 0, matching
// density_module.F90:281 "empty cells get 0.1 particles").
// Returns 0 on success; negative errno-style codes otherwise.
int read_cube_f32(const char* path, int64_t n1, int64_t n2, int64_t n3,
                  int header, double conv, double floor_val, float* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -2;
  }
  int64_t offset = header ? 12 : 0;
  int64_t need = offset + n1 * n2 * n3 * int64_t(sizeof(float));
  if (st.st_size < need) {
    close(fd);
    return -3;
  }
  void* map = mmap(nullptr, size_t(need), PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return -4;
  if (header) {
    const int32_t* m = reinterpret_cast<const int32_t*>(map);
    if (m[0] != n1 || m[1] != n2 || m[2] != n3) {
      munmap(map, size_t(need));
      return -5;  // mesh-header validation (density_module.F90:217-223)
    }
  }
  const float* src =
      reinterpret_cast<const float*>(static_cast<const char*>(map) + offset);

  int nt = n_threads();
  std::vector<std::thread> ts;
  int64_t chunk = (n1 + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(lo + chunk, n1);
    if (lo >= hi) break;
    ts.emplace_back(transpose_block, src, out, n1, n2, n3, conv, floor_val,
                    lo, hi);
  }
  for (auto& t : ts) t.join();
  munmap(map, size_t(need));
  return 0;
}

// Parse an ASCII source catalog (sourceprops.F90:292-325 format: first
// line = row count, then one source per line, whitespace-separated
// numbers; short rows are zero-padded, extra columns ignored).  The
// reference reads these files TWICE per redshift slice (count pass +
// read pass, count_or_read_in_sources); production catalogs run to
// 1e6-1e8 halo lines, so this is a single mmap pass with threaded
// row parsing.  `out` must hold max_rows*ncols doubles.  Returns the
// number of rows parsed, or a negative error code.
int64_t read_source_catalog(const char* path, int64_t ncols, double* out,
                            int64_t max_rows) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -2;
  }
  if (st.st_size == 0) {
    close(fd);
    return -3;
  }
  void* map = mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return -4;
  const char* base = static_cast<const char*>(map);
  const char* end = base + st.st_size;

  // header: row count (first token of the first line)
  const char* p = base;
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  int64_t nrows = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    nrows = nrows * 10 + (*p - '0');
    ++p;
    any = true;
  }
  if (!any) {
    munmap(map, size_t(st.st_size));
    return -5;
  }
  const char* nl = static_cast<const char*>(
      memchr(p, '\n', size_t(end - p)));
  p = nl ? nl + 1 : end;
  if (nrows > max_rows) nrows = max_rows;

  // index the next nrows line starts (blank lines are rows of zeros,
  // matching the python reader)
  std::vector<const char*> starts(size_t(nrows) + 1);
  for (int64_t i = 0; i < nrows; ++i) {
    starts[size_t(i)] = p;
    if (p < end) {
      nl = static_cast<const char*>(memchr(p, '\n', size_t(end - p)));
      p = nl ? nl + 1 : end;
    }
  }
  starts[size_t(nrows)] = p;

  auto parse_rows = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const char* q = starts[size_t(r)];
      const char* qe = starts[size_t(r + 1)];
      double* row = out + r * ncols;
      for (int64_t cidx = 0; cidx < ncols; ++cidx) row[cidx] = 0.0;
      for (int64_t cidx = 0; cidx < ncols; ++cidx) {
        while (q < qe && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
        if (q >= qe || *q == '\n') break;
        const char* tok = q;
        while (q < qe && !(*q == ' ' || *q == '\t' || *q == '\r' ||
                           *q == '\n'))
          ++q;
        // bounded copy + strtod: correctly-rounded, bitwise-identical to
        // the python fallback reader (mmap is not NUL-terminated, so a
        // direct strtod on it could run past the mapping)
        char buf[64];
        size_t len = size_t(q - tok);
        if (len >= sizeof(buf)) len = sizeof(buf) - 1;
        memcpy(buf, tok, len);
        // Fortran D exponents (1.0D+05) -> E for strtod
        for (size_t ci = 0; ci < len; ++ci)
          if (buf[ci] == 'd' || buf[ci] == 'D') buf[ci] = 'e';
        buf[len] = '\0';
        row[cidx] = strtod(buf, nullptr);
      }
    }
  };

  int nt = n_threads();
  std::vector<std::thread> ts;
  int64_t chunk = (nrows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(lo + chunk, nrows);
    if (lo >= hi) break;
    ts.emplace_back(parse_rows, lo, hi);
  }
  for (auto& t : ts) t.join();
  munmap(map, size_t(st.st_size));
  return nrows;
}

// Write a C-ordered float32 cube to disk in Fortran order (+optional header).
int write_cube_f32(const char* path, int64_t n1, int64_t n2, int64_t n3,
                   int header, const float* data) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  if (header) {
    int32_t m[3] = {int32_t(n1), int32_t(n2), int32_t(n3)};
    if (fwrite(m, 4, 3, f) != 3) {
      fclose(f);
      return -2;
    }
  }
  // transpose to Fortran order in slabs of k
  std::vector<float> slab(size_t(n1) * size_t(n2));
  for (int64_t k = 0; k < n3; ++k) {
    for (int64_t j = 0; j < n2; ++j)
      for (int64_t i = 0; i < n1; ++i)
        slab[size_t(i + n1 * j)] = data[(i * n2 + j) * n3 + k];
    if (fwrite(slab.data(), sizeof(float), slab.size(), f) != slab.size()) {
      fclose(f);
      return -3;
    }
  }
  fclose(f);
  return 0;
}

}  // extern "C"
