// Native IO helpers for the .dat text contract.
//
// The reference's only non-Fortran native component is its HIP kernel file
// (fortran/hip/heat_kernel.cpp); the stencil kernels live in ops/csrc, so the
// native dimension of this framework sits where it still pays off: the
// O(n^2)-line text dumps of soln.dat/int.dat (fortran/serial/heat.f90:77-83),
// which dominate wall-clock at large n if written from Python. Compiled to
// libfastio.so and bound via ctypes (no pybind11 in the image).
//
// Format parity: whitespace-separated floating-point columns, one point per
// line, readable by the reference's regex-splitting viz scripts
// (fortran/serial/out.py:17-25).

#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>

namespace {
constexpr size_t kBufCap = 1 << 20;  // 1 MiB write buffer

struct Buf {
  FILE* f;
  std::unique_ptr<char[]> data{new char[kBufCap + 4096]};
  size_t len = 0;

  explicit Buf(FILE* file) : f(file) {}
  void flush() {
    if (len) {
      fwrite(data.get(), 1, len, f);
      len = 0;
    }
  }
  void put_double(double v) {
    auto [ptr, ec] = std::to_chars(data.get() + len, data.get() + len + 64, v);
    (void)ec;
    len = ptr - data.get();
  }
  void put_char(char c) { data[len++] = c; }
  void maybe_flush() {
    if (len >= kBufCap) flush();
  }
};
}  // namespace

extern "C" {

// Write `rows` lines of `cols` doubles each. Returns 0 on success.
int heat_write_table(const char* path, const double* data, long rows, long cols) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  Buf buf(f);
  for (long i = 0; i < rows; ++i) {
    const double* row = data + i * cols;
    for (long j = 0; j < cols; ++j) {
      if (j) buf.put_char(' ');
      buf.put_double(row[j]);
      buf.maybe_flush();  // per value: the slack must bound ONE value,
                          // not a whole row of caller-chosen width
    }
    buf.put_char('\n');
    buf.maybe_flush();
  }
  buf.flush();
  int rc = ferror(f) ? -2 : 0;
  fclose(f);
  return rc;
}

// Read up to `max_vals` whitespace-separated doubles from a text file.
// Returns the number parsed, or -1 on open failure.
long heat_read_table(const char* path, double* out, long max_vals) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  long count = 0;
  while (count < max_vals && fscanf(f, "%lf", &out[count]) == 1) ++count;
  fclose(f);
  return count;
}

}  // extern "C"
