// Native data-file section parsers — the performance-critical host IO the
// reference implements in C++ (reference: src/read_data.cpp:511-580 parses
// Atoms/Velocities/Bonds with per-line sscanf; src/dump_custom.cpp formats
// trajectory frames).  Exposed through ctypes (no pybind11 in this image).
//
// The Python layer (lammps_le_torch.io.data) falls back to a pure-numpy
// parser when this library is unavailable; behavior is identical.
//
// Build: cc -O2 -shared -fPIC fastio.cc -o libfastio.so  (see build.py)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse whitespace-separated doubles row-wise.
// buf/len: text region containing exactly `rows` data lines.
// cols_out: number of columns to store per row; extra columns ignored,
// missing columns zero-filled.  First column is the 1-based row id used
// to place the row (LAMMPS sections may be unordered).
// Returns number of rows parsed, or -1 on error.
long lle_parse_section(const char* buf, long len, long rows, int cols_out,
                       double* out) {
  const char* p = buf;
  const char* end = buf + len;
  long parsed = 0;
  while (p < end && parsed < rows) {
    // skip blank/comment lines
    while (p < end && (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t'))
      p++;
    if (p >= end) break;
    if (*p == '#') {
      while (p < end && *p != '\n') p++;
      continue;
    }
    char* next = nullptr;
    double id = strtod(p, &next);
    if (next == p) return -1;
    p = next;
    long row = (long)id - 1;
    if (row < 0 || row >= rows) return -1;
    double* dst = out + row * cols_out;
    dst[0] = id;
    for (int c = 1; c < cols_out; c++) {
      // stop at end of line
      const char* q = p;
      while (q < end && (*q == ' ' || *q == '\t')) q++;
      if (q >= end || *q == '\n' || *q == '\r' || *q == '#') {
        dst[c] = 0.0;
        continue;
      }
      double v = strtod(p, &next);
      if (next == p) {
        dst[c] = 0.0;
      } else {
        dst[c] = v;
        p = next;
      }
    }
    while (p < end && *p != '\n') p++;
    parsed++;
  }
  return parsed;
}

// Format a dump frame of `n` rows of (id, type, x, y, z) into out
// (caller-allocated, cap bytes).  Returns bytes written or -1.
long lle_format_xyz(const int* type, const double* x, long n, char* out,
                    long cap) {
  long w = 0;
  for (long i = 0; i < n; i++) {
    if (w + 128 > cap) return -1;
    w += snprintf(out + w, cap - w, "%d %.6g %.6g %.6g\n", type[i] + 1,
                  x[i * 3 + 0], x[i * 3 + 1], x[i * 3 + 2]);
  }
  return w;
}

}  // extern "C"
