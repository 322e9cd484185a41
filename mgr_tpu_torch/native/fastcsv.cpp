// fastcsv: a numeric CSV reader, a copy of mgr_tpu/native/fastcsv.cpp
// (its C ABI, error codes and parse unchanged).
//
// Each cell is parsed by strtof, straight from its decimal text to the
// nearest float32. np.loadtxt(dtype=float32) rounds to float64 first and
// then to float32, which gives another float32 for a decimal close to a
// float32 rounding midpoint: this parser is what gives the JAX package's
// bits. Built at first use by the host C++ compiler
// (mgr_tpu_torch/kernels/build.py::load_host) and bound with ctypes
// (mgr_tpu_torch/data/fastcsv.py).
//
// C ABI:
//   int fastcsv_load(const char* path, int skip_header,
//                    float** out_data, long long* out_rows,
//                    long long* out_cols);
//     Returns 0 on success. *out_data is malloc'd row-major
//     (rows x cols) float32; caller frees with fastcsv_free.
//     Ragged rows or non-numeric cells -> error codes below.
//   void fastcsv_free(float* data);
//
// Error codes: 1 open failed, 2 empty, 3 ragged row, 4 bad number,
//              5 alloc failed.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

static int parse_buffer(const char* buf, size_t n, int skip_header,
                        std::vector<float>& out, long long* rows,
                        long long* cols) {
  size_t i = 0;
  // Optionally skip the first line.
  if (skip_header) {
    while (i < n && buf[i] != '\n') i++;
    if (i < n) i++;
  }
  long long ncols = -1;
  long long nrows = 0;
  while (i < n) {
    // Skip blank lines.
    if (buf[i] == '\n' || buf[i] == '\r') { i++; continue; }
    long long c = 0;
    while (i < n && buf[i] != '\n') {
      char* end = nullptr;
      float v = strtof(buf + i, &end);
      if (end == buf + i) return 4;  // no parse progress
      out.push_back(v);
      c++;
      i = (size_t)(end - buf);
      while (i < n && (buf[i] == ' ' || buf[i] == '\t' || buf[i] == '\r'))
        i++;
      if (i < n && buf[i] == ',') i++;
    }
    if (i < n) i++;  // consume '\n'
    if (ncols < 0) ncols = c;
    else if (c != ncols) return 3;
    nrows++;
  }
  if (nrows == 0 || ncols <= 0) return 2;
  *rows = nrows;
  *cols = ncols;
  return 0;
}

int fastcsv_load(const char* path, int skip_header, float** out_data,
                 long long* out_rows, long long* out_cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0) { fclose(f); return 2; }
  char* buf = (char*)malloc((size_t)sz + 1);
  if (!buf) { fclose(f); return 5; }
  size_t got = fread(buf, 1, (size_t)sz, f);
  fclose(f);
  buf[got] = '\0';

  std::vector<float> vals;
  vals.reserve((size_t)got / 6);  // ~6 bytes per numeric cell
  long long rows = 0, cols = 0;
  int rc = parse_buffer(buf, got, skip_header, vals, &rows, &cols);
  free(buf);
  if (rc != 0) return rc;

  float* data = (float*)malloc(vals.size() * sizeof(float));
  if (!data) return 5;
  memcpy(data, vals.data(), vals.size() * sizeof(float));
  *out_data = data;
  *out_rows = rows;
  *out_cols = cols;
  return 0;
}

void fastcsv_free(float* data) { free(data); }

}  // extern "C"
