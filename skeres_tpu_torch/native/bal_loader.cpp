// Fast BAL (Bundle Adjustment in the Large) text parser.
//
// Native tier of the data-loading path (counterpart of the reference
// lineage's examples/bal_problem.cc loader, which is C++): mmaps the file
// and scans numbers token by token — no line splitting, no Python object
// churn.
//
// Each float is converted by strtod (correctly rounded, as the Python
// parser's float()). A token that is not a number fails the parse, as a
// file that ends early does: bal_load then returns nonzero.
//
// Exposed as a C ABI for ctypes:
//   bal_sizes(path, out[3])             -> 0 on success
//   bal_load(path, cam_idx, pt_idx, obs, cameras, points) -> 0 on success
// Caller allocates arrays with the sizes from bal_sizes.

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open_file(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = static_cast<size_t>(st.st_size);
    data = static_cast<const char*>(
        mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
    if (data == MAP_FAILED) {
      data = nullptr;
      return false;
    }
    madvise(const_cast<char*>(data), size, MADV_SEQUENTIAL);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

inline const char* skip_space(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) ++p;
  return p;
}

// One number token: its characters up to the next white space, copied
// into a NUL-terminated buffer and converted by strtod, so that the value
// is the correctly rounded double (the same as Python's float()). A token
// that strtod does not consume whole fails the parse.
inline const char* parse_double(const char* p, const char* end, double* out) {
  p = skip_space(p, end);
  if (p >= end) return nullptr;
  char buf[64];
  size_t n = 0;
  while (p < end && !(*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) {
    if (n + 1 >= sizeof(buf)) return nullptr;
    buf[n++] = *p++;
  }
  buf[n] = '\0';
  char* stop = nullptr;
  *out = std::strtod(buf, &stop);
  if (stop != buf + n) return nullptr;
  return p;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
  p = skip_space(p, end);
  if (p >= end) return nullptr;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  int64_t v = 0;
  const char* digits = p;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  if (p == digits) return nullptr;
  *out = neg ? -v : v;
  return p;
}

}  // namespace

extern "C" {

int bal_sizes(const char* path, int64_t* out3) {
  MappedFile f;
  if (!f.open_file(path)) return -1;
  const char* p = f.data;
  const char* end = f.data + f.size;
  for (int i = 0; i < 3; ++i) {
    p = parse_i64(p, end, &out3[i]);
    if (!p) return -2;
  }
  return 0;
}

int bal_load(const char* path, int32_t* cam_idx, int32_t* pt_idx,
             double* obs /* (nobs, 2) */, double* cameras /* (nc, 9) */,
             double* points /* (np, 3) */) {
  MappedFile f;
  if (!f.open_file(path)) return -1;
  const char* p = f.data;
  const char* end = f.data + f.size;

  int64_t nc = 0, npts = 0, nobs = 0;
  p = parse_i64(p, end, &nc);
  if (p) p = parse_i64(p, end, &npts);
  if (p) p = parse_i64(p, end, &nobs);
  if (!p) return -2;

  for (int64_t i = 0; i < nobs; ++i) {
    int64_t c, q;
    p = parse_i64(p, end, &c);
    if (!p) return -3;
    p = parse_i64(p, end, &q);
    if (!p) return -3;
    cam_idx[i] = static_cast<int32_t>(c);
    pt_idx[i] = static_cast<int32_t>(q);
    p = parse_double(p, end, &obs[2 * i]);
    if (!p) return -3;
    p = parse_double(p, end, &obs[2 * i + 1]);
    if (!p) return -3;
  }
  for (int64_t i = 0; i < nc * 9; ++i) {
    p = parse_double(p, end, &cameras[i]);
    if (!p) return -4;
  }
  for (int64_t i = 0; i < npts * 3; ++i) {
    p = parse_double(p, end, &points[i]);
    if (!p) return -5;
  }
  return 0;
}

}  // extern "C"
