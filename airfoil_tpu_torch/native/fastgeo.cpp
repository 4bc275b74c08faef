// fastgeo.cpp — native geometry hot paths for airfoil_tpu.
//
// Two components, exposed through a plain C ABI (loaded via ctypes, no
// pybind11 dependency):
//
// 1. parse_dat: the .dat tokenizer + Selig/Lednicer repair pipeline with
//    the exact semantics of airfoil_tpu/geometry/parser.py (itself the
//    behavioural port of the reference's parse_dat_file /
//    detect_and_merge_sections, reference main.py:59-180). Python remains
//    the source of truth; this implementation is differential-tested
//    against it and used for bulk benchmark parsing where per-file Python
//    overhead dominates.
//
// 2. raster_mask: scanline polygon rasterisation of a panelised loop onto
//    the LBM lattice (the reference does this in JS per AOA change,
//    html:159-182). Called on every wind-tunnel alpha slider move, so a
//    native path keeps interactive latency flat as grids grow.
//
// Build: g++ -O3 -march=native -shared -fPIC fastgeo.cpp -o libfastgeo.so

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

bool parse_pair(const char* line, size_t len, double* x, double* y) {
  // Needs at least two whitespace-separated float tokens.
  char buf[256];
  if (len >= sizeof(buf)) len = sizeof(buf) - 1;
  std::memcpy(buf, line, len);
  buf[len] = 0;
  char* end1 = nullptr;
  double a = std::strtod(buf, &end1);
  if (end1 == buf) return false;
  // first token must be fully numeric (reject "12abc")
  if (*end1 && !std::isspace(static_cast<unsigned char>(*end1))) return false;
  char* end2 = nullptr;
  double b = std::strtod(end1, &end2);
  if (end2 == end1) return false;
  if (*end2 && !std::isspace(static_cast<unsigned char>(*end2))) {
    // second token has trailing garbage -> non-coordinate line
    return false;
  }
  *x = a;
  *y = b;
  return true;
}

bool token_count_ge2(const char* line, size_t len) {
  int tokens = 0;
  bool in_tok = false;
  for (size_t i = 0; i < len; ++i) {
    bool ws = std::isspace(static_cast<unsigned char>(line[i]));
    if (!ws && !in_tok) {
      ++tokens;
      in_tok = true;
    } else if (ws) {
      in_tok = false;
    }
  }
  return tokens >= 2;
}

}  // namespace

extern "C" {

// Flags reported back to Python (bitmask), which rebuilds the exact
// human-readable fixes strings of the reference contract.
enum FixFlags : int32_t {
  FIX_LEDNICER = 1,
  FIX_LE_DEDUP = 2,
  FIX_WINDING = 4,
};

// Parse .dat text. Returns number of output points (<= max_out), or,
// when fewer than 10 valid points were found, -(n_valid + 1) so the
// caller can reproduce the reference's exact error message.
// out_xy: interleaved x,y pairs. counters: [skipped_non_coord,
// skipped_out_of_range, flags, n_upper, n_lower] (section sizes are only
// meaningful when FIX_LEDNICER is set; they feed the byte-identical fix
// message).
int32_t parse_dat(const char* text, int64_t text_len, double* out_xy,
                  int32_t max_out, int32_t* counters) {
  std::vector<Pt> pts;
  pts.reserve(512);
  int32_t skipped_non_coord = 0;
  int32_t skipped_range = 0;

  const char* p = text;
  const char* end = text + text_len;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    size_t len = nl ? static_cast<size_t>(nl - p)
                    : static_cast<size_t>(end - p);
    // strip \r and surrounding whitespace
    const char* s = p;
    size_t L = len;
    while (L && std::isspace(static_cast<unsigned char>(s[0]))) {
      ++s;
      --L;
    }
    while (L && std::isspace(static_cast<unsigned char>(s[L - 1]))) --L;
    if (L) {
      if (!token_count_ge2(s, L)) {
        ++skipped_non_coord;
      } else {
        double x, y;
        if (!parse_pair(s, L, &x, &y)) {
          ++skipped_non_coord;
        } else if (x >= -0.5 && x <= 1.5 && y >= -1.0 && y <= 1.0) {
          pts.push_back({x, y});
        } else {
          ++skipped_range;
        }
      }
    }
    p = nl ? nl + 1 : end;
  }

  counters[0] = skipped_non_coord;
  counters[1] = skipped_range;
  counters[2] = 0;
  counters[3] = 0;
  counters[4] = 0;

  if (pts.size() < 10) return -(static_cast<int32_t>(pts.size()) + 1);

  // detect_and_merge_sections semantics (reference main.py:116-180).
  int section_break = -1;
  for (size_t i = 1; i < pts.size(); ++i) {
    if (pts[i].x < 0.01 && pts[i - 1].x > 0.5) {
      section_break = static_cast<int>(i);
      break;
    }
  }

  std::vector<Pt> merged;
  if (section_break >= 0) {
    counters[2] |= FIX_LEDNICER;
    counters[3] = section_break;
    counters[4] = static_cast<int32_t>(pts.size()) - section_break;
    std::vector<Pt> upper(pts.begin(), pts.begin() + section_break);
    std::vector<Pt> lower(pts.begin() + section_break, pts.end());
    if (!upper.empty() && upper.front().x > upper.back().x) {
      std::reverse(upper.begin(), upper.end());
    }
    std::reverse(upper.begin(), upper.end());  // to TE->LE
    if (!lower.empty() && lower.front().x > lower.back().x) {
      std::reverse(lower.begin(), lower.end());
    }
    if (!lower.empty() && std::fabs(lower.front().x) < 1e-3 &&
        std::fabs(lower.front().y) < 1e-3) {
      lower.erase(lower.begin());
      counters[2] |= FIX_LE_DEDUP;
    }
    merged = upper;
    merged.insert(merged.end(), lower.begin(), lower.end());
  } else {
    merged = pts;
    if (pts.front().x > 0.99 && pts.back().x > 0.99) {
      size_t le = 0;
      for (size_t i = 1; i < pts.size(); ++i) {
        if (pts[i].x < pts[le].x) le = i;
      }
      if (le > 0 && pts[le - 1].y <= 0.0) {
        std::reverse(merged.begin(), merged.end());
        counters[2] |= FIX_WINDING;
      }
    }
  }

  int32_t n = static_cast<int32_t>(merged.size());
  if (n > max_out) n = max_out;
  for (int32_t i = 0; i < n; ++i) {
    out_xy[2 * i] = merged[i].x;
    out_xy[2 * i + 1] = merged[i].y;
  }
  return n;
}

// Scanline-rasterise a closed polyline (np points) onto an ny x nx grid
// covering [dx0,dx1] x [dy0,dy1]; writes 0/1 float mask (row-major,
// row 0 = ymin).
void raster_mask(const double* xp, const double* yp, int32_t np,
                 int32_t nx, int32_t ny, double dx0, double dx1, double dy0,
                 double dy1, float* mask) {
  std::memset(mask, 0, sizeof(float) * static_cast<size_t>(nx) * ny);
  std::vector<double> xs;
  xs.reserve(16);
  for (int32_t iy = 0; iy < ny; ++iy) {
    double wy = dy0 + (iy + 0.5) / ny * (dy1 - dy0);
    xs.clear();
    for (int32_t i = 0; i + 1 < np; ++i) {
      double y1 = yp[i], y2 = yp[i + 1];
      if ((y1 > wy) != (y2 > wy)) {
        xs.push_back(xp[i] + (xp[i + 1] - xp[i]) * (wy - y1) / (y2 - y1));
      }
    }
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      int32_t ix0 = static_cast<int32_t>(
          std::ceil((xs[k] - dx0) / (dx1 - dx0) * nx));
      int32_t ix1 = static_cast<int32_t>(
          std::floor((xs[k + 1] - dx0) / (dx1 - dx0) * nx));
      if (ix0 < 0) ix0 = 0;
      if (ix1 > nx - 1) ix1 = nx - 1;
      for (int32_t ix = ix0; ix <= ix1; ++ix) {
        mask[static_cast<size_t>(iy) * nx + ix] = 1.0f;
      }
    }
  }
}

}  // extern "C"
