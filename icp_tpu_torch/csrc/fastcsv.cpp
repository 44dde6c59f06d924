// Fast lidar CSV parser: native host runtime of icp_tpu_torch.
//
// The per-line numpy parser (services/lidar.py, parse_lidar_line) costs
// host time on the file-driven path, which is host-bound, so whole files
// are parsed here in one pass: strtod over one buffer, no allocation per
// value, padding (0,0,0) triples dropped as the line parser drops them.
// A line with no leading number is skipped, and a line ends at its first
// incomplete triple.
//
// C ABI (ctypes-friendly):
//   lidar_parse(path) -> opaque handle + accessors, caller frees.
//
// Built at first use by icp_tpu_torch/runtime/loader.py
// (c++ -O3 -fPIC -shared -std=c++17).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct LidarData {
  std::vector<int64_t> timestamps;   // per scan
  std::vector<int64_t> offsets;      // per scan start into points, +1 tail
  std::vector<float> points;         // x,y,z interleaved
};

// Minimal fast float parser (decimal, optional sign/exponent). Returns
// pointer past the parsed number, or nullptr if no number found.
const char* parse_double(const char* p, const char* end, double* out) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == ';' || *p == ','))
    ++p;
  if (p >= end) return nullptr;
  char* q = nullptr;
  double v = strtod(p, &q);
  if (q == p) return nullptr;
  *out = v;
  return q;
}

}  // namespace

extern "C" {

// Parses the whole file. Returns 0 on success.
int lidar_parse(const char* path, void** handle_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (size > 0 && fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return 2;
  }
  fclose(f);
  buf[size] = '\0';

  auto* data = new LidarData();
  data->points.reserve(1 << 20);

  const char* p = buf.data();
  const char* end = buf.data() + size;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    double ts;
    const char* q = parse_double(p, line_end, &ts);
    if (q) {
      data->timestamps.push_back(static_cast<int64_t>(ts));
      data->offsets.push_back(
          static_cast<int64_t>(data->points.size() / 3));
      double xyz[3];
      while (true) {
        const char* r = q;
        bool ok = true;
        for (int k = 0; k < 3; ++k) {
          r = parse_double(r, line_end, &xyz[k]);
          if (!r) { ok = false; break; }
        }
        if (!ok) break;
        q = r;
        // drop all-zero padding triples (reference lidar_service.py:17-18)
        if (xyz[0] != 0.0 || xyz[1] != 0.0 || xyz[2] != 0.0) {
          data->points.push_back(static_cast<float>(xyz[0]));
          data->points.push_back(static_cast<float>(xyz[1]));
          data->points.push_back(static_cast<float>(xyz[2]));
        }
      }
    }
    p = (line_end < end) ? line_end + 1 : end;
  }
  data->offsets.push_back(static_cast<int64_t>(data->points.size() / 3));
  *handle_out = data;
  return 0;
}

int64_t lidar_num_scans(void* handle) {
  return static_cast<LidarData*>(handle)->timestamps.size();
}

const int64_t* lidar_timestamps(void* handle) {
  return static_cast<LidarData*>(handle)->timestamps.data();
}

const int64_t* lidar_offsets(void* handle) {
  return static_cast<LidarData*>(handle)->offsets.data();
}

const float* lidar_points(void* handle) {
  return static_cast<LidarData*>(handle)->points.data();
}

int64_t lidar_num_points(void* handle) {
  return static_cast<LidarData*>(handle)->points.size() / 3;
}

void lidar_free(void* handle) { delete static_cast<LidarData*>(handle); }

}  // extern "C"
