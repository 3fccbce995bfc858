// Native host runtime for hifi_fusion_tpu: sensor-frame decoding and fast
// point-cloud export. These are the components the reference implements
// natively on the host side (survey §2 C5 decode, C16 export I/O); the TPU
// compute path stays in JAX/XLA — this library only feeds and drains it.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
//
// Build: `make` in this directory (g++ -O3 -fopenmp -shared).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Decode a PointCloud2-style interleaved binary blob into planar float32
// xyz + rgb arrays. Equivalent of the reference's manual per-point memcpy
// decode (pointCloud2ToPclXYZRGBOMP, FUSION.cpp:182-216), vectorizable and
// parallel over all cores instead of a fixed 2 threads.
//
// blue_shift_bug: when nonzero, reproduce the reference's packed-RGB blue
// channel extraction `(rgb >> 1) & 0xff` (splitRGBData, FUSION.cpp:170-180);
// the correct shift is 0.
void hf_decode_xyzrgb(const uint8_t* data, int64_t n_points,
                      int64_t point_step, int64_t off_x, int64_t off_y,
                      int64_t off_z, int64_t off_rgb, int blue_shift_bug,
                      float* out_xyz, float* out_rgb) {
  const int blue_shift = blue_shift_bug ? 1 : 0;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_points; ++i) {
    const uint8_t* p = data + i * point_step;
    float x, y, z, rgbf;
    std::memcpy(&x, p + off_x, 4);
    std::memcpy(&y, p + off_y, 4);
    std::memcpy(&z, p + off_z, 4);
    out_xyz[3 * i + 0] = x;
    out_xyz[3 * i + 1] = y;
    out_xyz[3 * i + 2] = z;
    if (off_rgb >= 0) {
      std::memcpy(&rgbf, p + off_rgb, 4);
      uint32_t packed;
      std::memcpy(&packed, &rgbf, 4);
      out_rgb[3 * i + 0] = (float)((packed >> 16) & 0xff);
      out_rgb[3 * i + 1] = (float)((packed >> 8) & 0xff);
      out_rgb[3 * i + 2] = (float)((packed >> blue_shift) & 0xff);
    } else {
      out_rgb[3 * i + 0] = 0.f;
      out_rgb[3 * i + 1] = 0.f;
      out_rgb[3 * i + 2] = 0.f;
    }
  }
}

// Camera-frame z-clip + validity compaction on the host (optional pre-mask
// so fewer dead lanes ride to the device). Returns number kept.
int64_t hf_zclip_compact(const float* xyz, const float* rgb, int64_t n,
                         float zmin, float zmax, float* out_xyz,
                         float* out_rgb) {
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float z = xyz[3 * i + 2];
    if (z > zmin && z < zmax) {
      out_xyz[3 * m + 0] = xyz[3 * i + 0];
      out_xyz[3 * m + 1] = xyz[3 * i + 1];
      out_xyz[3 * m + 2] = z;
      out_rgb[3 * m + 0] = rgb[3 * i + 0];
      out_rgb[3 * m + 1] = rgb[3 * i + 1];
      out_rgb[3 * m + 2] = rgb[3 * i + 2];
      ++m;
    }
  }
  return m;
}

// Fast ASCII table writer: one %.9g-formatted row per point, buffered.
// Replaces pcl::io::savePCDFileASCII (OccupancyGrid.hpp:485) on the export
// path; the Python caller supplies the fully formed header.
int hf_write_ascii_table(const char* path, const char* header,
                         const float* cols, int64_t n, int64_t k,
                         int append) {
  FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  if (header && header[0]) std::fputs(header, f);
  std::vector<char> buf;
  buf.reserve(1 << 22);
  char tmp[64];
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < k; ++j) {
      int len = std::snprintf(tmp, sizeof(tmp), j + 1 < k ? "%.9g " : "%.9g\n",
                              (double)cols[i * k + j]);
      buf.insert(buf.end(), tmp, tmp + len);
    }
    if (buf.size() > (1 << 21)) {
      std::fwrite(buf.data(), 1, buf.size(), f);
      buf.clear();
    }
  }
  if (!buf.empty()) std::fwrite(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return 0;
}

// Metadata CSV writer: Id,sdx,sdy,sdz,mean dist,sd dist,count rows
// (format of OccupancyGrid.hpp:478). Takes float64 so output is
// byte-identical to the NumPy fallback (the format oracle, io/pcd.py).
int hf_write_metadata_csv(const char* path, const char* header,
                          const double* cols5, const int64_t* count,
                          int64_t n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fputs(header, f);
  std::fputs("\n", f);
  std::vector<char> buf;
  buf.reserve(1 << 22);
  char tmp[256];
  for (int64_t i = 0; i < n; ++i) {
    int len = std::snprintf(
        tmp, sizeof(tmp), "%lld,%.6g,%.6g,%.6g,%.6g,%.6g,%lld\n",
        (long long)i, cols5[i * 5 + 0], cols5[i * 5 + 1],
        cols5[i * 5 + 2], cols5[i * 5 + 3],
        cols5[i * 5 + 4], (long long)count[i]);
    buf.insert(buf.end(), tmp, tmp + len);
    if (buf.size() > (1 << 21)) {
      std::fwrite(buf.data(), 1, buf.size(), f);
      buf.clear();
    }
  }
  if (!buf.empty()) std::fwrite(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return 0;
}

}  // extern "C"
