// Native host-side point-cloud preprocessing of the PyTorch port: the
// port's own copy of the JAX package's sfa3d_tpu/native/preproc.cpp.
//
// The reference does this work in Python/numpy inside DataLoader workers
// (get_filtered_lidar, kitti_data_utils.py:228-251: six boolean temporaries
// plus a fancy-index copy per scan). Here the range filter + fixed-shape pad
// is ONE branch-predictable pass over the scan, and the fused reader streams
// the .bin file through a per-thread buffer of 4 MiB, so a scan is read in
// one read(2) (a system call can cost tens of microseconds under a
// virtualised kernel, and a 64 KB buffer took 30 of them a KITTI scan) and
// never copied whole. The loader's threads call these through ctypes,
// which releases the GIL, so reads run in parallel with each other and with
// the device step.
//
// Semantics are kept exactly equal to ops/bev.py::_filter_and_pad_numpy:
//   keep points with  minX <= x <= maxX, minY <= y <= maxY, minZ <= z <= maxZ
//   (NaN coordinates fail every comparison and drop out), in scan order,
//   truncated at max_points; output zero-padded, valid mask marks kept rows.
//
// Build: g++ -O3 -shared -fPIC (driven by sfa3d_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Filter + pad an in-memory (n, 4) float32 scan.
// bound6 = {minX, maxX, minY, maxY, minZ, maxZ}.
// out: (max_points, 4) float32 (caller-zeroed NOT required; fully written),
// valid: (max_points,) uint8. Returns the TOTAL number of in-range points
// (may exceed max_points: only the first max_points are written, and the
// caller warns on kept > max_points — truncation must never be silent).
// Branchless filter-compaction core: every candidate row is written to the
// current output slot unconditionally and the cursor advances by the 0/1
// mask — in-range tests on real scans are data-dependent, so a branchy
// short-circuit mispredicts constantly (measured 4x slower than this).
static inline int64_t filter_rows(const float* pts, int64_t n,
                                  const float* b, int64_t max_points,
                                  int64_t kept, float* out, uint8_t* valid) {
    const float min_x = b[0], max_x = b[1];
    const float min_y = b[2], max_y = b[3];
    const float min_z = b[4], max_z = b[5];
    for (int64_t i = 0; i < n; ++i) {
        const float* p = pts + 4 * i;
        // NaN compares false -> excluded, matching the numpy path
        int m = (p[0] >= min_x) & (p[0] <= max_x) & (p[1] >= min_y) &
                (p[1] <= max_y) & (p[2] >= min_z) & (p[2] <= max_z);
        if (kept >= max_points) {  // overflow: count-only (predictable branch)
            for (; i < n; ++i) {
                p = pts + 4 * i;
                kept += (p[0] >= min_x) & (p[0] <= max_x) & (p[1] >= min_y) &
                        (p[1] <= max_y) & (p[2] >= min_z) & (p[2] <= max_z);
            }
            break;
        }
        float* o = out + 4 * kept;
        o[0] = p[0]; o[1] = p[1]; o[2] = p[2]; o[3] = p[3];
        valid[kept] = 1;
        kept += m;
    }
    return kept;
}

static inline void zero_tail(int64_t kept, int64_t max_points, float* out,
                             uint8_t* valid) {
    if (kept > max_points) kept = max_points;  // kept counts overflow too
    std::memset(out + 4 * kept, 0, sizeof(float) * 4 * (size_t)(max_points - kept));
    std::memset(valid + kept, 0, (size_t)(max_points - kept));
}

int64_t sfa_filter_pad(const float* pts, int64_t n, const float* bound6,
                       int64_t max_points, float* out, uint8_t* valid) {
    int64_t kept = filter_rows(pts, n, bound6, max_points, 0, out, valid);
    zero_tail(kept, max_points, out, valid);
    return kept;
}

// Fused read + filter + pad of a KITTI velodyne .bin ((N, 4) float32 on
// disk). Streams through the calling thread's CHUNK_POINTS buffer (the
// whole of a KITTI scan at once); the cloud is filtered from it, not copied.
// Returns kept count, or -1 if the file cannot be opened/read.
static const size_t CHUNK_POINTS = 262144;  // 4 MiB of (x, y, z, r) float32

int64_t sfa_read_filter_pad(const char* path, const float* bound6,
                            int64_t max_points, float* out, uint8_t* valid) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::setvbuf(f, nullptr, _IONBF, 0);  // reads go straight into buf
    static thread_local std::vector<float> chunk(CHUNK_POINTS * 4);
    float* buf = chunk.data();
    int64_t kept = 0;
    size_t got;
    size_t carry = 0;  // floats carried over when a read splits a point
    while ((got = std::fread(buf + carry, sizeof(float),
                             CHUNK_POINTS * 4 - carry, f)) > 0) {
        size_t total = carry + got;
        size_t n_pts = total / 4;
        kept = filter_rows(buf, (int64_t)n_pts, bound6, max_points, kept, out,
                           valid);
        carry = total - 4 * n_pts;
        if (carry) std::memmove(buf, buf + 4 * n_pts, carry * sizeof(float));
        // no early break on a full buffer: the stream keeps getting scanned
        // so the returned count covers overflow (caller warns on truncation)
    }
    // fread returning 0 is EOF *or* error: a mid-file I/O error would
    // otherwise yield a truncated-but-valid-looking scan (silent point
    // loss). Report -1 and the caller raises.
    int err = std::ferror(f);
    std::fclose(f);
    if (err) return -1;
    zero_tail(kept, max_points, out, valid);
    return kept;
}

}  // extern "C"
