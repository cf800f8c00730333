// voxel_map: KISS-ICP's admission rule for the local map that DeviceICP
// keeps on the card (slam/device_map.py), one thread a touched voxel.
//
// Replaces no TPU kernel: the JAX package keeps the map on the host
// (slam/kiss_icp.py VoxelHashMap.add_points, a Python loop over the
// touched voxels); this kernel is that loop's body, run for every touched
// voxel at once, as kernels/voxel_map.py's voxel_admit_reference does it.
//
// The candidates of one call are sorted by voxel key (stable: a voxel's
// candidates keep scan order) and cut into groups, one a voxel. Group g is
// points[starts[g] .. starts[g] + sizes[g]) of (N x 3 f64), it belongs to
// map row rows[g] (< 0: no voxel, the thread returns), holding
// count[row] points in map_pts[row] (cap x 3 f64), or none where
// row >= fresh_from (a voxel this call appends). Walking the candidates in
// order, it admits a point while the voxel holds fewer than cap points and
// none of them (those admitted earlier in the call included) lies within
// the admission radius: d2 < res2 rejects, with
//   d2 = ((dx * dx) + (dy * dy)) + (dz * dz), dx = q - p,
// every operation an explicit __d*_rn (never contracted; the build passes
// --fmad=false), the host map's float64 arithmetic. It writes the voxel's
// key (keys[row] = group_keys[g]: the same key where the voxel existed),
// its new count and the number admitted (added[g]).
//
// Bound: the bytes (the candidates and the group arrays read once, each
// touched voxel's points read once, the admitted points, keys and counts
// written once) over the HBM rate, or 8 f64 operations a distance test
// over the no-FMA f64 rate; neither binds. The admission is sequential
// within a voxel, so the time is the latency of the longest chain of
// dependent tests in the call (at most sizes[g] x cap of them, up to 20 x 20
// at KISS-ICP's cap); the design spends no launch or host round trip on
// it: one launch a call, and nothing here allocates or waits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
voxel_admit(const double* __restrict__ points,
            const long long* __restrict__ starts,
            const int* __restrict__ sizes,
            const long long* __restrict__ group_keys,
            const long long* __restrict__ rows, long long groups,
            long long fresh_from, int cap, double res2,
            long long* __restrict__ keys, double* __restrict__ map_pts,
            int* __restrict__ count, int* __restrict__ added) {
    const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (g >= groups) return;
    const long long row = rows[g];
    if (row < 0) {
        added[g] = 0;
        return;
    }
    double* vox = map_pts + row * cap * 3;
    const int c0 = row >= fresh_from ? 0 : count[row];
    int c = c0;
    const double* cand = points + starts[g] * 3;
    const int n = sizes[g];
    for (int i = 0; i < n && c < cap; ++i) {
        const double qx = cand[3 * i], qy = cand[3 * i + 1],
                     qz = cand[3 * i + 2];
        bool near = false;
        for (int j = 0; j < c && !near; ++j) {
            const double dx = __dsub_rn(vox[3 * j], qx);
            const double dy = __dsub_rn(vox[3 * j + 1], qy);
            const double dz = __dsub_rn(vox[3 * j + 2], qz);
            const double d2 = __dadd_rn(
                __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)),
                __dmul_rn(dz, dz));
            near = d2 < res2;
        }
        if (!near) {
            vox[3 * c] = qx;
            vox[3 * c + 1] = qy;
            vox[3 * c + 2] = qz;
            ++c;
        }
    }
    keys[row] = group_keys[g];
    count[row] = c;
    added[g] = c - c0;
}

}  // namespace

extern "C" {

int voxel_admit_launch(const double* points, const long long* starts,
                       const int* sizes, const long long* group_keys,
                       const long long* rows, long long groups,
                       long long fresh_from, int cap, double res2,
                       long long* keys, double* map_pts, int* count,
                       int* added, cudaStream_t stream) {
    if (groups <= 0) return 0;
    const long long blocks = (groups + THREADS - 1) / THREADS;
    voxel_admit<<<(unsigned)blocks, THREADS, 0, stream>>>(
        points, starts, sizes, group_keys, rows, groups, fresh_from, cap,
        res2, keys, map_pts, count, added);
    return (int)cudaGetLastError();
}

const char* voxel_map_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
