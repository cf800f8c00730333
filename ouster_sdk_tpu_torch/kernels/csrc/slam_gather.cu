// slam_gather: the frame the SLAM engine registers, gathered on the card in
// float64 for its device backend (slam/engine.py SlamEngine._gather_frame).
//
// Replaces no TPU kernel: the JAX package gathers on the host (numpy: the
// float64 XYZLut, the validity mask, two einsums and a boolean index).
// This source is that gather for one sensor's scan, as
// kernels/slam_gather.py's slam_gather_reference computes it:
//
//   valid = r > 0 && (status[w] & 1) && lo < r_m && r_m < hi,
//           r_m = (double)r * 0.001                        (the host's mask)
//   xyz   = r * dir + off                          (XYZLut, per component)
//   rel   = mid_inv @ pose[w]     (((m0 P0 + m1 P1) + m2 P2) + m3 P3)
//   world_i = ((rel_i0 x + rel_i1 y) + rel_i2 z) + rel_i3
//
// every operation an explicit __d*_rn (never contracted; the build passes
// --fmad=false), so the mask and the projection are the host's bits, and
// the points the plain version's. The valid points are written to
// out (N x 3 f64) in row-major (h, w) order, numpy's world[valid]: KISS's
// downsample keeps the first point of each voxel, so the order is part of
// the result.
//
// The compaction: per-tile counts, then a scan, then the write; three
// kernels on one stream, no host round trip between them. A tile is one
// warp: 32 columns of one row, so a ballot gives both the tile's count and
// each lane's rank in it, and the tiles' row-major order is the points'
// order. One block is 8 such rows of 32 columns; the write's block makes
// the 32 columns' rel once, in shared memory. The scan is one block over
// the H x ceil(W / 32) tile counts (8192 at 128 x 2048), which also writes
// N. Chosen over a single pass with decoupled look-back: the counts are a
// few kilobytes, a second read of RANGE (1 MB at 128 x 2048) costs less
// than a microsecond, and the three kernels need no inter-block
// protocol; one pass would save two launches of a few microseconds on a
// call that copies megabytes back.
//
// Bound: the bytes. Read: RANGE (4 H W), status (4 W), poses (128 W), the
// planar LUT (48 H W, direction then offset, neighbouring threads on
// neighbouring addresses); written: 24 N. At 128 x 2048, about 20 MB: ~6 us
// over 3.35 TB/s. About 30 f64 operations a pixel are far below the card's
// f64 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;      // columns of a tile: one warp
constexpr int ROWS = 8;         // rows of a block: 8 warps
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool valid_at(const uint32_t* __restrict__ range,
                                         const uint32_t* __restrict__ status,
                                         int h, int w, int y, int x,
                                         double lo, double hi) {
    if (y >= h || x >= w) return false;
    const uint32_t r = range[(size_t)y * w + x];
    if (r == 0 || !(status[x] & 1u)) return false;
    const double r_m = __dmul_rn((double)r, 0.001);
    return r_m > lo && r_m < hi;
}

// tiles[y * tiles_w + t] = the valid pixels of row y, columns 32 t ..
__global__ void __launch_bounds__(TILE_W * ROWS)
count_tiles(const uint32_t* __restrict__ range,
            const uint32_t* __restrict__ status, int h, int w, int tiles_w,
            double lo, double hi, int* __restrict__ tiles) {
    const int x = blockIdx.x * TILE_W + threadIdx.x;
    const int y = blockIdx.y * ROWS + threadIdx.y;
    const unsigned b = __ballot_sync(FULL,
                                     valid_at(range, status, h, w, y, x, lo,
                                              hi));
    if (threadIdx.x == 0 && y < h) tiles[y * tiles_w + blockIdx.x] = __popc(b);
}

// tiles[i] = sum of the counts before i (in place); count[0] = all of them
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles(int* __restrict__ tiles, int n, int* __restrict__ count) {
    __shared__ int warp_sums[SCAN_THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int carry = 0;
    for (int base = 0; base < n; base += SCAN_THREADS) {
        const int i = base + threadIdx.x;
        const int v = i < n ? tiles[i] : 0;
        int x = v;                              // inclusive, in the warp
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) warp_sums[warp] = x;
        __syncthreads();
        if (warp == 0) {                        // inclusive, over the warps
            int s = warp_sums[lane];
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(FULL, s, d);
                if (lane >= d) s += y;
            }
            warp_sums[lane] = s;
        }
        __syncthreads();
        if (i < n) tiles[i] = carry + (warp ? warp_sums[warp - 1] : 0) + x - v;
        carry += warp_sums[SCAN_THREADS / 32 - 1];
        __syncthreads();                        // before the sums are reused
    }
    if (threadIdx.x == 0) count[0] = carry;
}

__global__ void __launch_bounds__(TILE_W * ROWS)
write_points(const uint32_t* __restrict__ range,
             const uint32_t* __restrict__ status,
             const double* __restrict__ poses,
             const double* __restrict__ mid_inv,
             const double* __restrict__ lut, int h, int w, int tiles_w,
             double lo, double hi, const int* __restrict__ offsets,
             double* __restrict__ out) {
    // rel's top three rows for the block's 32 columns, [entry][column]
    __shared__ double rel[12][TILE_W];
    const int x0 = blockIdx.x * TILE_W;
    for (int e = threadIdx.y * TILE_W + threadIdx.x; e < 12 * TILE_W;
         e += TILE_W * ROWS) {
        const int k = e / TILE_W, c = e % TILE_W;
        const int i = k >> 2, j = k & 3;
        if (x0 + c < w) {
            const double* P = poses + (size_t)(x0 + c) * 16;
            const double* m = mid_inv + i * 4;
            double acc = __dmul_rn(m[0], P[j]);
            acc = __dadd_rn(acc, __dmul_rn(m[1], P[4 + j]));
            acc = __dadd_rn(acc, __dmul_rn(m[2], P[8 + j]));
            acc = __dadd_rn(acc, __dmul_rn(m[3], P[12 + j]));
            rel[k][c] = acc;
        }
    }
    __syncthreads();
    const int x = x0 + threadIdx.x;
    const int y = blockIdx.y * ROWS + threadIdx.y;
    const bool ok = valid_at(range, status, h, w, y, x, lo, hi);
    const unsigned b = __ballot_sync(FULL, ok);
    if (!ok) return;
    const size_t at = (size_t)offsets[y * tiles_w + blockIdx.x]
        + __popc(b & ((1u << threadIdx.x) - 1u));
    const size_t p = (size_t)y * w + x, plane = (size_t)h * w;
    const double r = (double)range[p];
    double v[3];
    for (int c = 0; c < 3; ++c)
        v[c] = __dadd_rn(__dmul_rn(r, lut[c * plane + p]),
                         lut[(3 + c) * plane + p]);
    const int col = threadIdx.x;
    for (int i = 0; i < 3; ++i) {
        double acc = __dmul_rn(rel[4 * i][col], v[0]);
        acc = __dadd_rn(acc, __dmul_rn(rel[4 * i + 1][col], v[1]));
        acc = __dadd_rn(acc, __dmul_rn(rel[4 * i + 2][col], v[2]));
        out[at * 3 + i] = __dadd_rn(acc, rel[4 * i + 3][col]);
    }
}

}  // namespace

extern "C" {

// One sensor's scan: range (h x w u32), status (w u32), poses (w x 4 x 4
// f64), mid_inv (4 x 4 f64), lut (6 x h x w f64: direction x, y, z, then
// offset x, y, z); tiles is scratch of h * ceil(w / 32) ints; out (h w x 3
// f64) gets the valid points in its first count[0] rows.
int slam_gather_launch(const uint32_t* range, const uint32_t* status,
                       const double* poses, const double* mid_inv,
                       const double* lut, int h, int w, double lo, double hi,
                       int* tiles, double* out, int* count,
                       cudaStream_t stream) {
    if (h <= 0 || w <= 0)
        return (int)cudaMemsetAsync(count, 0, sizeof(int), stream);
    const int tiles_w = (w + TILE_W - 1) / TILE_W;
    const dim3 grid(tiles_w, (h + ROWS - 1) / ROWS), block(TILE_W, ROWS);
    count_tiles<<<grid, block, 0, stream>>>(range, status, h, w, tiles_w, lo,
                                            hi, tiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan_tiles<<<1, SCAN_THREADS, 0, stream>>>(tiles, h * tiles_w, count);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    write_points<<<grid, block, 0, stream>>>(range, status, poses, mid_inv,
                                             lut, h, w, tiles_w, lo, hi,
                                             tiles, out);
    return (int)cudaGetLastError();
}

const char* slam_gather_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
