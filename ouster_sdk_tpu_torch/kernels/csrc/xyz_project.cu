// xyz_project: a range image projected to float64 XYZ on the card, bit for
// bit the host LUT's product (ops/xyzlut.XYZLut.__call__, numpy):
//
//   xyz[y, x, c] = r == 0 ? 0.0 : r * direction[y, x, c] + offset[y, x, c]
//
// with r = (double)range[y, x], exact for every uint32. Each product and sum
// is one __d*_rn, rounded on its own as numpy rounds them (never contracted
// to an fma; the build passes --fmad=false), so the card's XYZ is the host's
// bits. Used by XYZLutFactory for the scans the device engine decoded on the
// card (ouster_sdk_tpu_torch/__init__.py).
//
// Replaces no TPU kernel: the JAX package projects such scans on the host
// in numpy. Its float32 device projections (the planar kernel's double-
// single product) are within half an f32 ulp of this, not equal to it, so
// they cannot stand in for XYZLut's float64.
//
// Bound: the bytes. Read: RANGE (4 B a pixel) and the LUT (48 B: direction,
// then offset, each (h, w, 3) f64); written: XYZ (24 B). At 128 x 2048,
// 19.9 MB: ~5.9 us over 3.35 TB/s. Two f64 operations a double are far
// below the card's f64 rate. One thread a double of the output: the LUT's
// reads and XYZ's writes are neighbouring threads on neighbouring
// addresses, and the three threads of a pixel read its range once from
// the same 4 bytes (a cached broadcast).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
xyz_project(const uint32_t* __restrict__ range,
            const double* __restrict__ lut, long long n,
            double* __restrict__ out) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const uint32_t r = range[i / 3];
    out[i] = r == 0 ? 0.0
        : __dadd_rn(__dmul_rn((double)r, lut[i]), lut[n + i]);
}

}  // namespace

extern "C" {

// range (h x w u32), lut (2 x h x w x 3 f64: direction, then offset), out
// (h x w x 3 f64); n_pixels = h * w.
int xyz_project_launch(const uint32_t* range, const double* lut,
                       long long n_pixels, double* out,
                       cudaStream_t stream) {
    if (n_pixels <= 0) return 0;
    const long long n = 3 * n_pixels;
    const long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    xyz_project<<<(unsigned)blocks, THREADS, 0, stream>>>(range, lut, n,
                                                          out);
    return (int)cudaGetLastError();
}

const char* xyz_project_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
