// icp_nn: the nearest map point of each ICP query, within the query's
// 27-voxel neighbourhood.
//
// Replaces the JAX package's slam/jax_icp.py _chunked_nn with voxel_size
// set: there it is an (N, 8192) broadcast-reduce a chunk that XLA fuses,
// so the block of distances never reaches device memory; it has no Pallas
// kernel. This kernel is its counterpart: the distances live in registers.
//
// For query s_i (N x 3 f32) it returns best_d2[i] and best_idx[i] over the
// map points m_j (M x 3 f32) with map_valid[j] whose voxel is within
// Chebyshev distance 1 of the query's:
//   voxel(p) = floor(p / voxel_size), IEEE division, held as int32 (exact
//   while |p / voxel_size| < 2^24), computed once a point as it is staged;
//   d2 = ((dx * dx) + (dy * dy)) + (dz * dz), dx = s - m, every operation
//   an explicit __f*_rn (never contracted; the build passes --fmad=false);
//   ties go to the lowest index; with no candidate d2 = +inf and idx = 0.
//
// Bound: operations. N * M pairs of 17 operations (8 for d2, 9 for the
// voxel test) against N * 12 + M * 13 + N * 12 bytes. Design, simple
// first: a block holds 512 queries in registers (QPT = 4 a thread, so each
// map point read from shared memory serves four pairs) and walks one slice
// of the map, staged a tile of 128 points at a time through shared memory
// as (x, y, z) and (vx, vy, vz) with 16-byte broadcast reads. The map is cut
// into as many slices as fill the card (N = 2-8 k queries give only 4-16
// query blocks for 132 SMs). Each block keeps its best (d2, idx) a query
// and merges it with one 64-bit atomicMin on (float_bits(d2) << 32) | idx:
// d2 >= 0, so its bits order as unsigned integers, the smaller index wins
// a tie, and the merge is deterministic. A first kernel writes the empty
// key (+inf, 0) and a last one splits the keys into the two outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;                 // threads a block = tile size
constexpr int QPT = 4;                       // queries a thread
constexpr int QPB = THREADS * QPT;           // queries a block
constexpr int FAR = 1 << 30;                 // voxel of a point never near
constexpr unsigned long long EMPTY = 0x7f80000000000000ull;   // (+inf, 0)

__device__ __forceinline__ int voxel(float p, float v) {
    return __float2int_rd(__fdiv_rn(p, v));  // floor, saturating
}

__global__ void icp_nn_init(unsigned long long* __restrict__ keys, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) keys[i] = EMPTY;
}

__global__ void __launch_bounds__(THREADS)
icp_nn_search(const float* __restrict__ src, int n,
              const float* __restrict__ map, const uint8_t* __restrict__ valid,
              int m, int slice, float v,
              unsigned long long* __restrict__ keys) {
    __shared__ float4 tile_p[THREADS];
    __shared__ int4 tile_v[THREADS];

    float qx[QPT], qy[QPT], qz[QPT], best[QPT];
    int vx[QPT], vy[QPT], vz[QPT], arg[QPT];
    const int q0 = blockIdx.x * QPB + threadIdx.x;
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
        const int q = q0 + k * THREADS;
        const int qc = q < n ? q : n - 1;    // a copy of a real query
        qx[k] = src[3 * qc];
        qy[k] = src[3 * qc + 1];
        qz[k] = src[3 * qc + 2];
        vx[k] = voxel(qx[k], v);
        vy[k] = voxel(qy[k], v);
        vz[k] = voxel(qz[k], v);
        best[k] = __int_as_float(0x7f800000);
        arg[k] = 0;
    }

    const int m0 = blockIdx.y * slice;
    const int m1 = min(m, m0 + slice);
    for (int base = m0; base < m1; base += THREADS) {
        const int j = base + threadIdx.x;
        float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
        int4 pv = make_int4(FAR, FAR, FAR, 0);
        if (j < m1 && (valid == nullptr || valid[j])) {
            p.x = map[3 * j];
            p.y = map[3 * j + 1];
            p.z = map[3 * j + 2];
            pv = make_int4(voxel(p.x, v), voxel(p.y, v), voxel(p.z, v), 0);
        }
        __syncthreads();                     // the last tile is read
        tile_p[threadIdx.x] = p;
        tile_v[threadIdx.x] = pv;
        __syncthreads();
        const int len = min(THREADS, m1 - base);
        for (int t = 0; t < len; ++t) {
            const float4 mp = tile_p[t];
            const int4 mv = tile_v[t];
#pragma unroll
            for (int k = 0; k < QPT; ++k) {
                const float dx = __fsub_rn(qx[k], mp.x);
                const float dy = __fsub_rn(qy[k], mp.y);
                const float dz = __fsub_rn(qz[k], mp.z);
                const float d2 = __fadd_rn(
                    __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                    __fmul_rn(dz, dz));
                // |a - b| <= 1  <=>  (unsigned)(a - b + 1) <= 2
                // (in unsigned arithmetic, which wraps where int would not)
                const bool near =
                    (unsigned)vx[k] - (unsigned)mv.x + 1u <= 2u &&
                    (unsigned)vy[k] - (unsigned)mv.y + 1u <= 2u &&
                    (unsigned)vz[k] - (unsigned)mv.z + 1u <= 2u;
                if (near && d2 < best[k]) {  // strict: the lower index stays
                    best[k] = d2;
                    arg[k] = base + t;
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
        const int q = q0 + k * THREADS;
        if (q < n && best[k] != __int_as_float(0x7f800000)) {
            const unsigned long long key =
                ((unsigned long long)__float_as_uint(best[k]) << 32) |
                (unsigned)arg[k];
            atomicMin(keys + q, key);
        }
    }
}

__global__ void icp_nn_split(const unsigned long long* __restrict__ keys,
                             int n, float* __restrict__ best_d2,
                             long long* __restrict__ best_idx) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) {
        const unsigned long long key = keys[i];
        best_d2[i] = __uint_as_float((unsigned)(key >> 32));
        best_idx[i] = (long long)(key & 0xffffffffull);
    }
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream`; returns the cudaError_t of the
// first refused launch (0 = ok). `valid` may be null (every point valid);
// `keys` is scratch of n 64-bit words; `sms` is the card's SM count.
int icp_nn_launch(const void* src, int n, const void* map, const void* valid,
                  int m, float voxel_size, void* keys, void* best_d2,
                  void* best_idx, int sms, void* stream) {
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    auto k = (unsigned long long*)keys;
    const int eb = 256;
    icp_nn_init<<<(n + eb - 1) / eb, eb, 0, s>>>(k, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (m > 0) {
        // as many map slices as give about eight blocks an SM, each slice
        // a whole number of tiles
        const int qblocks = (n + QPB - 1) / QPB;
        const int tiles = (m + THREADS - 1) / THREADS;
        int slices = (8 * sms + qblocks - 1) / qblocks;
        slices = slices < 1 ? 1 : (slices > tiles ? tiles : slices);
        const int slice = ((tiles + slices - 1) / slices) * THREADS;
        dim3 grid(qblocks, (m + slice - 1) / slice);
        icp_nn_search<<<grid, THREADS, 0, s>>>(
            (const float*)src, n, (const float*)map, (const uint8_t*)valid,
            m, slice, voxel_size, k);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    icp_nn_split<<<(n + eb - 1) / eb, eb, 0, s>>>(k, n, (float*)best_d2,
                                                 (long long*)best_idx);
    return (int)cudaGetLastError();
}

const char* icp_nn_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
