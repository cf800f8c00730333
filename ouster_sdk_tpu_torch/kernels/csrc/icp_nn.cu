// icp_nn: the nearest map point of each ICP query, within the query's
// 27-voxel neighbourhood, through a voxel-grid index of the map.
//
// Replaces the JAX package's slam/jax_icp.py:75 _chunked_nn with
// voxel_size set: an (N, 8192) broadcast-reduce a chunk that XLA fuses
// there; it has no Pallas kernel.
//
// For query s_i (N x 3 f32) it returns best_d2[i] and best_idx[i] over the
// map points m_j (M x 3 f32) with valid[j] whose voxel is within Chebyshev
// distance 1 of the query's, as kernels/icp_nn.py's icp_nn_reference:
//   voxel(p) = floor(p / voxel_size), IEEE division, saturated to int32;
//   "within 1" is the reference's int32 |a - b| <= 1, in which the
//   difference wraps, so a voxel at a wrapped distance of 2^31 also counts
//   (|INT_MIN| is INT_MIN);
//   d2 = ((dx * dx) + (dy * dy)) + (dz * dz), dx = s - m, every operation
//   an explicit __f*_rn (never contracted; the build passes --fmad=false);
//   ties go to the lowest index; with no candidate d2 = +inf and idx = 0
//   (a candidate at d2 = +inf changes nothing).
//
// Bound: the candidate pairs, the pairs whose voxels are neighbours, at 17
// operations a pair (8 for d2, 9 for the voxel test the function implies)
// over the f32 rate; or the bytes (each point read once, each result
// written once) where the pairs are few. Design: the kernels read only
// candidate pairs. The map is fixed through a registration's Gauss-Newton
// loop, so its index is built once a registration (icp_index_launch, four
// kernels) and serves every search (icp_nn_search_launch, one kernel):
//   1. voxels: each point's int3 voxel (.w = -1 for a masked point), and
//      the hash table cleared: 2^k >= 2 M slots, so at least half stay
//      empty and every probe ends;
//   2. insert: open addressing, linear probing; a slot is claimed by
//      atomicCAS of a representative point index and a collision is
//      settled by comparing the whole voxel triple (distinct voxels never
//      alias); each point adds one to its slot's count (atomicAdd) and
//      records its slot;
//   3. runs: each occupied slot takes a run of `count` places of the packed
//      array (a warp scan of the counts, one atomicAdd a warp on a global
//      cursor): no host round trip, no library scan;
//   4. scatter: each point goes to its slot's run as (x, y, z, index bits),
//      16 bytes; the order inside a run does not matter (ties are broken by
//      the original index).
// The search gives each query a warp. Lanes 0-26 probe the 27 neighbour
// cells at once; a warp scan of their counts numbers the candidates 0..T-1,
// and the warp walks them 128 at a time, each lane finding the cells of its
// four with a five-step binary search over the lanes' running counts
// (shuffles) and issuing the four loads before it uses one: a query's
// candidates are a chain of dependent rounds, and on a map with a few dense
// cells the queries with the most candidates set the kernel's time. A
// round's loads are consecutive within a cell. Each lane keeps its best
// (d2, idx) lexicographically; a shuffle reduction gives the warp's. The
// cells at a wrapped distance of 2^31 (37 more) are visited only where a
// voxel coordinate is at least 2^30 away from 0: that of the query, or any
// of the map's (a flag the insert kernel raises). No cell size is assumed.
// Nothing here allocates: the wrapper hands every array in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;                  // index kernels
constexpr int SEARCH_WARPS = 8;               // queries a search block
constexpr int UNROLL = 4;                     // candidate loads in flight a lane
constexpr int FAR = 1 << 30;                  // |voxel| at which wrapping may pair

__device__ __forceinline__ int voxel(float p, float v) {
    return __float2int_rd(__fdiv_rn(p, v));   // floor, saturating
}

__device__ __forceinline__ bool far_out(int a) {
    return a >= FAR || a <= -FAR;
}

__device__ __forceinline__ unsigned cell_hash(unsigned x, unsigned y,
                                              unsigned z) {
    unsigned h = x * 0x9E3779B1u ^ y * 0x85EBCA77u ^ z * 0xC2B2AE3Du;
    h ^= h >> 16;
    h *= 0x7FEB352Du;
    h ^= h >> 15;
    h *= 0x846CA68Bu;
    h ^= h >> 16;
    return h;
}

// 1. voxels of the map's points; the table cleared; the flags zeroed
__global__ void icp_index_voxels(const float* __restrict__ map,
                                 const uint8_t* __restrict__ valid, int m,
                                 float v, int slots, int4* __restrict__ vox,
                                 int* __restrict__ key,
                                 int4* __restrict__ cells,
                                 int* __restrict__ meta) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        meta[0] = 0;                          // a far voxel in the map
        meta[1] = 0;                          // the runs' cursor
    }
    const int total = m > slots ? m : slots;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += gridDim.x * blockDim.x) {
        if (i < slots) {
            key[i] = -1;
            cells[i] = make_int4(0, 0, 0, 0);
        }
        if (i < m) {
            int4 c = make_int4(0, 0, 0, -1);
            if (valid == nullptr || valid[i])
                c = make_int4(voxel(map[3 * i], v), voxel(map[3 * i + 1], v),
                              voxel(map[3 * i + 2], v), 0);
            vox[i] = c;
        }
    }
}

// 2. each valid point finds or claims its voxel's slot and counts itself
__global__ void icp_index_insert(int m, unsigned mask,
                                 int4* __restrict__ vox,
                                 int* __restrict__ key,
                                 int4* __restrict__ cells,
                                 int* __restrict__ meta) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= m) return;
    const int4 c = vox[j];
    if (c.w < 0) return;
    if (far_out(c.x) || far_out(c.y) || far_out(c.z)) atomicOr(meta, 1);
    unsigned s = cell_hash(c.x, c.y, c.z) & mask;
    for (;;) {
        int k = key[s];                       // a claimed slot never changes
        if (k < 0) {
            k = atomicCAS(key + s, -1, j);
            if (k < 0) {                      // claimed: record the voxel
                int* rec = reinterpret_cast<int*>(cells + s);
                rec[0] = c.x;
                rec[1] = c.y;
                rec[2] = c.z;
                break;
            }
        }
        const int4 r = vox[k];                // written by the last kernel
        if (r.x == c.x && r.y == c.y && r.z == c.z) break;
        s = (s + 1) & mask;
    }
    atomicAdd(reinterpret_cast<int*>(cells + s) + 3, 1);
    reinterpret_cast<int*>(vox + j)[3] = (int)s;
}

// 3. each occupied slot takes its run: starts[s] = the run's end
__global__ void icp_index_runs(int slots, const int4* __restrict__ cells,
                               int* __restrict__ starts,
                               int* __restrict__ meta) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int cnt = s < slots ? cells[s].w : 0;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
    }
    const int sum = __shfl_sync(FULL, incl, 31);
    int base = 0;
    if (lane == 31 && sum > 0) base = atomicAdd(meta + 1, sum);
    base = __shfl_sync(FULL, base, 31);
    if (cnt > 0) starts[s] = base + incl;
}

// 4. each valid point into its slot's run, from the end down: afterwards
//    starts[s] is the run's first place
__global__ void icp_index_scatter(const float* __restrict__ map, int m,
                                  const int4* __restrict__ vox,
                                  int* __restrict__ starts,
                                  float4* __restrict__ points) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= m) return;
    const int4 c = vox[j];
    if (c.w < 0) return;
    const int at = atomicSub(starts + c.w, 1) - 1;
    points[at] = make_float4(map[3 * j], map[3 * j + 1], map[3 * j + 2],
                             __int_as_float(j));
}

// the run (first, count) of cell (x, y, z); count 0 where it is not in the
// map
__device__ __forceinline__ void probe(const int4* __restrict__ cells,
                                      const int* __restrict__ starts,
                                      unsigned mask, unsigned x, unsigned y,
                                      unsigned z, int& first, int& count) {
    unsigned s = cell_hash(x, y, z) & mask;
    for (;;) {
        const int4 r = cells[s];
        if (r.w == 0) {
            first = count = 0;
            return;
        }
        if ((unsigned)r.x == x && (unsigned)r.y == y && (unsigned)r.z == z) {
            first = starts[s];
            count = r.w;
            return;
        }
        s = (s + 1) & mask;
    }
}

__device__ __forceinline__ void take(float qx, float qy, float qz, float4 p,
                                     float& best, int& arg) {
    const float dx = __fsub_rn(qx, p.x);
    const float dy = __fsub_rn(qy, p.y);
    const float dz = __fsub_rn(qz, p.z);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    const int j = __float_as_int(p.w);
    if (d2 < best || (d2 == best && j < arg)) {
        best = d2;
        arg = j;
    }
}

// an axis offset: 0, 1, 2 -> -1, 0, +1; 3 -> 2^31 (wrapping)
__device__ __forceinline__ unsigned offset(int o) {
    return o == 3 ? 0x80000000u : (unsigned)o - 1u;
}

__global__ void __launch_bounds__(SEARCH_WARPS * 32)
icp_nn_search(const float* __restrict__ src, int n,
              const int4* __restrict__ cells, const int* __restrict__ starts,
              const float4* __restrict__ points, unsigned mask,
              const int* __restrict__ meta, float v,
              float* __restrict__ best_d2, long long* __restrict__ best_idx) {
    const int lane = threadIdx.x & 31;
    const int q = blockIdx.x * SEARCH_WARPS + (threadIdx.x >> 5);
    if (q >= n) return;                       // the whole warp
    const float qx = src[3 * q], qy = src[3 * q + 1], qz = src[3 * q + 2];
    const int vx = voxel(qx, v), vy = voxel(qy, v), vz = voxel(qz, v);
    float best = __int_as_float(0x7f800000);
    int arg = 0;

    // lane c < 27 probes neighbour cell c; a warp scan numbers the
    // candidates; shift maps a candidate's number to its place
    int first = 0, cnt = 0;
    if (lane < 27)
        probe(cells, starts, mask, (unsigned)vx + offset(lane % 3),
              (unsigned)vy + offset(lane / 3 % 3),
              (unsigned)vz + offset(lane / 9), first, cnt);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    const int shift = first - (incl - cnt);
    for (int t0 = 0; t0 < total; t0 += 32 * UNROLL) {
        float4 p[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {    // the loads first, all in flight
            const int t = t0 + 32 * u + lane;
            int c = 0;                        // lanes with incl <= t
#pragma unroll
            for (int s = 16; s > 0; s >>= 1) {
                const int e = __shfl_sync(FULL, incl, c + s - 1);
                if (e <= t) c += s;
            }
            const int sh = __shfl_sync(FULL, shift, c);
            if (t < total) p[u] = points[t + sh];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            if (t0 + 32 * u + lane < total) take(qx, qy, qz, p[u], best, arg);
    }

    // the cells at a wrapped distance of 2^31 on some axis
    if (meta[0] != 0 || far_out(vx) || far_out(vy) || far_out(vz)) {
        for (int c = 0; c < 64; ++c) {
            const int ox = c & 3, oy = (c >> 2) & 3, oz = c >> 4;
            if (ox < 3 && oy < 3 && oz < 3) continue;
            int f, k;
            probe(cells, starts, mask, (unsigned)vx + offset(ox),
                  (unsigned)vy + offset(oy), (unsigned)vz + offset(oz), f, k);
            for (int t = lane; t < k; t += 32)
                take(qx, qy, qz, points[f + t], best, arg);
        }
    }

#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, o);
        const int oa = __shfl_xor_sync(FULL, arg, o);
        if (ob < best || (ob == best && oa < arg)) {
            best = ob;
            arg = oa;
        }
    }
    if (lane == 0) {
        best_d2[q] = best;
        best_idx[q] = arg;
    }
}

}  // namespace

extern "C" {

// Builds the index of `m` map points on `stream` (four kernels); returns
// the cudaError_t of the first refused launch (0 = ok). `valid` may be null
// (every point valid); `slots` is a power of two >= 2 m (>= 2). Arrays, all
// from the caller: vox (m int4, scratch), key (slots int, scratch), cells
// (slots int4), starts (slots int), points (m float4), meta (2 int).
int icp_index_launch(const void* map, const void* valid, int m,
                     float voxel_size, int slots, void* vox, void* key,
                     void* cells, void* starts, void* points, void* meta,
                     int sms, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int total = m > slots ? m : slots;
    int blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 32 * sms) blocks = 32 * sms;
    icp_index_voxels<<<blocks, THREADS, 0, st>>>(
        (const float*)map, (const uint8_t*)valid, m, voxel_size, slots,
        (int4*)vox, (int*)key, (int4*)cells, (int*)meta);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const unsigned mask = (unsigned)slots - 1u;
    if (m > 0) {
        icp_index_insert<<<(m + THREADS - 1) / THREADS, THREADS, 0, st>>>(
            m, mask, (int4*)vox, (int*)key, (int4*)cells, (int*)meta);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    icp_index_runs<<<(slots + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        slots, (const int4*)cells, (int*)starts, (int*)meta);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (m > 0) {
        icp_index_scatter<<<(m + THREADS - 1) / THREADS, THREADS, 0, st>>>(
            (const float*)map, m, (const int4*)vox, (int*)starts,
            (float4*)points);
        err = cudaGetLastError();
    }
    return (int)err;
}

// Searches the index for n > 0 queries on `stream` (one kernel); returns
// the cudaError_t of the launch.
int icp_nn_search_launch(const void* src, int n, const void* cells,
                         const void* starts, const void* points, int slots,
                         const void* meta, float voxel_size, void* best_d2,
                         void* best_idx, void* stream) {
    icp_nn_search<<<(n + SEARCH_WARPS - 1) / SEARCH_WARPS,
                    SEARCH_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)src, n, (const int4*)cells, (const int*)starts,
        (const float4*)points, (unsigned)slots - 1u, (const int*)meta,
        voxel_size, (float*)best_d2, (long long*)best_idx);
    return (int)cudaGetLastError();
}

const char* icp_nn_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
