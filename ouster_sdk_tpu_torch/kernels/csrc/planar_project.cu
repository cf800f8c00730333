// planar_project<DUAL, DEWARP, DD, VEC>: word-planar staged lidar frames
// -> XYZ.
//
// Replaces the six planar projection functions of the JAX package's
// ops/pallas_kernels.py: _planar_kernel, _planar_dual_kernel,
// _planar_dual_split_kernel and their _dewarp variants. The aligned vs.
// split distinction there comes from TPU block shapes; here both range
// words are plane indices (w1, w2) of the same (B, P, h, w) input, so the
// six functions are the DUAL x DEWARP instantiations of one template
// (times double-single or f32, times 16- or 4-byte accesses).
//
// Per pixel: r = ((word >> bit) & mask) << upshift, zeroed where the
// column's status bit 0 is clear; xyz = r * dir + off in double-single
// from the (18, h, w) LUT stack; with DEWARP, world = R * xyz + t from the
// column's pose, and 0 where r == 0.
//
// Numerics: the double-single projection is a chain of error-free
// transforms, so every product and sum is an explicit __fmul_rn /
// __fadd_rn / __fsub_rn, which nvcc never contracts (the build also passes
// --fmad=false). The dewarp is the reference's fused form: acc = t_i, then
// acc = fma(R_ik, xyz_k, acc) for k = 0, 1, 2 (__fmaf_rn).
//
// Bound: bytes. Per frame at 128x2048 dual it reads 2 range words (8 B/px)
// and a status word per column, and writes 2 x 3 f32 (24 B/px); the LUT is
// 72 B/px once, the poses 64 B a column and frame. The arithmetic (about
// 75 instructions a return, 9 more with the dewarp) is not free beside it:
// the kernel reaches 70-77 % of the byte bound, and what the dewarp still
// adds to its twin (3-8 %) is its instructions, not its bytes.
//
// Design, for the H100 (geometry in kernels/planar_project.py TUNING,
// settled with kernels/bench_planar.py; times in PERF.md):
//  - A block is a tile of tx*VEC columns x ty rows, one thread per row and
//    VEC adjacent columns. VEC = 4: every access along w is 16 bytes
//    (4-5 % faster than VEC = 1, which remains for rows that do not start
//    on a 16-byte boundary). The block walks `ry` row steps; in each a
//    thread loads its LUT values once and loops over the `fpb` frames of
//    its frame group, so the LUT is read once per fpb frames. The frame
//    groups of one LUT tile are neighbours in the grid, so they run
//    together and the tile comes out of device memory once.
//  - Poses are the function's own operand, (B, w, 4, 4) f32; nothing packs
//    them. The poses of a tile's columns are one contiguous run per frame.
//    The block copies the three used rows of each (R_i0 R_i1 R_i2 t_i; the
//    bottom row is never touched) of all its frames into shared memory
//    with 16-byte cp.async, in flight together with the first LUT loads,
//    and waits once. One copy serves all ty * ry rows of the block (64 at
//    the default geometry: pose traffic out of L2 falls 64-fold against
//    one block a row). A thread reads a column's pose as three float4
//    where it uses them; its stride is an odd count of float4, so a
//    quarter warp falls on distinct banks.
//  - The frame loop is software-pipelined by one frame: the range and
//    status words of frame b + 1 are requested before frame b's arithmetic
//    and stores. (Two and four frames ahead measured slower: more
//    registers, fewer warps.)
//  - The arithmetic is branch-free: a zero range runs the chain too and is
//    put at the origin by a select, so a warp never runs both sides.
//  - Range words are read once and XYZ is written once and never read:
//    both go around the caches' retention (__ldcs / __stcs), so that LUT,
//    status words and poses (read-only path, __ldg) stay.
//  - Double-single or plain f32 is a template parameter, not a branch:
//    fewer registers, and with __launch_bounds__(256, 2) every
//    instantiation fits 128 registers, two blocks of 256 threads an SM.
//    Only the dual dewarp double-single one spills, 16 bytes; left at 230
//    registers and one block an SM it spills nothing and measured 6-7 %
//    slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
    int B, P, h, w, schw;
    int w1, w2;                       // plane indices of RANGE / RANGE2
    int bit1, up1, bit2, up2;
    uint32_t mask1, mask2;
    int status_row, status_bit;
    int fpb;                          // frames per block
    int nz;                           // frame groups: ceil(B / fpb)
    int ry;                           // row steps of a block: ty * ry rows
};

// L: the pixel's 18 LUT values, value k at L[k * S]; DD: double-single, else
// plain f32. Branch-free: a zero range runs the chain too, and the caller
// puts the pixel at the origin.
template <int S, bool DD>
__device__ __forceinline__ void project(uint32_t r, const float* L,
                                        float* xyz) {
    if constexpr (!DD) {
        float rf = __int2float_rn((int)r);
#pragma unroll
        for (int c = 0; c < 3; ++c)
            xyz[c] = __fadd_rn(__fmul_rn(rf, L[c * S]), L[(12 + c) * S]);
        return;
    }
    uint32_t rl_i = r & 0x7FFu;
    float rh = __int2float_rn((int)(r - rl_i));
    float rl = __int2float_rn((int)rl_i);
    float rf = __fadd_rn(rh, rl);     // exact: integer < 2^23
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float DH = L[c * S], DH1 = L[(3 + c) * S], DH2 = L[(6 + c) * S];
        const float DL = L[(9 + c) * S], OH = L[(12 + c) * S];
        const float OL = L[(15 + c) * S];
        float p = __fmul_rn(rf, DH);
        // Dekker: all four partial products are exact (11+12 bit mantissas)
        float e = __fadd_rn(
            __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(rh, DH1), p),
                                __fmul_rn(rh, DH2)),
                      __fmul_rn(rl, DH1)),
            __fmul_rn(rl, DH2));
        // two_sum(p, OH)
        float s = __fadd_rn(p, OH);
        float bb = __fsub_rn(s, p);
        float es = __fadd_rn(__fsub_rn(p, __fsub_rn(s, bb)),
                             __fsub_rn(OH, bb));
        xyz[c] = __fadd_rn(
            s, __fadd_rn(__fadd_rn(__fadd_rn(e, es), __fmul_rn(rf, DL)),
                         OL));
    }
}

// pose: the top three rows of the column's 4x4 pose, (R_i0 R_i1 R_i2 t_i)
__device__ __forceinline__ void dewarp(const float4* pose, float* xyz) {
    float world[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        float acc = pose[i].w;
        acc = __fmaf_rn(pose[i].x, xyz[0], acc);
        acc = __fmaf_rn(pose[i].y, xyz[1], acc);
        acc = __fmaf_rn(pose[i].z, xyz[2], acc);
        world[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) xyz[i] = world[i];
}

// -- VEC adjacent values along w: one 4- or 16-byte access -------------------

template <int VEC>
__device__ __forceinline__ void load_stream(const uint32_t* p,
                                            uint32_t (&v)[VEC]) {
    if constexpr (VEC == 4) {
        const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
        v[0] = __ldcs(p);
    }
}

template <int VEC>
__device__ __forceinline__ void load_ro(const uint32_t* p,
                                        uint32_t (&v)[VEC]) {
    if constexpr (VEC == 4) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
        v[0] = __ldg(p);
    }
}

template <int VEC>
__device__ __forceinline__ void load_ro(const float* p, float (&v)[VEC]) {
    if constexpr (VEC == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
        v[0] = __ldg(p);
    }
}

template <int VEC>
__device__ __forceinline__ void store_stream(float* p, const float (&v)[VEC]) {
    if constexpr (VEC == 4)
        __stcs(reinterpret_cast<float4*>(p),
               make_float4(v[0], v[1], v[2], v[3]));
    else
        __stcs(p, v[0]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// float4 of shared memory a thread and frame: three a column, padded to an
// odd count so that the threads of a quarter warp fall on distinct banks
template <int VEC>
__host__ __device__ constexpr int pose_stride() {
    return 3 * VEC + (VEC % 2 == 0 ? 1 : 0);
}

template <int VEC>
struct FrameWords {                   // one frame's words of a thread
    uint32_t st[VEC], r1[VEC], r2[VEC];
};

// One return of one pixel: extract the range, project, dewarp; a column
// without its status bit and a zero range stay at the origin.
template <bool DEWARP, bool DD, int VEC>
__device__ __forceinline__ void pixel(uint32_t word, int bit, uint32_t mask,
                                      int up, bool valid, const float* L,
                                      const float4* pose,
                                      float (&o)[3][VEC], int v) {
    const uint32_t r = valid ? ((word >> bit) & mask) << up : 0u;
    float xyz[3];
    project<VEC, DD>(r, L, xyz);
    if (DEWARP) dewarp(pose, xyz);
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c][v] = r ? xyz[c] : 0.0f;
}

template <bool DUAL, bool DEWARP, bool DD, int VEC>
__global__ void __launch_bounds__(256, 2)
planar_project(const uint32_t* __restrict__ planes,
                               const uint32_t* __restrict__ col_hdrs,
                               const float* __restrict__ lut,
                               const float* __restrict__ poses,
                               float* __restrict__ out1,
                               float* __restrict__ out2, Params p) {
    extern __shared__ float4 pose_sm[];   // [frame][thread x][pose_stride]
    constexpr int PS = pose_stride<VEC>();
    const int tile_cols = blockDim.x * VEC;
    // blockIdx.x = column tile * nz + frame group: the frame groups of one
    // LUT tile are neighbours in the grid
    const int col0 = (blockIdx.x / p.nz) * tile_cols;
    const int col = col0 + threadIdx.x * VEC;
    const int row0 = blockIdx.y * blockDim.y * p.ry + threadIdx.y;
    const int b0 = (blockIdx.x % p.nz) * p.fpb;
    const int b1 = min(p.B, b0 + p.fpb);
    const size_t hw = (size_t)p.h * p.w;

    if (DEWARP) {
        // the tile's poses of frame b are 64 * ncols contiguous bytes
        const int ncols = min(tile_cols, p.w - col0);
        const int tid = threadIdx.y * blockDim.x + threadIdx.x;
        const int nthr = blockDim.x * blockDim.y;
        for (int f = 0; f < b1 - b0; ++f) {
            const float4* src = reinterpret_cast<const float4*>(poses)
                + ((size_t)(b0 + f) * p.w + col0) * 4;
            float4* dst = pose_sm + (size_t)f * blockDim.x * PS;
            for (int j = tid; j < ncols * 4; j += nthr) {
                const int c = j >> 2, q = j & 3;
                if (q != 3)
                    cp_async16(dst + (c / VEC) * PS + (c % VEC) * 3 + q,
                               src + j);
            }
        }
    }

    constexpr int nl = DD ? 18 : 15;    // f32 reads dir_hi and off_hi only
    for (int ri = 0; ri < p.ry; ++ri) {
        const int row = row0 + ri * blockDim.y;
        const bool active = col < p.w && row < p.h;   // w % VEC == 0
        const size_t pix = active ? (size_t)row * p.w + col : 0;
        float L[18 * VEC];            // value k of column v at L[k * VEC + v]
#pragma unroll
        for (int k = 0; k < 18; ++k) {
            float lk[VEC];
#pragma unroll
            for (int v = 0; v < VEC; ++v) lk[v] = 0.0f;
            if (active && k < nl) load_ro<VEC>(lut + k * hw + pix, lk);
#pragma unroll
            for (int v = 0; v < VEC; ++v) L[k * VEC + v] = lk[v];
        }

        auto load_frame = [&](int b, FrameWords<VEC>& fw) {
            load_ro<VEC>(col_hdrs
                         + ((size_t)b * p.schw + p.status_row) * p.w + col,
                         fw.st);
            const uint32_t* fp = planes + (size_t)b * p.P * hw + pix;
            load_stream<VEC>(fp + p.w1 * hw, fw.r1);
            if (DUAL) load_stream<VEC>(fp + p.w2 * hw, fw.r2);
        };

        FrameWords<VEC> next;
        if (active) load_frame(b0, next);
        if (DEWARP && ri == 0) {      // the LUT loads are in flight meanwhile
            cp_async_wait_all();
            __syncthreads();
        }
        if (!active) continue;

        for (int b = b0; b < b1; ++b) {
            const FrameWords<VEC> cur = next;
            if (b + 1 < b1) load_frame(b + 1, next);   // ahead of the math

            // this thread's columns' poses of frame b
            const float4* ps = pose_sm
                + ((size_t)(b - b0) * blockDim.x + threadIdx.x) * PS;
            float o1[3][VEC], o2[3][VEC];
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
                const bool valid = (cur.st[v] >> p.status_bit) & 1u;
                pixel<DEWARP, DD, VEC>(cur.r1[v], p.bit1, p.mask1, p.up1,
                                       valid, L + v, ps + 3 * v, o1, v);
                if (DUAL)
                    pixel<DEWARP, DD, VEC>(cur.r2[v], p.bit2, p.mask2, p.up2,
                                           valid, L + v, ps + 3 * v, o2, v);
            }
            float* op = out1 + (size_t)b * 3 * hw + pix;
#pragma unroll
            for (int c = 0; c < 3; ++c) store_stream<VEC>(op + c * hw, o1[c]);
            if (DUAL) {
                op = out2 + (size_t)b * 3 * hw + pix;
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    store_stream<VEC>(op + c * hw, o2[c]);
            }
        }
    }
}

template <bool DUAL, bool DEWARP, bool DD, int VEC>
int launch_as(const uint32_t* pl, const uint32_t* ch, const float* lt,
              const float* ps, float* o1, float* o2, const Params& p,
              dim3 grid, dim3 block, cudaStream_t s) {
    auto kernel = planar_project<DUAL, DEWARP, DD, VEC>;
    const size_t smem = DEWARP
        ? (size_t)p.fpb * block.x * pose_stride<VEC>() * sizeof(float4) : 0;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, block, smem, s>>>(pl, ch, lt, ps, o1, o2, p);
    return (int)cudaGetLastError();
}

// the run-time case (dual, dewarp, dd) -> its instantiation
template <bool DUAL, bool DEWARP, int VEC, typename... Args>
int launch_dd(bool dd, Args... args) {
    return dd ? launch_as<DUAL, DEWARP, true, VEC>(args...)
              : launch_as<DUAL, DEWARP, false, VEC>(args...);
}

template <int VEC, typename... Args>
int launch_case(bool dual, bool dewarp, bool dd, Args... args) {
    if (dual && dewarp) return launch_dd<true, true, VEC>(dd, args...);
    if (dual) return launch_dd<true, false, VEC>(dd, args...);
    if (dewarp) return launch_dd<false, true, VEC>(dd, args...);
    return launch_dd<false, false, VEC>(dd, args...);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// poses: (B, w, 4, 4) f32, 16-byte aligned, or null (no dewarp). A block is
// tx threads along w (4 columns each, or 1 where a row does not start on a
// 16-byte boundary) x ty rows; it walks ry row steps and, in each, the fpb
// frames of its frame group.
int planar_project_launch(const void* planes, const void* col_hdrs,
                          const void* lut, const void* poses, void* out1,
                          void* out2, int B, int P, int h, int w, int schw,
                          int w1, int w2, int bit1, uint32_t mask1, int up1,
                          int bit2, uint32_t mask2, int up2, int status_row,
                          int status_bit, int dd, int dual, int fpb, int tx,
                          int ty, int ry, void* stream) {
    // 16-byte accesses need every row to start on a 16-byte boundary
    const bool wide = w % 4 == 0 && aligned16(planes) && aligned16(col_hdrs)
        && aligned16(lut) && aligned16(out1) && aligned16(out2);
    const int vec = wide ? 4 : 1;
    if (poses != nullptr && !aligned16(poses))
        return (int)cudaErrorMisalignedAddress;
    const int tile_cols = tx * vec;
    Params p{B, P, h, w, schw, w1, w2, bit1, up1, bit2, up2, mask1, mask2,
             status_row, status_bit, fpb, (B + fpb - 1) / fpb, ry};
    dim3 block(tx, ty);
    dim3 grid((w + tile_cols - 1) / tile_cols * p.nz,
              (h + ty * ry - 1) / (ty * ry));
    cudaStream_t s = (cudaStream_t)stream;
    auto pl = (const uint32_t*)planes;
    auto ch = (const uint32_t*)col_hdrs;
    auto lt = (const float*)lut;
    auto ps = (const float*)poses;
    auto o1 = (float*)out1;
    auto o2 = (float*)out2;
    const bool dewarp = poses != nullptr;
    if (wide)
        return launch_case<4>(dual != 0, dewarp, dd != 0, pl, ch, lt, ps, o1,
                              o2, p, grid, block, s);
    return launch_case<1>(dual != 0, dewarp, dd != 0, pl, ch, lt, ps, o1, o2,
                          p, grid, block, s);
}

const char* planar_project_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
