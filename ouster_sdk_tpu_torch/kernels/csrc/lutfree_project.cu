// lutfree_packet<DD, DUAL> and lutfree_planar: staged lidar frames -> planar
// XYZ with the direction synthesized in the kernel from small factor
// tables, no per-pixel LUT.
//
// Replaces the four projection functions of the JAX package's
// ops/pallas_lutfree.py: _lutfree_kernel (f32; lutfree_packet<false, false>),
// _lutfree_dd_kernel (double-single; <true, false>), _lutfree_dd_dual_kernel
// (both returns from one pixel-region fetch and one synthesis; <true, true>)
// and _lutfree_dd_planar_kernel (double-single over word-planar staging;
// lutfree_planar). Those take a pixel region that XLA has cut out of the
// packets, a valid row computed outside and cos/sin rows tiled once a frame;
// these kernels read the staged frames as they are and find every word
// themselves.
//
// For a spinning sensor the projection factorizes: with six per-row
// 3-vectors P, Q, S, E, F, G and the per-column encoder pair ce, se,
//   dir = ce * P + se * Q + S,   off = ce * E + se * F + G,
//   xyz = r * dir + off,  0 where r == 0,
// r = ((word >> bit) & mask) << upshift, zeroed where the column's status
// bit is clear. Every table value is an (hi, lo) f32 pair.
//
// Tables: `rows` is (h, 36) f32, for each of P, Q, S, E, F, G its hi[3] then
// its lo[3]; `cols` is (w, 4) f32: ce_hi, ce_lo, se_hi, se_lo. 36 floats a
// row and 4 a column, about 50 KB at 128 x 2048. They come through the
// read-only cache (__ldg), not shared memory: the threads of a warp are
// neighbouring columns of one row, so a row value is one broadcast load and
// the column values one coalesced 16-byte load a thread, once a block.
//
// Numerics: the double-single chain of ops/precision.py, op for op:
// dd_mul (Dekker product with Veltkamp splits of both high parts, the
// a_lo * b_lo term dropped, the cross terms summed first), dd_add (two_sum,
// the low parts added left to right, fast_two_sum), dd_mul_f, then hi + lo.
// Every product and sum is an explicit __fmul_rn / __fadd_rn / __fsub_rn,
// which nvcc never contracts (the build also passes --fmad=false). The f32
// case is the same formulas with one rounding an op: (ce*P + se*Q) + S,
// r * dir + off.
//
// Bound: bytes, as long as the synthesis is not repeated for every frame.
// A dd synthesis is about 420 operations a position (none of them a fused
// multiply-add), four times the projection of one pixel (about 102). Each
// thread owns one (row, column) position, synthesizes dir and off once,
// keeps them in registers (12 values, and the Veltkamp halves of dir_hi, 6
// more) and loops over the FPB frames of its block and over both returns.
// The traffic is then the range words in and XYZ out.
//
// Input walk. Packet layout: as packet_project.cu, a block owns a tile of
// TC columns x TR rows and stages the tile's range values through shared
// memory, stored [column][row] with an odd row stride (TR + 1): in the load
// phase neighbouring threads walk down the rows of one column, in the
// compute phase neighbouring threads are neighbouring columns of one row,
// so XYZ stores coalesce. Planar: the range word plane is contiguous along
// columns already; one thread a (column, row), columns fastest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;   // tile columns (packet layout)
constexpr int TR = 8;    // tile rows (packet layout)
constexpr int FPB = 8;   // frames per block
constexpr int PLANAR_THREADS = 128;
constexpr float SPLITTER = 4097.0f;   // 2^12 + 1: f32 Veltkamp split

struct ds {
    float hi, lo;
};

__device__ __forceinline__ ds split(float a) {
    const float c = __fmul_rn(SPLITTER, a);
    ds r;
    r.hi = __fsub_rn(c, __fsub_rn(c, a));
    r.lo = __fsub_rn(a, r.hi);
    return r;
}

__device__ __forceinline__ ds fast_two_sum(float a, float b) {
    ds r;
    r.hi = __fadd_rn(a, b);
    r.lo = __fsub_rn(b, __fsub_rn(r.hi, a));
    return r;
}

// Dekker error term of a * b with p = rn(a * b): as, bs the Veltkamp halves
__device__ __forceinline__ float prod_err(float p, ds as, ds bs) {
    return __fadd_rn(
        __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(as.hi, bs.hi), p),
                            __fmul_rn(as.hi, bs.lo)),
                  __fmul_rn(as.lo, bs.hi)),
        __fmul_rn(as.lo, bs.lo));
}

// precision.dd_mul; as = split(a.hi)
__device__ __forceinline__ ds dd_mul(ds a, ds as, ds b) {
    const float p = __fmul_rn(a.hi, b.hi);
    float e = prod_err(p, as, split(b.hi));
    e = __fadd_rn(e, __fadd_rn(__fmul_rn(a.hi, b.lo),
                               __fmul_rn(a.lo, b.hi)));
    return fast_two_sum(p, e);
}

// precision.dd_add
__device__ __forceinline__ ds dd_add(ds x, ds y) {
    const float s = __fadd_rn(x.hi, y.hi);
    const float bb = __fsub_rn(s, x.hi);
    float e = __fadd_rn(__fsub_rn(x.hi, __fsub_rn(s, bb)),
                        __fsub_rn(y.hi, bb));
    e = __fadd_rn(__fadd_rn(e, x.lo), y.lo);
    return fast_two_sum(s, e);
}

// ce * a + se * b + c in double-single; T points at a[hi3 lo3] b[..] c[..]
__device__ __forceinline__ ds synth_dd(ds ce, ds ces, ds se, ds ses,
                                       const float* T, int comp) {
    const ds a{T[comp], T[3 + comp]};
    const ds b{T[6 + comp], T[9 + comp]};
    const ds c{T[12 + comp], T[15 + comp]};
    return dd_add(dd_add(dd_mul(ce, ces, a), dd_mul(se, ses, b)), c);
}

// One position's direction and offset, held across the frame loop.
template <bool DD>
struct Position {
    ds dir[3], off[3];
    ds dirs[3];          // Veltkamp halves of dir[c].hi (DD only)

    // R: the row's 36 table values; C: ce_hi, ce_lo, se_hi, se_lo
    __device__ __forceinline__ void synthesize(const float* R, float4 C) {
        if (DD) {
            const ds ce{C.x, C.y}, se{C.z, C.w};
            const ds ces = split(ce.hi), ses = split(se.hi);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                dir[c] = synth_dd(ce, ces, se, ses, R, c);
                off[c] = synth_dd(ce, ces, se, ses, R + 18, c);
                dirs[c] = split(dir[c].hi);
            }
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                dir[c].hi = __fadd_rn(
                    __fadd_rn(__fmul_rn(C.x, R[c]), __fmul_rn(C.z, R[6 + c])),
                    R[12 + c]);
                off[c].hi = __fadd_rn(
                    __fadd_rn(__fmul_rn(C.x, R[18 + c]),
                              __fmul_rn(C.z, R[24 + c])),
                    R[30 + c]);
            }
        }
    }

    __device__ __forceinline__ void project(uint32_t r, float* xyz) const {
        if (r == 0u) {
            xyz[0] = xyz[1] = xyz[2] = 0.0f;
            return;
        }
        const float f = __int2float_rn((int)r);   // exact: r < 2^24
        if (!DD) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                xyz[c] = __fadd_rn(__fmul_rn(f, dir[c].hi), off[c].hi);
            return;
        }
        const ds fs = split(f);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            // precision.dd_mul_f(dir, f), dd_add(off), hi + lo
            const float p = __fmul_rn(dir[c].hi, f);
            float e = prod_err(p, dirs[c], fs);
            e = __fadd_rn(e, __fmul_rn(dir[c].lo, f));
            const ds s = dd_add(fast_two_sum(p, e), off[c]);
            xyz[c] = __fadd_rn(s.hi, s.lo);
        }
    }
};

// the row's table values: f32 reads the hi triples only
template <bool DD>
__device__ __forceinline__ void load_row(const float* __restrict__ rows,
                                         int row, float* R) {
    const float* src = rows + (size_t)row * 36;
#pragma unroll
    for (int k = 0; k < 36; ++k)
        R[k] = (DD || (k % 6) < 3) ? __ldg(src + k) : 0.0f;
}

struct PacketParams {
    int B, n_pkts, pkt_words, h, w;
    int hw, cw, chw, cpp, pw;         // packet geometry, in words
    int word1, bit1, up1, word2, bit2, up2;
    uint32_t mask1, mask2;
    int status_word, status_bit;
};

// word offset of column `col`'s block inside a frame
__device__ __forceinline__ size_t col_block(const PacketParams& p, int col) {
    return (size_t)(col / p.cpp) * p.pkt_words + p.hw
           + (size_t)(col % p.cpp) * p.cw;
}

template <bool DD, bool DUAL>
__global__ void __launch_bounds__(TC * TR)
lutfree_packet(const uint32_t* __restrict__ frames,
               const float* __restrict__ rows,
               const float4* __restrict__ cols,
               float* __restrict__ out1, float* __restrict__ out2,
               PacketParams p) {
    __shared__ uint32_t rng[DUAL ? 2 : 1][TC][TR + 1];
    __shared__ uint32_t valid[TC];

    const int tid = threadIdx.x;
    const int col0 = blockIdx.x * TC, row0 = blockIdx.y * TR;
    const int ncols = min(TC, p.w - col0), nrows = min(TR, p.h - row0);

    // compute-phase position: columns fastest
    const int tc = tid % TC, tr = tid / TC;
    const int col = col0 + tc, row = row0 + tr;
    const bool inside = tc < ncols && tr < nrows;
    const size_t hw = (size_t)p.h * p.w;
    const size_t pix = (size_t)row * p.w + col;
    Position<DD> pos;
    if (inside) {
        float R[36];
        load_row<DD>(rows, row, R);
        pos.synthesize(R, __ldg(cols + col));
    }

    // load-phase pixel: rows fastest, down one column's pixel region.
    // Offsets are words inside one frame; a thread outside the tile
    // computes its offset and never reads through it.
    const int lc = tid / TR, lr = tid % TR;
    const bool loads = lc < ncols && lr < nrows;
    const size_t px_off =
        col_block(p, col0 + lc) + p.chw + (size_t)(row0 + lr) * p.pw;
    // the first `ncols` threads also fetch their column's status word
    const size_t st_off = col_block(p, col0 + tid) + p.status_word;

    const size_t frame_words = (size_t)p.n_pkts * p.pkt_words;
    const int b0 = blockIdx.z * FPB;
    const int b1 = min(p.B, b0 + FPB);
    for (int b = b0; b < b1; ++b) {
        const uint32_t* f = frames + (size_t)b * frame_words;
        if (loads) {
            rng[0][lc][lr] = ((f[px_off + p.word1] >> p.bit1) & p.mask1)
                             << p.up1;
            if (DUAL)
                rng[1][lc][lr] = ((f[px_off + p.word2] >> p.bit2) & p.mask2)
                                 << p.up2;
        }
        if (tid < ncols) valid[tid] = (f[st_off] >> p.status_bit) & 1u;
        __syncthreads();
        if (inside) {
            const bool ok = valid[tc] != 0u;
            float xyz[3];
            pos.project(ok ? rng[0][tc][tr] : 0u, xyz);
            float* o = out1 + (size_t)b * 3 * hw + pix;
#pragma unroll
            for (int c = 0; c < 3; ++c) o[c * hw] = xyz[c];
            if (DUAL) {
                pos.project(ok ? rng[1][tc][tr] : 0u, xyz);
                o = out2 + (size_t)b * 3 * hw + pix;
#pragma unroll
                for (int c = 0; c < 3; ++c) o[c * hw] = xyz[c];
            }
        }
        __syncthreads();   // the tile is rewritten by the next frame
    }
}

struct PlanarParams {
    int B, P, h, w, schw;
    int word, bit, up;                // plane index of RANGE, its field
    uint32_t mask;
    int status_row, status_bit;
};

__global__ void __launch_bounds__(PLANAR_THREADS)
lutfree_planar(const uint32_t* __restrict__ planes,
               const uint32_t* __restrict__ col_hdrs,
               const float* __restrict__ rows,
               const float4* __restrict__ cols, float* __restrict__ out,
               PlanarParams p) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= p.w) return;
    const int row = blockIdx.y;
    const size_t hw = (size_t)p.h * p.w;
    const size_t pix = (size_t)row * p.w + col;
    Position<true> pos;
    {
        float R[36];
        load_row<true>(rows, row, R);
        pos.synthesize(R, __ldg(cols + col));
    }
    const int b0 = blockIdx.z * FPB;
    const int b1 = min(p.B, b0 + FPB);
    for (int b = b0; b < b1; ++b) {
        const uint32_t status =
            col_hdrs[((size_t)b * p.schw + p.status_row) * p.w + col];
        const bool ok = (status >> p.status_bit) & 1u;
        const uint32_t word =
            planes[((size_t)b * p.P + p.word) * hw + pix];
        float xyz[3];
        pos.project(ok ? ((word >> p.bit) & p.mask) << p.up : 0u, xyz);
        float* o = out + (size_t)b * 3 * hw + pix;
#pragma unroll
        for (int c = 0; c < 3; ++c) o[c * hw] = xyz[c];
    }
}

}  // namespace

extern "C" {

// Both launch on `stream` and return the cudaError_t of the launch (0 = ok).
int lutfree_packet_launch(const void* frames, const void* rows,
                          const void* cols, void* out1, void* out2, int B,
                          int n_pkts, int pkt_words, int h, int w, int hw,
                          int cw, int chw, int cpp, int pw, int word1,
                          int bit1, uint32_t mask1, int up1, int word2,
                          int bit2, uint32_t mask2, int up2, int status_word,
                          int status_bit, int dd, int dual, void* stream) {
    if (dual && !dd) return (int)cudaErrorInvalidValue;   // no such case
    PacketParams p{B, n_pkts, pkt_words, h, w, hw, cw, chw, cpp, pw,
                   word1, bit1, up1, word2, bit2, up2, mask1, mask2,
                   status_word, status_bit};
    dim3 block(TC * TR);
    dim3 grid((w + TC - 1) / TC, (h + TR - 1) / TR, (B + FPB - 1) / FPB);
    cudaStream_t s = (cudaStream_t)stream;
    auto fr = (const uint32_t*)frames;
    auto rt = (const float*)rows;
    auto ct = (const float4*)cols;
    auto o1 = (float*)out1;
    auto o2 = (float*)out2;
    if (dual)
        lutfree_packet<true, true><<<grid, block, 0, s>>>(fr, rt, ct, o1, o2, p);
    else if (dd)
        lutfree_packet<true, false><<<grid, block, 0, s>>>(fr, rt, ct, o1, o2, p);
    else
        lutfree_packet<false, false><<<grid, block, 0, s>>>(fr, rt, ct, o1, o2, p);
    return (int)cudaGetLastError();
}

int lutfree_planar_launch(const void* planes, const void* col_hdrs,
                          const void* rows, const void* cols, void* out,
                          int B, int P, int h, int w, int schw, int word,
                          int bit, uint32_t mask, int up, int status_row,
                          int status_bit, void* stream) {
    PlanarParams p{B, P, h, w, schw, word, bit, up, mask, status_row,
                   status_bit};
    dim3 block(PLANAR_THREADS);
    dim3 grid((w + PLANAR_THREADS - 1) / PLANAR_THREADS, h,
              (B + FPB - 1) / FPB);
    lutfree_planar<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)planes, (const uint32_t*)col_hdrs,
        (const float*)rows, (const float4*)cols, (float*)out, p);
    return (int)cudaGetLastError();
}

const char* lutfree_project_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
