// packet_project<DUAL>: packet-layout staged lidar frames -> planar XYZ.
//
// Replaces the two packet-layout projection functions of the JAX package's
// ops/pallas_kernels.py: _project_kernel (one return) and
// _project_dual_kernel (both returns from one pixel-region fetch), reached
// through unpack_project_pallas[_batched] and unpack_project. Those take a
// pixel region that XLA has cut out of the packets and a valid row computed
// outside; this kernel reads the staged frames (B, n_pkts, pkt_words) as
// they are and finds every word itself.
//
// Pixel (b, row, col) has its range word at
//   ((b * n_pkts + col / cpp) * pkt_words + hw + (col % cpp) * cw
//    + chw + row * pw + word)
// and its column's status word at  ... + (col % cpp) * cw + status_word.
// r = ((word >> bit) & mask) << upshift, zeroed where the column's status
// bit is clear; xyz = r * dir + off from four (3, h, w) LUT planes
// (dir_hi, dir_lo, off_hi, off_lo); 0 where r == 0.
//
// Numerics: dd is the generic double-single chain of ops/precision.py,
// dd_mul_f (Dekker product with a Veltkamp split of both factors at run
// time), dd_add, then hi + lo. Every product and sum is an explicit
// __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts (the build
// also passes --fmad=false). f32 is r * dir_hi + off_hi, two roundings.
//
// Bound: bytes. The input is contiguous along the rows of one column
// (pw words a pixel) and jumps cw words from column to column, while the
// output (B, 3, h, w) is contiguous along columns. Every 32-byte sector of
// the pixel region holds a range word, so the whole region is read
// whatever the kernel picks from it. Design: a block owns a tile of TC
// columns x TR rows and stages the tile's range values through shared
// memory. In the load phase neighbouring threads walk down the rows of one
// column (stride pw words inside one contiguous run of TR * pw words); in
// the compute phase neighbouring threads are neighbouring columns of one
// row, so LUT loads and XYZ stores coalesce. The tile is stored
// [column][row] with an odd row stride (TR + 1 = 9), which keeps the
// transposed reads of the compute phase free of bank conflicts: the 32
// columns of one row sit 9 words apart, in 32 distinct banks. The writes of
// the load phase are not free of them: a warp writes 4 columns x 8 rows at
// offsets lc * 9 + lr, which span 35 words, so three pairs of its words
// share a bank (2-way). Each thread owns one pixel of the tile, loads its
// 12 LUT values once and loops over FPB frames.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;   // tile columns
constexpr int TR = 8;    // tile rows
constexpr int FPB = 8;   // frames per block
constexpr float SPLITTER = 4097.0f;   // 2^12 + 1: f32 Veltkamp split

struct Params {
    int B, n_pkts, pkt_words, h, w;
    int hw, cw, chw, cpp, pw;         // packet geometry, in words
    int word1, bit1, up1, word2, bit2, up2;
    uint32_t mask1, mask2;
    int status_word, status_bit;
    int dd;                           // 1: double-single, 0: plain f32
};

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
    const float c = __fmul_rn(SPLITTER, a);
    hi = __fsub_rn(c, __fsub_rn(c, a));
    lo = __fsub_rn(a, hi);
}

// L: dir_hi[3], dir_lo[3], off_hi[3], off_lo[3] of this pixel
__device__ __forceinline__ void project(uint32_t r, const float* L, int dd,
                                        float* xyz) {
    if (r == 0u) {
        xyz[0] = xyz[1] = xyz[2] = 0.0f;
        return;
    }
    const float f = __int2float_rn((int)r);   // exact: r < 2^24
    if (!dd) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
            xyz[c] = __fadd_rn(__fmul_rn(f, L[c]), L[6 + c]);
        return;
    }
    float f_hi, f_lo;
    split(f, f_hi, f_lo);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float x_hi = L[c], x_lo = L[3 + c];
        const float y_hi = L[6 + c], y_lo = L[9 + c];
        // dd_mul_f(x_hi, x_lo, f): two_prod(x_hi, f), + x_lo * f,
        // fast_two_sum
        const float p = __fmul_rn(x_hi, f);
        float a_hi, a_lo;
        split(x_hi, a_hi, a_lo);
        float e = __fadd_rn(
            __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(a_hi, f_hi), p),
                                __fmul_rn(a_hi, f_lo)),
                      __fmul_rn(a_lo, f_hi)),
            __fmul_rn(a_lo, f_lo));
        e = __fadd_rn(e, __fmul_rn(x_lo, f));
        const float p_hi = __fadd_rn(p, e);
        const float p_lo = __fsub_rn(e, __fsub_rn(p_hi, p));
        // dd_add(p_hi, p_lo, y_hi, y_lo): two_sum, + lows, fast_two_sum
        const float s = __fadd_rn(p_hi, y_hi);
        const float bb = __fsub_rn(s, p_hi);
        float es = __fadd_rn(__fsub_rn(p_hi, __fsub_rn(s, bb)),
                             __fsub_rn(y_hi, bb));
        es = __fadd_rn(__fadd_rn(es, p_lo), y_lo);
        const float s_hi = __fadd_rn(s, es);
        const float s_lo = __fsub_rn(es, __fsub_rn(s_hi, s));
        xyz[c] = __fadd_rn(s_hi, s_lo);
    }
}

// word offset of column `col`'s block inside a frame
__device__ __forceinline__ size_t col_block(const Params& p, int col) {
    return (size_t)(col / p.cpp) * p.pkt_words + p.hw
           + (size_t)(col % p.cpp) * p.cw;
}

template <bool DUAL>
__global__ void __launch_bounds__(TC * TR)
packet_project(const uint32_t* __restrict__ frames,
               const float* __restrict__ dir_hi,
               const float* __restrict__ dir_lo,
               const float* __restrict__ off_hi,
               const float* __restrict__ off_lo,
               float* __restrict__ out1, float* __restrict__ out2,
               Params p) {
    __shared__ uint32_t rng[DUAL ? 2 : 1][TC][TR + 1];
    __shared__ uint32_t valid[TC];

    const int tid = threadIdx.x;
    const int col0 = blockIdx.x * TC, row0 = blockIdx.y * TR;
    const int cols = min(TC, p.w - col0), rows = min(TR, p.h - row0);

    // compute-phase pixel: columns fastest
    const int tc = tid % TC, tr = tid / TC;
    const int col = col0 + tc, row = row0 + tr;
    const bool inside = tc < cols && tr < rows;
    const size_t hw = (size_t)p.h * p.w;
    const size_t pix = (size_t)row * p.w + col;
    float L[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) L[k] = 0.0f;
    if (inside) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            L[c] = dir_hi[c * hw + pix];
            L[6 + c] = off_hi[c * hw + pix];
            if (p.dd) {
                L[3 + c] = dir_lo[c * hw + pix];
                L[9 + c] = off_lo[c * hw + pix];
            }
        }
    }

    // load-phase pixel: rows fastest, down one column's pixel region.
    // Offsets are words inside one frame; a thread outside the tile
    // computes its offset and never reads through it.
    const int lc = tid / TR, lr = tid % TR;
    const bool loads = lc < cols && lr < rows;
    const size_t px_off =
        col_block(p, col0 + lc) + p.chw + (size_t)(row0 + lr) * p.pw;
    // the first `cols` threads also fetch their column's status word
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
        if (tid < cols) valid[tid] = (f[st_off] >> p.status_bit) & 1u;
        __syncthreads();
        if (inside) {
            const bool ok = valid[tc] != 0u;
            float xyz[3];
            project(ok ? rng[0][tc][tr] : 0u, L, p.dd, xyz);
            float* o = out1 + (size_t)b * 3 * hw + pix;
#pragma unroll
            for (int c = 0; c < 3; ++c) o[c * hw] = xyz[c];
            if (DUAL) {
                project(ok ? rng[1][tc][tr] : 0u, L, p.dd, xyz);
                o = out2 + (size_t)b * 3 * hw + pix;
#pragma unroll
                for (int c = 0; c < 3; ++c) o[c * hw] = xyz[c];
            }
        }
        __syncthreads();   // the tile is rewritten by the next frame
    }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int packet_project_launch(const void* frames, const void* dir_hi,
                          const void* dir_lo, const void* off_hi,
                          const void* off_lo, void* out1, void* out2, int B,
                          int n_pkts, int pkt_words, int h, int w, int hw,
                          int cw, int chw, int cpp, int pw, int word1,
                          int bit1, uint32_t mask1, int up1, int word2,
                          int bit2, uint32_t mask2, int up2, int status_word,
                          int status_bit, int dd, int dual, void* stream) {
    Params p{B, n_pkts, pkt_words, h, w, hw, cw, chw, cpp, pw,
             word1, bit1, up1, word2, bit2, up2, mask1, mask2,
             status_word, status_bit, dd};
    dim3 block(TC * TR);
    dim3 grid((w + TC - 1) / TC, (h + TR - 1) / TR, (B + FPB - 1) / FPB);
    cudaStream_t s = (cudaStream_t)stream;
    auto fr = (const uint32_t*)frames;
    auto dh = (const float*)dir_hi;
    auto dl = (const float*)dir_lo;
    auto oh = (const float*)off_hi;
    auto ol = (const float*)off_lo;
    auto o1 = (float*)out1;
    auto o2 = (float*)out2;
    if (dual)
        packet_project<true><<<grid, block, 0, s>>>(fr, dh, dl, oh, ol, o1, o2, p);
    else
        packet_project<false><<<grid, block, 0, s>>>(fr, dh, dl, oh, ol, o1, o2, p);
    return (int)cudaGetLastError();
}

const char* packet_project_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
