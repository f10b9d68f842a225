// K1 on Hopper: the GF(2^8) matrix apply behind RS encode, rebuild and
// decode.
//
//   out[i][c] = XOR_j M[i][j] * data[j][c]   over GF(2^8), poly 0x11D
//
// Replaces the Pallas TPU kernel seaweedfs_tpu/ops/rs_pallas.py
// (_make_kernel, launched by pallas_apply_fn), whose math is
// rs_jax._apply_matrix_rows: the Horner form over output bits with a SWAR
// multiply-by-2 on four bytes packed in a 32-bit word.
//
// Design. A thread owns 16-byte pieces of a column (two pieces a block
// width apart for k <= 16, one otherwise): one 16-byte load per input row
// and piece into registers, then, per output row, the Horner chain
//   acc = xtime(acc) ^ (XOR of the inputs whose coefficient has bit b)
// for b = 7..0 on the four 32-bit words of each piece. The matrix is a
// runtime argument, not a compile-time constant: one build serves the
// parity matrix and every rebuild matrix (1001 survivor sets of RS(10,4)
// times their missing subsets). The host turns it into selection masks,
// mask[i][b] = {j : bit b of M[i][j]}, passed by value in the kernel's
// parameter space; the masks are the same for every thread, so the
// branches on them never diverge. The input count k is a template
// argument for k <= 16 (the unrolled loops then test no unused inputs);
// larger k takes a generic instantiation. A grid-stride loop covers the
// columns; the ragged edge (n % 16) and unaligned rows take a byte-wise
// path in the kernel, so the caller never pads.
//
// Bound. Each input byte is read once and each output byte written once:
// (k + m) * n bytes of HBM traffic, 70 us for RS(10,4) at 16 MiB per row
// at the H100 SXM's 3.35 TB/s. The work is about 8-10 integer
// instructions per input byte for RS(10,4) (7 SWAR doublings and a
// predicated XOR per coefficient bit, per output word), which keeps the
// kernel near the card's instruction issue rate as well; chip_smoke.py
// measures it against the byte bound. TMA staging, fewer XORs through
// shared sub-sums and a tensor-core bit-plane form are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;   // m: outputs per launch
constexpr int kMaxCols = 32;   // k: inputs per launch (one 32-bit mask)
constexpr int kThreads = 256;

struct Selection {
    uint32_t mask[kMaxRows * 8];  // mask[i * 8 + b]: inputs j with bit b of M[i][j]
};

struct Args {
    const uint8_t* data;
    int64_t data_stride;
    uint8_t* out;
    int64_t out_stride;
    int64_t n;
    int vec;
};

__device__ __forceinline__ uint32_t xtime(uint32_t v) {
    return ((v << 1) & 0xFEFEFEFEu) ^ (((v >> 7) & 0x01010101u) * 0x1Du);
}

__device__ __forceinline__ uint4 xtime4(uint4 v) {
    return make_uint4(xtime(v.x), xtime(v.y), xtime(v.z), xtime(v.w));
}

__device__ __forceinline__ void xor4(uint4& a, const uint4& b) {
    a.x ^= b.x;
    a.y ^= b.y;
    a.z ^= b.z;
    a.w ^= b.w;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
    return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// Bytes [0, len) of p, little-endian into four words, zero past len.
__device__ __forceinline__ uint4 load_partial(const uint8_t* p, int len) {
    uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
#pragma unroll
    for (int t = 0; t < 16; t++) {
        if (t < len) {
            const uint32_t b = (uint32_t)p[t] << (8 * (t & 3));
            if (t < 4) w0 |= b;
            else if (t < 8) w1 |= b;
            else if (t < 12) w2 |= b;
            else w3 |= b;
        }
    }
    return make_uint4(w0, w1, w2, w3);
}

__device__ __forceinline__ void store_partial(uint8_t* p, const uint4& v,
                                              int len) {
#pragma unroll
    for (int t = 0; t < 16; t++) {
        if (t < len) p[t] = (uint8_t)(word_of(v, t >> 2) >> (8 * (t & 3)));
    }
}

// MAXK: register slots for inputs; EXACT: k == MAXK (every `j < k` folds
// away); CHUNKS: 16-byte pieces per thread per grid-stride step.
template <int MAXK, bool EXACT, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const Selection sel, int m, int k_arg, const Args a) {
    const int k = EXACT ? MAXK : k_arg;
    const int64_t chunks = (a.n + 15) >> 4;
    const int64_t tile = (int64_t)kThreads * CHUNKS;
    for (int64_t t0 = (int64_t)blockIdx.x * tile; t0 < chunks;
         t0 += (int64_t)gridDim.x * tile) {
        uint4 d[CHUNKS][MAXK];
        int64_t col[CHUNKS];
        int len[CHUNKS];
        bool full[CHUNKS];
#pragma unroll
        for (int u = 0; u < CHUNKS; u++) {
            const int64_t c = t0 + u * kThreads + threadIdx.x;
            col[u] = c << 4;
            len[u] = c < chunks ? (int)min((int64_t)16, a.n - col[u]) : 0;
            full[u] = a.vec && len[u] == 16;
#pragma unroll
            for (int j = 0; j < MAXK; j++) {
                d[u][j] = make_uint4(0, 0, 0, 0);
                if (j < k && len[u] > 0) {
                    const uint8_t* p = a.data + (int64_t)j * a.data_stride + col[u];
                    d[u][j] = full[u] ? __ldg(reinterpret_cast<const uint4*>(p))
                                      : load_partial(p, len[u]);
                }
            }
        }
        for (int i = 0; i < m; i++) {
            uint4 acc[CHUNKS];
#pragma unroll
            for (int u = 0; u < CHUNKS; u++) acc[u] = make_uint4(0, 0, 0, 0);
#pragma unroll
            for (int b = 7; b >= 0; b--) {
#pragma unroll
                for (int u = 0; u < CHUNKS; u++) acc[u] = xtime4(acc[u]);
                const uint32_t mask = sel.mask[i * 8 + b];
#pragma unroll
                for (int j = 0; j < MAXK; j++) {
                    if (j < k && ((mask >> j) & 1u)) {
#pragma unroll
                        for (int u = 0; u < CHUNKS; u++) xor4(acc[u], d[u][j]);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < CHUNKS; u++) {
                uint8_t* q = a.out + (int64_t)i * a.out_stride + col[u];
                if (full[u]) {
                    *reinterpret_cast<uint4*>(q) = acc[u];
                } else if (len[u] > 0) {
                    store_partial(q, acc[u], len[u]);
                }
            }
        }
    }
}

template <int MAXK, bool EXACT, int CHUNKS>
void launch(const Selection& sel, int m, int k, const Args& a,
            int max_blocks, cudaStream_t s) {
    const int64_t per_block = (int64_t)kThreads * CHUNKS * 16;
    const int64_t want = (a.n + per_block - 1) / per_block;
    const int grid = (int)(want < max_blocks ? (want > 0 ? want : 1) : max_blocks);
    gf_apply_kernel<MAXK, EXACT, CHUNKS><<<grid, kThreads, 0, s>>>(sel, m, k, a);
}

}  // namespace

extern "C" {

// masks: host array of m * 8 words, masks[i * 8 + b] as in Selection.
// vec: 1 when data, out and both row strides are 16-byte aligned.
// max_blocks: grid cap (the wrapper passes a few blocks per SM).
// Launches on `stream` without synchronising; returns cudaGetLastError().
int gf_apply_launch(const uint32_t* masks, int m, int k, const void* data,
                    int64_t data_stride, void* out, int64_t out_stride,
                    int64_t n, int vec, int max_blocks, void* stream) {
    if (m < 1 || m > kMaxRows || k < 1 || k > kMaxCols || n < 0 ||
        max_blocks < 1)
        return (int)cudaErrorInvalidValue;
    Selection sel;
    for (int t = 0; t < kMaxRows * 8; t++) sel.mask[t] = t < m * 8 ? masks[t] : 0u;
    const Args a{static_cast<const uint8_t*>(data), data_stride,
                 static_cast<uint8_t*>(out), out_stride, n, vec};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (k) {
#define GF_EXACT_CASE(K)                                      \
    case K:                                                   \
        launch<K, true, 2>(sel, m, k, a, max_blocks, s);      \
        break;
        GF_EXACT_CASE(1) GF_EXACT_CASE(2) GF_EXACT_CASE(3) GF_EXACT_CASE(4)
        GF_EXACT_CASE(5) GF_EXACT_CASE(6) GF_EXACT_CASE(7) GF_EXACT_CASE(8)
        GF_EXACT_CASE(9) GF_EXACT_CASE(10) GF_EXACT_CASE(11) GF_EXACT_CASE(12)
        GF_EXACT_CASE(13) GF_EXACT_CASE(14) GF_EXACT_CASE(15) GF_EXACT_CASE(16)
#undef GF_EXACT_CASE
        default:  // two pieces per thread would spill at 32 inputs
            launch<kMaxCols, false, 1>(sel, m, k, a, max_blocks, s);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
