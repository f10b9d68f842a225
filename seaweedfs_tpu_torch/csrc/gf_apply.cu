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
// Design. A thread owns two 16-byte pieces of a column a block width
// apart (one for k > 16): one 16-byte load per input row and piece into
// registers, then, per output row, the Horner chain
//   acc = xtime(acc) ^ (XOR of the inputs whose coefficient has bit b)
// for b = 7..0 on the four 32-bit words of each piece. The matrix is a
// runtime argument, not a compile-time constant: one build serves the
// parity matrix and every rebuild matrix (1001 survivor sets of RS(10,4)
// times their missing subsets). The host turns it into selection masks,
// mask[i][b] = {j : bit b of M[i][j]}, passed by value in the kernel's
// parameter space; the masks are the same for every thread, so the
// branches on them never diverge. The input count k is a template
// argument for k <= 16 (the unrolled loops then test no unused inputs);
// larger k takes a generic instantiation. The ragged edge (n % 16) and
// unaligned rows take a byte-wise path in the kernel, so the caller never
// pads.
//
// What bounds it. Bytes on paper: each input byte is read once and each
// output byte written once, (k + m) * n bytes of HBM traffic, 70 us for
// RS(10,4) at 16 MiB per row at the H100 SXM's 3.35 TB/s. In practice
// instruction issue: about 8-10 integer instructions per input byte for
// RS(10,4) (a doubling of four words and a predicated XOR per input and
// coefficient bit, per output word). At the 1 MiB encode batch a fixed
// cost adds to that: the launch, the first loads' latency and each
// thread's serial chain of loads, Horner steps and stores, which a plain
// device copy of the same byte count also pays in part (chip_smoke.py's
// copy_floor_ms). What the design does about it:
// - The doubling (xtime) takes four instructions a word: a byte permute
//   whose selector replicates each byte's sign bit gives the mask of
//   carries, so no shift-multiply of the top bits is needed.
// - The launch shape is the host's choice per call (rs_cuda.launch_shape),
//   one launch whatever n is: 128-thread blocks, enough of them to cover
//   every piece once, and below 4 MiB columns a block computes half of
//   the output rows (blockIdx.y picks which half):
//   twice the blocks and half the serial chain per thread, while the
//   inputs are read a second time from the 50 MB L2, which holds a whole
//   encode batch.
//
// Trouble spots: the ragged edge and unaligned rows (byte path above);
// a grid past 2^31 - 1 blocks (the grid-stride loop covers the rest);
// the row split re-reads inputs, which pays only while they sit in L2,
// hence its column limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;   // m: outputs per launch
constexpr int kMaxCols = 32;   // k: inputs per launch (one 32-bit mask)
constexpr int kThreads = 128;  // rs_cuda.THREADS

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

// x * 2 in GF(2^8) on four packed bytes: shift each byte left and fold
// the carried-out top bit back in as 0x1D. The mask of carries comes from
// one byte permute whose selector replicates each byte's sign bit.
__device__ __forceinline__ uint32_t xtime(uint32_t v) {
    uint32_t s;
    asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(s) : "r"(v));
    return ((v & 0x7F7F7F7Fu) << 1) ^ (s & 0x1D1D1D1Du);
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
// away); CHUNKS: 16-byte pieces per thread per grid-stride step. Block y
// computes output rows [y * rows, y * rows + rows).
template <int MAXK, bool EXACT, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const Selection sel, int m, int k_arg, int rows,
                const Args a) {
    const int k = EXACT ? MAXK : k_arg;
    const int i0 = blockIdx.y * rows;
    const int i1 = min(m, i0 + rows);
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
        for (int i = i0; i < i1; i++) {
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
void launch(const Selection& sel, int m, int k, const Args& a, int rows,
            int grid, cudaStream_t s) {
    const dim3 blocks(grid, (m + rows - 1) / rows);
    gf_apply_kernel<MAXK, EXACT, CHUNKS><<<blocks, kThreads, 0, s>>>(
        sel, m, k, rows, a);
}

}  // namespace

extern "C" {

// masks: host array of m * 8 words, masks[i * 8 + b] as in Selection.
// vec: 1 when data, out and both row strides are 16-byte aligned.
// rows, grid: the launch shape rs_cuda.launch_shape chooses (output rows
// per block, blocks along the columns); a thread takes two 16-byte pieces
// per grid-stride step for k <= 16, one otherwise.
// Launches on `stream` without synchronising; returns cudaGetLastError().
int gf_apply_launch(const uint32_t* masks, int m, int k, const void* data,
                    int64_t data_stride, void* out, int64_t out_stride,
                    int64_t n, int vec, int rows, int grid, void* stream) {
    if (m < 1 || m > kMaxRows || k < 1 || k > kMaxCols || n < 0 ||
        rows < 1 || grid < 1)
        return (int)cudaErrorInvalidValue;
    Selection sel;
    for (int t = 0; t < kMaxRows * 8; t++) sel.mask[t] = t < m * 8 ? masks[t] : 0u;
    const Args a{static_cast<const uint8_t*>(data), data_stride,
                 static_cast<uint8_t*>(out), out_stride, n, vec};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (k) {
#define GF_EXACT_CASE(K)                                      \
    case K:                                                   \
        launch<K, true, 2>(sel, m, K, a, rows, grid, s);      \
        break;
        GF_EXACT_CASE(1) GF_EXACT_CASE(2) GF_EXACT_CASE(3) GF_EXACT_CASE(4)
        GF_EXACT_CASE(5) GF_EXACT_CASE(6) GF_EXACT_CASE(7) GF_EXACT_CASE(8)
        GF_EXACT_CASE(9) GF_EXACT_CASE(10) GF_EXACT_CASE(11) GF_EXACT_CASE(12)
        GF_EXACT_CASE(13) GF_EXACT_CASE(14) GF_EXACT_CASE(15) GF_EXACT_CASE(16)
#undef GF_EXACT_CASE
        default:  // two pieces per thread would spill at 32 inputs
            launch<kMaxCols, false, 1>(sel, m, k, a, rows, grid, s);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
