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
//
// The batch entry (gf_apply_batch_launch). A batch of B independent jobs,
// (B, k, n) -> (B, m, n), in one launch whatever B and n are: the jobs of
// concurrent volume encodes or rebuilds that the EC batch scheduler
// coalesced. It replaces B launches of the single entry, so the fixed cost
// of a launch is paid once per batch, not once per job. The same column
// body runs per job; blockIdx.z picks the job. The grid's y and z extents
// are at most 65535 each: y is the row split (at most kMaxRows), z is
// min(B, 65535), and a job-stride loop over blockIdx.z takes jobs past it,
// so any B fits. Jobs and rows may have any stride (16-byte aligned ones
// take the vector path).
// Matrices. An encode batch shares one matrix: its masks go by value in
// the parameter space, as above. A rebuild batch has one matrix per job,
// m * 8 words each: 512 bytes a job for m = 16, 32 KiB at B = 64, beyond
// the 4 KiB parameter space. Those masks live in device memory, (B, m*8)
// words, which the wrapper uploads on the launch stream from pinned host
// memory without synchronising with the card; a job with fewer rows than
// m has zero masks in the rest, which give zero rows. Each block copies
// its job's masks into shared memory before the Horner chain (and the
// shared matrix's too, so both read masks one way); the branches on them
// stay uniform per block.
// What bounds a batched launch: bytes, B * (k + m) * n of HBM traffic,
// with the single entry's per-byte instruction cost; the launch's fixed
// cost is now one per batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;   // m: outputs per launch
constexpr int kMaxCols = 32;   // k: inputs per launch (one 32-bit mask)
constexpr int kThreads = 128;  // rs_cuda.THREADS
constexpr int kMaxGridZ = 65535;  // the card's limit on gridDim.z (and y)

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

// The column loop of one job: output rows [i0, i1) of mask (m * 8 words,
// mask[i * 8 + b] as in Selection) applied to data's k rows over n
// columns, a grid-stride loop over blockIdx.x. MAXK: register slots for
// inputs; EXACT: k == MAXK (every `j < k` folds away); CHUNKS: 16-byte
// pieces per thread per grid-stride step.
template <int MAXK, bool EXACT, int CHUNKS>
__device__ __forceinline__ void apply_columns(
        const uint32_t* mask, int k_arg, int i0, int i1, const uint8_t* data,
        int64_t data_stride, uint8_t* out, int64_t out_stride, int64_t n,
        int vec) {
    const int k = EXACT ? MAXK : k_arg;
    const int64_t chunks = (n + 15) >> 4;
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
            len[u] = c < chunks ? (int)min((int64_t)16, n - col[u]) : 0;
            full[u] = vec && len[u] == 16;
#pragma unroll
            for (int j = 0; j < MAXK; j++) {
                d[u][j] = make_uint4(0, 0, 0, 0);
                if (j < k && len[u] > 0) {
                    const uint8_t* p = data + (int64_t)j * data_stride + col[u];
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
                const uint32_t sel = mask[i * 8 + b];
#pragma unroll
                for (int j = 0; j < MAXK; j++) {
                    if (j < k && ((sel >> j) & 1u)) {
#pragma unroll
                        for (int u = 0; u < CHUNKS; u++) xor4(acc[u], d[u][j]);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < CHUNKS; u++) {
                uint8_t* q = out + (int64_t)i * out_stride + col[u];
                if (full[u]) {
                    *reinterpret_cast<uint4*>(q) = acc[u];
                } else if (len[u] > 0) {
                    store_partial(q, acc[u], len[u]);
                }
            }
        }
    }
}

// The single entry: block y computes output rows [y * rows, y * rows + rows).
template <int MAXK, bool EXACT, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const __grid_constant__ Selection sel, int m, int k, int rows,
                const Args a) {
    const int i0 = blockIdx.y * rows;
    apply_columns<MAXK, EXACT, CHUNKS>(sel.mask, k, i0, min(m, i0 + rows),
                                       a.data, a.data_stride, a.out,
                                       a.out_stride, a.n, a.vec);
}

struct Batch {
    const uint32_t* job_masks;  // device (batch, m * 8) words, or null
    int batch;
    int64_t job_stride;         // bytes between jobs' first input rows
    int64_t out_job_stride;     // bytes between jobs' first output rows
};

// The batch entry: block (x, y, z) runs apply_columns for jobs z,
// z + gridDim.z, ... with its job's masks in shared memory.
template <int MAXK, bool EXACT, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
gf_apply_batch_kernel(const __grid_constant__ Selection sel, int m, int k,
                      int rows, const Args a, const Batch bt) {
    __shared__ uint32_t mask[kMaxRows * 8];
    const int i0 = blockIdx.y * rows;
    const int i1 = min(m, i0 + rows);
    if (bt.job_masks == nullptr) {
        for (int t = threadIdx.x; t < m * 8; t += kThreads) mask[t] = sel.mask[t];
        __syncthreads();
    }
    for (int job = blockIdx.z; job < bt.batch; job += gridDim.z) {
        if (bt.job_masks != nullptr) {
            __syncthreads();  // every thread is done with the last job's masks
            const uint32_t* src = bt.job_masks + (int64_t)job * m * 8;
            for (int t = threadIdx.x; t < m * 8; t += kThreads) mask[t] = src[t];
            __syncthreads();
        }
        apply_columns<MAXK, EXACT, CHUNKS>(
            mask, k, i0, i1, a.data + job * bt.job_stride, a.data_stride,
            a.out + job * bt.out_job_stride, a.out_stride, a.n, a.vec);
    }
}

struct SingleLaunch {
    const Selection& sel;
    int m, k;
    const Args& a;
    int rows, grid;
    cudaStream_t s;
    template <int MAXK, bool EXACT, int CHUNKS>
    void run() const {
        const dim3 blocks(grid, (m + rows - 1) / rows);
        gf_apply_kernel<MAXK, EXACT, CHUNKS><<<blocks, kThreads, 0, s>>>(
            sel, m, k, rows, a);
    }
};

struct BatchLaunch {
    const Selection& sel;
    int m, k;
    const Args& a;
    const Batch& bt;
    int rows, grid, grid_z;
    cudaStream_t s;
    template <int MAXK, bool EXACT, int CHUNKS>
    void run() const {
        const dim3 blocks(grid, (m + rows - 1) / rows, grid_z);
        gf_apply_batch_kernel<MAXK, EXACT, CHUNKS><<<blocks, kThreads, 0, s>>>(
            sel, m, k, rows, a, bt);
    }
};

// Runs l.run<MAXK, EXACT, CHUNKS>() for the instantiation that serves k:
// k exact for k <= 16 with two pieces per thread, else the generic one
// with one piece (two would spill at 32 inputs).
template <typename L>
void dispatch_k(int k, const L& l) {
    switch (k) {
#define GF_EXACT_CASE(K)                        \
    case K:                                     \
        l.template run<K, true, 2>();           \
        break;
        GF_EXACT_CASE(1) GF_EXACT_CASE(2) GF_EXACT_CASE(3) GF_EXACT_CASE(4)
        GF_EXACT_CASE(5) GF_EXACT_CASE(6) GF_EXACT_CASE(7) GF_EXACT_CASE(8)
        GF_EXACT_CASE(9) GF_EXACT_CASE(10) GF_EXACT_CASE(11) GF_EXACT_CASE(12)
        GF_EXACT_CASE(13) GF_EXACT_CASE(14) GF_EXACT_CASE(15) GF_EXACT_CASE(16)
#undef GF_EXACT_CASE
        default:
            l.template run<kMaxCols, false, 1>();
    }
}

Selection host_selection(const uint32_t* masks, int m) {
    Selection sel;
    for (int t = 0; t < kMaxRows * 8; t++)
        sel.mask[t] = masks != nullptr && t < m * 8 ? masks[t] : 0u;
    return sel;
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
    const Selection sel = host_selection(masks, m);
    const Args a{static_cast<const uint8_t*>(data), data_stride,
                 static_cast<uint8_t*>(out), out_stride, n, vec};
    dispatch_k(k, SingleLaunch{sel, m, k, a, rows, grid,
                               static_cast<cudaStream_t>(stream)});
    return (int)cudaGetLastError();
}

// The batch entry, one launch for `batch` jobs: job b reads k rows at
// data + b * job_stride (rows row_stride apart) and writes m rows at
// out + b * out_job_stride (rows out_row_stride apart).
// per_job = 0: masks is a host array of m * 8 words shared by every job,
// passed by value as in gf_apply_launch. per_job = 1: masks is a device
// array of batch * m * 8 words, job b's at masks + b * m * 8, already
// enqueued on `stream` (the kernel reads it there).
// vec: 1 when data, out, both row strides and both job strides are
// 16-byte aligned. rows, grid, grid_z: rs_cuda.batch_launch_shape's
// choice; grid_z <= 65535 (the card's limit on gridDim.z), and jobs past
// it are taken by the kernel's job-stride loop.
// Launches on `stream` without synchronising; returns cudaGetLastError().
int gf_apply_batch_launch(const uint32_t* masks, int per_job, int m, int k,
                          int batch, const void* data, int64_t job_stride,
                          int64_t row_stride, void* out,
                          int64_t out_job_stride, int64_t out_row_stride,
                          int64_t n, int vec, int rows, int grid,
                          int grid_z, void* stream) {
    if (m < 1 || m > kMaxRows || k < 1 || k > kMaxCols || n < 0 ||
        batch < 1 || rows < 1 || grid < 1 || grid_z < 1 ||
        grid_z > kMaxGridZ || masks == nullptr)
        return (int)cudaErrorInvalidValue;
    const Selection sel = host_selection(per_job ? nullptr : masks, m);
    const Args a{static_cast<const uint8_t*>(data), row_stride,
                 static_cast<uint8_t*>(out), out_row_stride, n, vec};
    const Batch bt{per_job ? masks : nullptr, batch, job_stride,
                   out_job_stride};
    dispatch_k(k, BatchLaunch{sel, m, k, a, bt, rows, grid, grid_z,
                              static_cast<cudaStream_t>(stream)});
    return (int)cudaGetLastError();
}

}  // extern "C"
