// K2 on Hopper: the GF(2^8) matrix apply as a GF(2) product on the int8
// tensor cores, issued as warpgroup products (wgmma).
//
//   out[i][c] = XOR_j M[i][j] * data[j][c]   over GF(2^8), poly 0x11D
//
// Replaces the Pallas TPU kernel seaweedfs_tpu/ops/rs_mxu.py (_make_kernel,
// launched by mxu_apply_fn). GF(2^8) multiplication is linear over GF(2),
// so the transform is one binary matrix B (8m x 8k) acting on bit planes:
// bit r of out[i][c] = XOR over (j, b) of B[8i+r][8j+b] & (bit b of
// data[j][c]), with B[8i+r][8j+b] = bit r of M[i][j] * 2^b. The kernel
// forms the product transposed, Y^T = X^T . B^T, with
// wgmma.mma_async.m64nNk32.s32.s8.s8: positions are the M dimension (64 a
// tile), input planes 8j+b the K dimension (32 a step: four input rows),
// output planes the N dimension (N = 8m padded to a valid int8 width, so
// one instruction per K step covers every output row).
//
// What bounds it. Bytes on paper: (k + m) * n of HBM traffic (70 us for
// RS(10,4) at 16 MiB a row at 3.35 TB/s) against 128 * m * k * n int8
// operations (43 us at 1,979 TOP/s). In practice the integer pipes: every
// input bit has to be spread into a byte of 0 or 1 before the tensor
// cores see it, and every output byte gathered from eight int32 sums, and
// those are integer instructions (permute, multiply, logic) on every
// position, which an SM issues at half a warp instruction per clock per
// scheduler on each of its two integer pipes. The tensor cores and the
// copies are far from busy. So the design keeps those instructions few
// and keeps everything else off the SM's critical path:
// - A from registers. The wgmma register fragment of A is, per warp, the
//   m16k32 layout of mma.sync: register 2h+s of lane (g, t) holds K
//   columns 16h+4t..16h+4t+3 of row g+8s, which are one nibble of one
//   input byte, spread over four bytes (bit 0 of each is one bit) with one
//   permute (or high multiply) and one multiply; the products only need
//   each A byte's parity. No 8x expanded copy exists. Tile
//   rows map to positions so that row r of tile q (q = 0..3) is position
//   4r+q of a 256-position super-tile: one 32-bit shared load then serves
//   the same lane in all four tiles.
// - B from shared memory, built on the host once per matrix (rs_mxu.
//   bitplane_image) and copied in at block start: the bit-plane matrix
//   itself, K-major, which is the only operand order int8 wgmma takes.
// - Tiles in pairs: the second tile's A is built while the first's
//   products run; one wait per pair. The accumulator keeps the mma.sync
//   quad layout per n8 chunk (sums c0, c1 of lane (g, t) are bits 2t,
//   2t+1 of the output byte at row g, c2, c3 the same at row g+8), so a
//   byte permute moves the low bytes of a pair's sums into one word, one
//   byte per tile, and after both pairs a lane holds, for each output row
//   and row half, its two bits of four output bytes. Two xor-shuffle
//   rounds over the quad (a reduce-scatter) leave each lane whole words:
//   four consecutive output bytes of one row, one 32-bit shared store.
// - Persistent and pipelined: a grid of blocks of one warpgroup, as many
//   per SM as fit, walks over 1024-position stages; the k input rows of
//   each stage arrive in a ring of four stages by cp.async (16-byte copies,
//   commit/wait groups), so three stages are in flight while one is
//   multiplied. Outputs are staged in shared memory and written with
//   16-byte stores.
//
// Trouble spots and what the design does about them:
// - The descriptor. B lies in no-swizzle ("interleave") core matrices of 8
//   rows x 16 bytes; for a K-major operand the leading byte offset (LBO) is
//   the step between the two 16-byte K halves of a K step (128 bytes) and
//   the stride byte offset (SBO) the step between groups of 8 N rows (256
//   bytes), as CUTLASS's make_gmma_desc<Major::K> describes the INTERLEAVE
//   layout ((8,m),(T,2)):((1T,SBO),(1,LBO)). Layout type 0, base offset 0.
// - Widths. Valid int8 N are 8, 16, 24, 32 and multiples of 16 up to 256:
//   m = 5 and 7 pad N with zero rows that are never stored, m > 8 takes
//   N = 128. K = 8k is padded to 32 * (1, 2, 3, 4 or 8) steps with zero
//   columns of B; the lanes that would read input rows j >= k read row k-1
//   instead, whose products those zero columns cancel.
// - Ring edges. Each stage is its own cp.async group and a block commits a
//   group every iteration, empty or not, so wait_group 3 always means "this
//   stage has landed". A slot is refilled only after the barrier that ends
//   the stage read from it.
// - The ragged tail. Positions past n in the last stage are zero-filled by
//   the copy (its source size is cut), computed and never stored.
// - Unaligned rows (any row stride, any base): the stage is filled with
//   byte loads instead of cp.async and written back byte by byte, so the
//   caller pads nothing.
// - Exactness. A sum has at most 8k <= 256 terms, each an int8 A byte
//   times 0 or 1, exact in int32; its parity, bit 0 of its low byte, is
//   the GF(2) sum of the A bytes' bit 0 where B is 1.
// - Asynchrony. wgmma reads its A registers and writes its accumulator
//   after the instruction issues. Each pair's products are waited for
//   before those registers are read or rebuilt, and an empty asm on every
//   such register (pin) keeps the compiler from moving an access across
//   the fence, issue or wait. Packing the sums with integer multiply-adds
//   instead of byte permutes was tried: the compiled code then held dummy
//   products in place of the first pair's and the results were wrong, so
//   the permutes stay. B's image is written by ordinary stores and fenced to the async
//   proxy before the first product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;   // m: outputs per launch
constexpr int kMaxCols = 32;   // k: inputs per launch
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStage = 1024;   // positions per ring stage
constexpr int kStages = 4;     // ring depth
constexpr int kSuper = 256;    // positions per warpgroup super-tile
constexpr int kPieces = kStage / 16;
// Row pitches: 16-byte aligned for the copies; rows 8 banks apart on the
// input side (a load instruction spans 32 bytes of two rows) and 16 on
// the output side (64 bytes of two rows), so neither conflicts.
constexpr int kXPitch = kStage + 32;
constexpr int kYPitch = kStage + 64;
constexpr int kLbo = 128;  // bytes between the two K halves of a K step
constexpr int kSbo = 256;  // bytes between groups of 8 N rows

struct Args {
    const uint8_t* image;  // B as bitplane_image lays it out in shared memory
    const uint8_t* data;
    int64_t data_stride;
    uint8_t* out;
    int64_t out_stride;
    int64_t n;
    int m;
    int k;
    int vec;
};

template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
    __device__ __forceinline__ static void mma(int (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
            "%0, %1, %2, %3"
            "}, {%4, %5, %6, %7}, %8, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(scale_d)
            : "memory");
    }
};

template <>
struct Wgmma<16> {
    __device__ __forceinline__ static void mma(int (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7"
            "}, {%8, %9, %10, %11}, %12, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(scale_d)
            : "memory");
    }
};

template <>
struct Wgmma<24> {
    __device__ __forceinline__ static void mma(int (&d)[12],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7,"
            "%8, %9, %10, %11"
            "}, {%12, %13, %14, %15}, %16, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(scale_d)
            : "memory");
    }
};

template <>
struct Wgmma<32> {
    __device__ __forceinline__ static void mma(int (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7,"
            "%8, %9, %10, %11, %12, %13, %14, %15"
            "}, {%16, %17, %18, %19}, %20, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(scale_d)
            : "memory");
    }
};

template <>
struct Wgmma<48> {
    __device__ __forceinline__ static void mma(int (&d)[24],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7,"
            "%8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23"
            "}, {%24, %25, %26, %27}, %28, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
              "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(scale_d)
            : "memory");
    }
};

template <>
struct Wgmma<64> {
    __device__ __forceinline__ static void mma(int (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7,"
            "%8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23,"
            "%24, %25, %26, %27, %28, %29, %30, %31"
            "}, {%32, %33, %34, %35}, %36, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
              "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
              "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(scale_d)
            : "memory");
    }
};

template <>
struct Wgmma<128> {
    __device__ __forceinline__ static void mma(int (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7,"
            "%8, %9, %10, %11, %12, %13, %14, %15,"
            "%16, %17, %18, %19, %20, %21, %22, %23,"
            "%24, %25, %26, %27, %28, %29, %30, %31,"
            "%32, %33, %34, %35, %36, %37, %38, %39,"
            "%40, %41, %42, %43, %44, %45, %46, %47,"
            "%48, %49, %50, %51, %52, %53, %54, %55,"
            "%56, %57, %58, %59, %60, %61, %62, %63"
            "}, {%64, %65, %66, %67}, %68, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
              "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
              "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
              "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
              "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
              "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
              "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
              "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
              "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
              "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
              "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(scale_d)
            : "memory");
    }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// No-swizzle K-major matrix descriptor of the operand at shared address addr.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)(kLbo >> 4) << 16) | ((uint64_t)(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// An empty asm that reads and writes each register: the compiler keeps
// every access of r before it on its side of the neighbouring wgmma
// fence, issue or wait.
template <int R>
__device__ __forceinline__ void pin(int (&r)[R]) {
#pragma unroll
    for (int i = 0; i < R; i++) asm volatile("" : "+r"(r[i])::"memory");
}

template <int KC>
__device__ __forceinline__ void pin(uint32_t (&r)[KC][4]) {
#pragma unroll
    for (int c = 0; c < KC; c++)
#pragma unroll
        for (int e = 0; e < 4; e++) asm volatile("" : "+r"(r[c][e])::"memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
}

// The nibble in byte q of y (y holds one nibble per byte) spread over
// four bytes: bit 0 of byte e is bit e of the nibble. The four copies of
// the nibble that the multiply adds (shifts 0, 7, 14, 21) do not overlap,
// so no carry reaches those bits. The other bits of each byte are left
// as they fall: B is 0 or 1, so a sum's parity depends only on bit 0 of
// each A byte, signed or not.
__device__ __forceinline__ uint32_t spread(uint32_t y, int q) {
    // byte 3 by a high multiply (the multiply pipe), the others by permute
    const uint32_t n = q == 3 ? __umulhi(y, 0x100u) : __byte_perm(y, 0, 0x4440 | q);
    return n * 0x00204081u;
}

// Stage `tile` of the input rows into ring slot xs: cp.async where rows
// are 16-byte aligned (the tail's source size cut, the rest zero-filled),
// byte loads otherwise.
__device__ __forceinline__ void load_stage(const Args& a, uint8_t* xs,
                                           int64_t tile) {
    const int64_t p0 = tile * kStage;
    const int valid = (int)min((int64_t)kStage, a.n - p0);
    for (int q = threadIdx.x; q < a.k * kPieces; q += kThreads) {
        const int j = q / kPieces, o = (q % kPieces) * 16;
        const uint8_t* row = a.data + (int64_t)j * a.data_stride + p0;
        uint8_t* dst = xs + j * kXPitch + o;
        if (a.vec) {
            const int bytes = max(0, min(16, valid - o));
            cp_async16(dst, row + (bytes ? o : 0), bytes);
        } else {
            uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
            for (int s = 0; s < 16; s++) {
                if (o + s < valid) w[s >> 2] |= (uint32_t)row[o + s] << (8 * (s & 3));
            }
            *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
    }
}

// Builds the A registers of tile q (register 2h+s of K step c: nibble
// `half` of input row 4c+2h+pair at position 4(16wr+g+8s)+q) and issues
// the tile's KC chained products into d, as one wgmma group.
template <int NW, int KC>
__device__ __forceinline__ void issue_tile(int (&d)[NW / 2],
                                           uint32_t (&af)[KC][4],
                                           const uint32_t (&y)[KC][2][2],
                                           int q, uint64_t desc0) {
#pragma unroll
    for (int c = 0; c < KC; c++)
#pragma unroll
        for (int h = 0; h < 2; h++) {
            af[c][2 * h] = spread(y[c][h][0], q);      // row g
            af[c][2 * h + 1] = spread(y[c][h][1], q);  // row g + 8
        }
    pin(af);  // A written, and d's last reads done, before the fence
    pin(d);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC; c++)
        Wgmma<NW>::mma(d, af[c], desc0 + ((c * NW * 32) >> 4), c > 0);
    wgmma_commit();
}

// NW: N of the product (8m padded to a valid int8 width).
// KC: K steps of 32 planes.
template <int NW, int KC>
__global__ void __launch_bounds__(kThreads)
mxu_apply_kernel(const Args a) {
    constexpr int kRows = NW / 8;  // output rows the product covers
    constexpr int kPairs = (kRows + 1) / 2;
    constexpr int kImage = NW * 32 * KC;
    extern __shared__ __align__(128) uint8_t smem[];
    uint8_t* bimg = smem;                        // [KC][NW/8][2][8][16]
    uint8_t* xs = smem + kImage;                 // [kStages][k][kXPitch]
    uint8_t* ys = xs + kStages * a.k * kXPitch;  // [m][kYPitch]

    const int lane = threadIdx.x & 31;
    const int wr = threadIdx.x >> 5;  // warp within the warpgroup
    const int g = lane >> 2, t = lane & 3;
    const int half = t & 1, pair = t >> 1;

    for (int o = threadIdx.x * 16; o < kImage; o += kThreads * 16)
        *reinterpret_cast<uint4*>(bimg + o) =
            __ldg(reinterpret_cast<const uint4*>(a.image + o));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint64_t desc0 = b_desc(smem_addr(bimg));

    const int64_t tiles = (a.n + kStage - 1) / kStage;
    const int64_t mine = blockIdx.x < tiles
        ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    for (int s = 0; s < kStages - 1; s++) {
        if (s < mine)
            load_stage(a, xs + s * a.k * kXPitch,
                       blockIdx.x + (int64_t)s * gridDim.x);
        cp_async_commit();
    }

    // Shared offset of the input row (4c+2h+pair) a lane reads for K step
    // c and half h, at its first position 4(16wr+g). Rows j >= k meet zero
    // columns of B, so they read row k-1 instead: any finite bytes will do.
    int row_off[KC][2];
#pragma unroll
    for (int c = 0; c < KC; c++)
#pragma unroll
        for (int h = 0; h < 2; h++)
            row_off[c][h] = min(4 * c + 2 * h + pair, a.k - 1) * kXPitch +
                            4 * (16 * wr + g);

    int acc[NW / 2], acc2[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; i++) acc[i] = acc2[i] = 0;

    for (int64_t it = 0; it < mine; it++) {
        const int64_t ahead = it + kStages - 1;
        if (ahead < mine)
            load_stage(a, xs + (ahead % kStages) * a.k * kXPitch,
                       blockIdx.x + ahead * gridDim.x);
        cp_async_commit();
        cp_async_wait_ring();
        __syncthreads();  // this stage landed for every thread; B is set up

        const int64_t p0 = (blockIdx.x + it * gridDim.x) * kStage;
        const int valid = (int)min((int64_t)kStage, a.n - p0);
        const uint8_t* x = xs + (it % kStages) * a.k * kXPitch;
        for (int base = 0; base < valid; base += kSuper) {
            // y[c][h][s]: input row 4c+2h+pair at positions 4(16wr+g+8s)..+3,
            // the lane's nibble moved to the low half of each byte.
            uint32_t y[KC][2][2];
#pragma unroll
            for (int c = 0; c < KC; c++)
#pragma unroll
                for (int h = 0; h < 2; h++)
#pragma unroll
                    for (int s = 0; s < 2; s++) {
                        const uint32_t w = *reinterpret_cast<const uint32_t*>(
                            x + row_off[c][h] + base + 32 * s);
                        y[c][h][s] = (w >> (4 * half)) & 0x0F0F0F0Fu;
                    }
            // Tiles in pairs (2pr, 2pr+1): the second's A is built while the
            // first's products run, and the pair's sums are gathered
            // together. bit[i][s][e], byte q: the low byte of sum c_e of
            // tile q at output row i, row half s (the lane's output bit
            // 2t+e); its bit 0 is the GF(2) sum.
            uint32_t bit[kRows][2][2];
            uint32_t af0[KC][4], af1[KC][4];
#pragma unroll
            for (int pr = 0; pr < 2; pr++) {
                issue_tile<NW, KC>(acc, af0, y, 2 * pr, desc0);
                issue_tile<NW, KC>(acc2, af1, y, 2 * pr + 1, desc0);
                wgmma_wait<0>();
                pin(acc);  // no read of the sums above the wait
                pin(acc2);
                pin(af0);  // A untouched until its products are done
                pin(af1);
#pragma unroll
                for (int i = 0; i < kRows; i++)
#pragma unroll
                    for (int s = 0; s < 2; s++)
#pragma unroll
                        for (int e = 0; e < 2; e++) {
                            const int r = 4 * i + 2 * s + e;
                            // low bytes of the pair's sums into bytes 2pr, 2pr+1
                            const uint32_t v = __byte_perm(
                                (uint32_t)acc[r], (uint32_t)acc2[r],
                                pr ? 0x4000 : 0x0040);
                            bit[i][s][e] = pr ? __byte_perm(bit[i][s][e], v, 0x7610) : v;
                        }
            }
            // Reduce-scatter over the quad: a lane's word for row i and row
            // half s holds bits 2t, 2t+1 of four output bytes; after the
            // xor-1 round a lane holds row half `half` of every row, after
            // the xor-2 round whole words of rows 2pi + `pair`.
            uint32_t one[kRows];
#pragma unroll
            for (int i = 0; i < kRows; i++) {
                uint32_t w[2];
#pragma unroll
                for (int s = 0; s < 2; s++)
                    w[s] = (((bit[i][s][1] & 0x01010101u) << 1) |
                            (bit[i][s][0] & 0x01010101u)) << (2 * t);
                const uint32_t keep = half ? w[1] : w[0];
                const uint32_t send = half ? w[0] : w[1];
                one[i] = keep | __shfl_xor_sync(0xFFFFFFFFu, send, 1);
            }
#pragma unroll
            for (int pi = 0; pi < kPairs; pi++) {
                const uint32_t lo = one[2 * pi];
                const uint32_t hi =
                    2 * pi + 1 < kRows ? one[min(2 * pi + 1, kRows - 1)] : 0u;
                const uint32_t keep = pair ? hi : lo;
                const uint32_t send = pair ? lo : hi;
                const uint32_t word = keep | __shfl_xor_sync(0xFFFFFFFFu, send, 2);
                const int i = 2 * pi + pair;
                if (i < a.m)
                    *reinterpret_cast<uint32_t*>(
                        ys + i * kYPitch + base + 4 * (16 * wr + g + 8 * half)) = word;
            }
        }
        __syncthreads();  // ys complete; the ring slot is free again

        for (int q = threadIdx.x; q < a.m * kPieces; q += kThreads) {
            const int i = q / kPieces, o = (q % kPieces) * 16;
            if (o >= valid) continue;
            uint8_t* dst = a.out + (int64_t)i * a.out_stride + p0 + o;
            const uint8_t* src = ys + i * kYPitch + o;
            if (a.vec && o + 16 <= valid) {
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
                for (int s = 0; o + s < valid && s < 16; s++) dst[s] = src[s];
            }
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int NW, int KC>
int launch(const Args& a, int sm_count, cudaStream_t s) {
    const size_t smem = (size_t)NW * 32 * KC +
                        (size_t)kStages * a.k * kXPitch + (size_t)a.m * kYPitch;
    cudaError_t err = cudaFuncSetAttribute(
        mxu_apply_kernel<NW, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mxu_apply_kernel<NW, KC>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t tiles = (a.n + kStage - 1) / kStage;
    const int64_t cap = (int64_t)(per_sm > 0 ? per_sm : 1) * sm_count;
    const int grid = (int)(tiles < cap ? tiles : cap);
    mxu_apply_kernel<NW, KC><<<grid, kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
}

template <int NW>
int launch_k(int ksteps, const Args& a, int sm_count, cudaStream_t s) {
    switch (ksteps) {
        case 1: return launch<NW, 1>(a, sm_count, s);
        case 2: return launch<NW, 2>(a, sm_count, s);
        case 3: return launch<NW, 3>(a, sm_count, s);
        case 4: return launch<NW, 4>(a, sm_count, s);
        case 8: return launch<NW, 8>(a, sm_count, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// image: device pointer to B laid out as rs_mxu.bitplane_image lays it
// out for (width, ksteps): width = the product's N (8m padded to a valid
// int8 width, 128 for m > 8), ksteps = K steps of 32 planes.
// vec: 1 when data, out and both row strides are 16-byte aligned.
// sm_count: the device's multiprocessors; the grid is one resident wave.
// Launches on `stream` without synchronising; returns a CUDA error code.
int mxu_apply_launch(const void* image, int width, int ksteps, int m, int k,
                     const void* data, int64_t data_stride, void* out,
                     int64_t out_stride, int64_t n, int vec, int sm_count,
                     void* stream) {
    if (m < 1 || m > kMaxRows || k < 1 || k > kMaxCols || n < 0 ||
        sm_count < 1 || width < 8 * m || 32 * ksteps < 8 * k)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const Args a{static_cast<const uint8_t*>(image),
                 static_cast<const uint8_t*>(data), data_stride,
                 static_cast<uint8_t*>(out), out_stride, n, m, k, vec};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (width) {
        case 8: return launch_k<8>(ksteps, a, sm_count, s);
        case 16: return launch_k<16>(ksteps, a, sm_count, s);
        case 24: return launch_k<24>(ksteps, a, sm_count, s);
        case 32: return launch_k<32>(ksteps, a, sm_count, s);
        case 48: return launch_k<48>(ksteps, a, sm_count, s);
        case 64: return launch_k<64>(ksteps, a, sm_count, s);
        case 128: return launch_k<128>(ksteps, a, sm_count, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
