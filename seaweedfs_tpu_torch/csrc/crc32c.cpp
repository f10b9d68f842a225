// CRC32-C (Castagnoli), the needle checksum: Go's hash/crc32 Castagnoli
// table, as reference weed/storage/needle/crc.go:13 uses it. Hardware
// SSE4.2 crc32q where the CPU has it, else table-driven slicing-by-8.
// Plain C interface, loaded with ctypes by utils/crc.py; built with
//   g++ -O3 -shared -fPIC -o libcrc32c.so crc32c.cpp

#include <cstdint>
#include <mutex>

#if defined(__x86_64__) || defined(_M_X64)
#define CRC_X86 1
#include <immintrin.h>
#endif

extern "C" {

static uint32_t crc_tab[8][256];
static std::once_flag crc_init_flag;

static void crc_init_impl() {
    const uint32_t poly = 0x82f63b78u;  // reflected 0x1EDC6F41
    for (int i = 0; i < 256; i++) {
        uint32_t c = (uint32_t)i;
        for (int kk = 0; kk < 8; kk++)
            c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
        crc_tab[0][i] = c;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t c = crc_tab[0][i];
        for (int t = 1; t < 8; t++) {
            c = crc_tab[0][c & 0xff] ^ (c >> 8);
            crc_tab[t][i] = c;
        }
    }
}

static void crc_init() { std::call_once(crc_init_flag, crc_init_impl); }

#ifdef CRC_X86
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(uint32_t crc, const uint8_t* buf, int64_t len) {
    uint64_t c = ~crc;
    while (len >= 8 && ((uintptr_t)buf & 7)) {  // align to 8
        c = _mm_crc32_u8((uint32_t)c, *buf++);
        len--;
    }
    while (len >= 8) {
        c = _mm_crc32_u64(c, *(const uint64_t*)buf);
        buf += 8;
        len -= 8;
    }
    while (len-- > 0) c = _mm_crc32_u8((uint32_t)c, *buf++);
    return ~(uint32_t)c;
}
#endif  // CRC_X86

static uint32_t crc32c_sw(uint32_t crc, const uint8_t* buf, int64_t len) {
    crc_init();
    crc = ~crc;
    while (len >= 8) {
        crc ^= (uint32_t)buf[0] | ((uint32_t)buf[1] << 8) |
               ((uint32_t)buf[2] << 16) | ((uint32_t)buf[3] << 24);
        uint32_t hi = (uint32_t)buf[4] | ((uint32_t)buf[5] << 8) |
                      ((uint32_t)buf[6] << 16) | ((uint32_t)buf[7] << 24);
        crc = crc_tab[7][crc & 0xff] ^ crc_tab[6][(crc >> 8) & 0xff] ^
              crc_tab[5][(crc >> 16) & 0xff] ^ crc_tab[4][crc >> 24] ^
              crc_tab[3][hi & 0xff] ^ crc_tab[2][(hi >> 8) & 0xff] ^
              crc_tab[1][(hi >> 16) & 0xff] ^ crc_tab[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
    while (len-- > 0)
        crc = crc_tab[0][(crc ^ *buf++) & 0xff] ^ (crc >> 8);
    return ~crc;
}

uint32_t crc32c(uint32_t crc, const uint8_t* buf, int64_t len) {
#ifdef CRC_X86
    __builtin_cpu_init();
    if (__builtin_cpu_supports("sse4.2"))
        return crc32c_hw(crc, buf, len);
#endif
    return crc32c_sw(crc, buf, len);
}

}  // extern "C"
