"""The host-side layouts of the port's two Hopper kernels, on the CPU.

The kernels themselves run only on the card (chip_smoke.py holds them
byte for byte against their plain versions there). What surrounds them is
checked here: K2's shared-memory image of B (rs_mxu.bitplane_image) read
back through the descriptor's strides, a numpy model of K2's lane mapping
(which lane holds which position, input plane and output bit, the nibble
spread, the accumulate and the quad reduce-scatter) against
gf_apply_reference, and K1's launch shape (rs_cuda.launch_shape) against
the card's grid limits and its grid-stride cover. Tolerance: byte-exact.
"""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import rs_mxu as jmxu
from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_mxu, rs_torch

# K2's constants (csrc/mxu_apply.cu): ring stage, warpgroup super-tile.
STAGE, SUPER = 1024, 256


def _image_entry(image, width, c, n, kk):
    """The byte the kernel's descriptor for K step c addresses as
    B[n][plane 32c + kk]."""
    return image[c * width * 32 + (n // 8) * rs_mxu.IMAGE_SBO
                 + (kk // 16) * rs_mxu.IMAGE_LBO + (n % 8) * 16 + kk % 16]


def _matrices():
    rng = np.random.default_rng(40)
    mats = [(f"RS({k},{m})", gf256.parity_matrix(k, m))
            for k, m in ((10, 4), (6, 3), (12, 6))]
    mats.append(("random 16x32", rng.integers(0, 256, (16, 32), np.uint8)))
    for m, k in ((1, 1), (5, 7), (7, 13), (9, 17), (3, 29)):
        mats.append((f"random {m}x{k}", rng.integers(0, 256, (m, k), np.uint8)))
    return mats


@pytest.mark.parametrize("name,mat", _matrices(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_bitplane_image_reads_back_as_bitplane_matrix(name, mat):
    m, k = mat.shape
    width, steps = rs_mxu.wgmma_width(m), rs_mxu.k_steps(k)
    image = rs_mxu.bitplane_image(mat)
    assert image.dtype == np.uint8 and image.shape == (width * 32 * steps,)
    n_idx, k_idx = np.meshgrid(np.arange(width), np.arange(32 * steps),
                               indexing="ij")
    back = np.vectorize(lambda n, kk: _image_entry(
        image, width, kk // 32, n, kk % 32))(n_idx, k_idx)
    want = jmxu.bitplane_matrix(np.asarray(mat)).astype(np.uint8)
    assert np.array_equal(back[:8 * m, :8 * k], want)
    assert not back[8 * m:].any() and not back[:, 8 * k:].any()


@pytest.mark.parametrize("m,width", [(1, 8), (2, 16), (3, 24), (4, 32),
                                     (5, 48), (6, 48), (7, 64), (8, 64),
                                     (9, 128), (16, 128)])
def test_wgmma_width_is_a_valid_int8_n(m, width):
    assert rs_mxu.wgmma_width(m) == width


def _spread(y, q):
    return ((y >> np.uint32(8 * q)) & np.uint32(0xF)) * np.uint32(0x204081)


def _bytes_of(word):
    return [(int(word) >> (8 * e)) & 0xFF for e in range(4)]


def _int8s_of(word):
    """The four bytes of a register as wgmma's s8 operand reads them."""
    return [b - 256 if b >= 128 else b for b in _bytes_of(word)]


def k2_model(mat, data: np.ndarray) -> np.ndarray:
    """K2's arithmetic, lane by lane, as csrc/mxu_apply.cu lays it out:
    per stage and warpgroup super-tile, the 32-bit input words of each
    lane, the nibble spread into A registers, the m64 x N x 32 product per
    K step (A's rows from the m16k32 register layout as int8, B through the
    descriptor), the accumulator's quad layout, the lane words and the
    two-round reduce-scatter into the output staging rows."""
    m, k = mat.shape
    n = data.shape[1]
    width, steps = rs_mxu.wgmma_width(m), rs_mxu.k_steps(k)
    image = rs_mxu.bitplane_image(mat)
    bmat = np.zeros((32 * steps, width), dtype=np.int64)  # B as wgmma reads it
    for c in range(steps):
        for kk in range(32):
            for col in range(width):
                bmat[32 * c + kk, col] = _image_entry(image, width, c, col, kk)
    out = np.zeros((m, n), dtype=np.uint8)
    for p0 in range(0, n, STAGE):
        valid = min(STAGE, n - p0)
        xs = np.zeros((k, STAGE + 4), dtype=np.uint8)  # zero-filled tail
        xs[:, :valid] = data[:, p0:p0 + valid]
        ys = np.zeros((m, STAGE), dtype=np.uint8)
        for base in range(0, valid, SUPER):
            # lane state, indexed [warp][g][t]
            y = np.zeros((4, 8, 4, steps, 2, 2), dtype=np.uint32)
            for wr in range(4):
                for g in range(8):
                    for t in range(4):
                        for c in range(steps):
                            for h in range(2):
                                # rows past k read row k-1 (zero B columns)
                                j = min(4 * c + 2 * h + (t >> 1), k - 1)
                                for s in range(2):
                                    off = base + 4 * (16 * wr + g + 8 * s)
                                    w = np.uint32(int.from_bytes(
                                        xs[j, off:off + 4].tobytes(), "little"))
                                    y[wr, g, t, c, h, s] = (
                                        (w >> np.uint32(4 * (t & 1)))
                                        & np.uint32(0x0F0F0F0F))
            # bits[wr, g, t, i, s, e]: byte q = the low byte of the lane's
            # sum c_e of tile q at output row i, row half s (the byte permutes
            # of each tile pair)
            rows = width // 8
            bits = np.zeros((4, 8, 4, rows, 2, 2), dtype=np.uint32)
            for q in range(4):
                a_tile = np.zeros((64, 32 * steps), dtype=np.int64)
                for wr in range(4):
                    for g in range(8):
                        for t in range(4):
                            for c in range(steps):
                                for h in range(2):
                                    for s in range(2):
                                        reg = _spread(y[wr, g, t, c, h, s], q)
                                        col = 32 * c + 16 * h + 4 * t
                                        a_tile[16 * wr + g + 8 * s,
                                               col:col + 4] = _int8s_of(reg)
                d = a_tile @ bmat
                for wr in range(4):
                    for g in range(8):
                        for t in range(4):
                            for i in range(rows):
                                for s in range(2):
                                    for e in range(2):
                                        low = int(d[16 * wr + g + 8 * s,
                                                    8 * i + 2 * t + e]) & 0xFF
                                        bits[wr, g, t, i, s, e] |= np.uint32(
                                            low << (8 * q))
            c01 = np.uint32(0x01010101)
            for wr in range(4):
                for g in range(8):
                    def word(t, i, s):
                        b = bits[wr, g, t, i, s]
                        return ((((b[1] & c01) << np.uint32(1)) | (b[0] & c01))
                                << np.uint32(2 * t))
                    one = {}
                    for t in range(4):
                        half = t & 1
                        for i in range(rows):
                            pt = t ^ 1  # the xor-1 partner sends its other half
                            one[t, i] = word(t, i, half) | word(pt, i, half)
                    for t in range(4):
                        half, pair = t & 1, t >> 1
                        for pi in range((rows + 1) // 2):
                            def row_word(lane, r):
                                return one[lane, r] if r < rows else np.uint32(0)
                            keep = row_word(t, 2 * pi + pair)
                            pt = t ^ 2
                            send = row_word(pt, 2 * pi + ((pt >> 1) ^ 1))
                            i = 2 * pi + pair
                            if i < m:
                                off = base + 4 * (16 * wr + g + 8 * half)
                                ys[i, off:off + 4] = _bytes_of(keep | send)
        out[:, p0:p0 + valid] = ys[:, :valid]
    return out


@pytest.mark.parametrize("k,m,n", [(10, 4, 300), (6, 3, 1), (12, 6, 1031),
                                   (5, 7, 77), (3, 9, 70)])
def test_k2_lane_model_matches_gf_reference(k, m, n):
    rng = np.random.default_rng(k * 100 + m * 10 + n)
    mat = (gf256.parity_matrix(k, m) if (k, m) in ((10, 4), (6, 3), (12, 6))
           else rng.integers(0, 256, (m, k), dtype=np.uint8))
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    want = rs_torch.gf_apply_reference(mat, torch.from_numpy(data)).numpy()
    assert np.array_equal(k2_model(mat, data), want)


# --- K1's launch shape -----------------------------------------------------

H100_SMS = 132
MAX_THREADS, MAX_GRID_X, MAX_GRID_Y = 256, (1 << 31) - 1, 65535


def _cover(n, threads, chunks, grid):
    """How often K1's grid-stride loop visits each 16-byte piece, for one
    row of blocks (blockIdx.y is the output-row split)."""
    pieces = -(-n // 16)
    seen = np.zeros(pieces, dtype=np.int64)
    tile = threads * chunks
    lanes = np.arange(tile)  # u * threads + threadIdx.x
    for bx in range(grid):
        for t0 in range(bx * tile, pieces, grid * tile):
            c = t0 + lanes
            np.add.at(seen, c[c < pieces], 1)
    return seen


@pytest.mark.parametrize("n", [1, 15, 16, 4095, 1 << 20, (1 << 20) + 7,
                               16 << 20])
@pytest.mark.parametrize("m,k", [(4, 10), (6, 12), (3, 32)])
def test_k1_launch_shape_fits_the_card_and_covers_once(n, m, k):
    rows, grid = rs_cuda.launch_shape(m, k, n)
    threads, chunks = rs_cuda.THREADS, rs_cuda.pieces_per_thread(k)
    assert chunks == (2 if k <= 16 else 1)
    assert 32 <= threads <= MAX_THREADS and threads % 32 == 0
    assert 1 <= rows <= m and 1 <= grid <= MAX_GRID_X
    assert -(-m // rows) <= MAX_GRID_Y
    seen = _cover(n, threads, chunks, grid)
    assert seen.min() == 1 and seen.max() == 1
    if (1 << 20) <= n < 16 << 20:  # an encode batch fills every SM
        assert grid * -(-m // rows) >= H100_SMS


def _job_cover(batch, grid_z):
    """How often the batch kernel's job-stride loop over blockIdx.z
    visits each job."""
    seen = np.zeros(batch, dtype=np.int64)
    for z in range(grid_z):
        seen[z::grid_z] += 1
    return seen


@pytest.mark.parametrize("batch", [1, 2, 64, 65535, 65535 + 1])
@pytest.mark.parametrize("n", [4, 4100, 1 << 20])
@pytest.mark.parametrize("m,k", [(4, 10), (16, 32)])
def test_k1_batch_launch_fits_the_card_and_covers_once(batch, n, m, k):
    """Every (job, 16-byte piece) of a batch is visited exactly once, the
    grid's y and z extents stay within the card's 65535 (a batch of 65536
    folds its last job onto block z = 0), and a batch of one launches as
    the single entry does."""
    rows, grid, grid_z = rs_cuda.batch_launch_shape(m, k, n, batch)
    assert 1 <= rows <= m and 1 <= grid <= MAX_GRID_X
    assert -(-m // rows) <= MAX_GRID_Y and 1 <= grid_z <= MAX_GRID_Y
    assert grid_z == min(batch, rs_cuda.MAX_GRID_Z)
    jobs = _job_cover(batch, grid_z)
    assert jobs.min() == 1 and jobs.max() == 1
    seen = _cover(n, rs_cuda.THREADS, rs_cuda.pieces_per_thread(k), grid)
    assert seen.min() == 1 and seen.max() == 1
    if batch == 1:
        assert (rows, grid) == rs_cuda.launch_shape(m, k, n)
    if batch * n >= rs_cuda.SMALL_N_LIMIT:  # a big batch reads inputs once
        assert rows == m
