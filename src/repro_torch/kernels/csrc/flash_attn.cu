// Causal softmax attention with an online softmax, for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py::flash_attn
// (pallas_call at :96, body _flash_kernel at :25). For one (batch, head) and
// query row i, in float32:
//
//   s_ij = (q_i . k_j) * scale, s_ij = -1e30 where causal and j > i
//   m, l, acc carried over key tiles:  m' = max(m, max_j s_ij),
//   p = exp(s - m'), l = exp(m - m') l + sum_j p, acc = exp(m - m') acc + p v
//   out_i = acc / max(l, 1e-30), stored in the input's type
//
// Bound. Causal at the yi-6b shape (B2 H32 S4096 hd128) the two products
// take 2.75e11 flops: 0.28 ms at the bf16 tensor-core rate; the bytes (q, k,
// v read once, out written once) take 0.08 ms in bf16. So the card's bound
// is its arithmetic rate, and the products have to run on the tensor cores.
//
// Design. One block per (query tile of BM rows, batch*head), the heaviest
// causal tiles first, with a loop over key tiles inside the block in place
// of the TPU's sequential k grid dimension; key tiles wholly above the
// diagonal are skipped. The block is warp-specialised:
//
// - one producer warp (of a warpgroup that gives its registers to the
//   consumers with setmaxnreg) loads the query tile once and keeps a ring
//   of STAGES key and value tiles in shared memory, each completing on its own
//   mbarrier; the consumers free a stage on an `empty` mbarrier. Tiles are
//   stored in 128-byte-swizzled panels of 128 bytes per row (64 bf16 or 32
//   float32 columns), the layout TMA's SWIZZLE_128B writes and wgmma reads.
//   Where a TMA descriptor can describe the tensor (hd * itemsize a multiple
//   of 16 bytes, 16-byte-aligned bases) the loads are TMA tile copies
//   (cp.async.bulk.tensor, 3-D over (hd, S, B*H), so rows past S and
//   columns past hd arrive as zeros); otherwise the warp writes the same
//   layout with cp.async (4-byte copies, zero-filled past S and hd; 2-byte
//   loads for bf16 rows that are not 4-byte granular). The host picks the
//   path (flash_attn.py::launch_plan reports it).
// - consumer warps each owning 16 query rows (bf16), or 32 rows as two
//   16-row m-tiles (float32 up to hd 128). A thread holds two rows' scores
//   and output accumulator per m-tile in the wgmma accumulator layout
//   (value i: row lane/4 + 8 ((i/2)%2), column 8 (i/4) + 2 (lane%4) + i%2),
//   so the online softmax runs in registers with the row max and sum
//   reduced over 4 lanes by shuffles.
//   - bf16: each warpgroup (64 rows) computes S = Q K^T with wgmma.mma_async
//     (both operands K-major in shared memory, bf16 in, f32 accumulate),
//     turns P straight from the accumulator into wgmma's A register
//     fragment, as a bf16 pair hi + lo, and computes O += P_hi V + P_lo V
//     with wgmma, V read MN-major (trans-b) from the same swizzled tile.
//     The pair keeps P to ~2^-16; one bf16 P fails the one-ulp check of
//     the output on rows with few keys. S of key tile kt and P V of tile
//     kt - 1 are issued together, so the softmax of tile kt runs while the
//     tensor cores finish tile kt - 1.
//   - float32: mma.sync.m16n8k8 in TF32 with error compensation: each
//     operand is split as hi = tf32(x), lo = tf32(x - hi), and the product is
//     lo*hi + hi*lo + hi*hi in float32, close to float32's accuracy. For
//     P V the key order inside each k-step is permuted (slot t holds key
//     2t, slot t + 4 key 2t + 1), so the score fragment is the A fragment
//     without shuffles; the value fragment reads the same permutation.
//     Each key and value fragment is split once and feeds both m-tiles.
//   The fragment reads of the swizzled tiles are free of bank conflicts.
//
// Ragged S (rows and keys past S) and ragged hd are masked here, so the
// caller pads nothing. Tile sizes per (dtype, padded hd) are in FlashCfg;
// flash_attn.py::launch_plan mirrors them.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define FLASH_MAX_HD 256
#define FLASH_NEG_INF -1e30f
#define FLASH_STAGES 2
#define FLASH_ERR_ENCODE 1000       // + the CUresult of cuTensorMapEncodeTiled

template <typename T, int HDP>
struct FlashCfg {
    static constexpr bool BF16 = sizeof(T) == 2;
    // 16-row m-tiles per consumer warp: two for float32 (each key and value
    // fragment, split once, feeds both), one for bf16 (wgmma takes 64 rows).
    static constexpr int MT = (!BF16 && HDP <= 128) ? 2 : 1;
    static constexpr int BM = BF16 ? 128 : (HDP == 256 ? 64 : 256);   // query rows per block
    static constexpr int BN = BF16 ? (HDP == 256 ? 64 : 128) : (HDP == 64 ? 64 : 32);
    static constexpr int CONSUMER_WARPS = BM / (16 * MT);
    // + the producer warpgroup, whose registers setmaxnreg moves to the
    // consumers (one of its warps issues the loads).
    static constexpr int THREADS = CONSUMER_WARPS * 32 + 128;
    static constexpr int PW = 128 / (int)sizeof(T);                   // columns per panel
    static constexpr int Q_BYTES = BM * HDP * (int)sizeof(T);
    static constexpr int KV_BYTES = BN * HDP * (int)sizeof(T);
    // 1 KB to align the tiles to 1024 bytes (the swizzle's period), 1 KB of barriers.
    static constexpr int SMEM = 2048 + Q_BYTES + FLASH_STAGES * 2 * KV_BYTES;
    static constexpr int SN = BN / 2;                                 // score values per thread
    static constexpr int ON = HDP / 2;                                // output values per thread
};

// ---------------------------------------------------------------------------
// mbarrier, TMA and cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// Byte offset of (row r, byte column cb) in a tile of `rows` rows stored as
// 128-byte-swizzled panels of 128 bytes per row (TMA's SWIZZLE_128B with a
// box of 128 bytes by `rows`, at a 1024-byte-aligned base).
__device__ __forceinline__ uint32_t swz(int rows, int r, int cb) {
    const int within = cb & 127;
    return (uint32_t)((cb >> 7) * rows * 128 + r * 128 + ((((within >> 4) ^ r) & 7) << 4) +
                      (within & 15));
}

// Rows [row0, row0 + ROWS) of one head's (S, hd) matrix into a swizzled
// tile at `dst`, zero past S and hd, by the 32 lanes of the producer warp.
// word_ok: 4-byte copies never straddle a row (float32, or bf16 with even hd
// and 4-byte-aligned bases); otherwise bf16 pairs are read element by element.
template <typename T, int HDP, int ROWS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const T* __restrict__ src,
                                                int row0, int S, int hd, bool word_ok,
                                                int lane) {
    constexpr int EPW = 4 / (int)sizeof(T);            // elements per 4-byte word
    constexpr int WPR = HDP / EPW;                     // words per tile row
    for (int i = lane; i < ROWS * WPR; i += 32) {
        const int r = i / WPR, c = (i - r * WPR) * EPW;
        const int row = row0 + r;
        const uint32_t d = dst + swz(ROWS, r, c * (int)sizeof(T));
        const T* s = src + (int64_t)row * hd + c;
        if (sizeof(T) == 4 || word_ok) {
            const bool in = row < S && c < hd;
            cp_async4(d, in ? (const void*)s : (const void*)src, in ? 4u : 0u);
        } else {
            uint32_t w = 0;
            if (row < S) {
                const unsigned short* e = reinterpret_cast<const unsigned short*>(s);
                if (c < hd) w = e[0];
                if (c + 1 < hd) w |= (uint32_t)e[1] << 16;
            }
            asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(d), "r"(w) : "memory");
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // The consumers read the tile through wgmma (the async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
}

// ---------------------------------------------------------------------------
// Tensor-core products
// ---------------------------------------------------------------------------

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
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

// Keep the compiler from moving reads of wgmma's accumulators above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma wrappers, m64nNk16 bf16 -> f32 (one per shape: the operand lists name every
// accumulator register). ss: A and B from shared memory, both K-major; rs: A from
// registers, B from shared memory MN-major (trans-b).
__device__ __forceinline__ void wgmma_ss_n64(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(
    float (&d)[128], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
          "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
          "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo with hi and lo in TF32: hi carries x's top 11 bits, lo the next 11.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[mt][n] += a[mt] b[n] for MT m-tiles and N n-tiles on the tensor cores
// to about float32's accuracy (3xTF32): each operand split as hi + lo (the
// b fragments once, for every m-tile), the products lo*hi, hi*lo, hi*hi,
// each pass over all tiles before the next, so that consecutive products
// are independent. d[mt] points at m-tile mt's accumulator.
template <int MT, int N>
__device__ __forceinline__ void mma_3xtf32(float* const (&d)[MT], const uint32_t (&ah)[MT][4],
                                           const uint32_t (&al)[MT][4], const float (&b)[N][2]) {
    uint32_t bh[N][2], bl[N][2];
#pragma unroll
    for (int n = 0; n < N; ++n) {
        split_tf32(b[n][0], bh[n][0], bl[n][0]);
        split_tf32(b[n][1], bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < N; ++n) mma_tf32(d[mt] + 4 * n, al[mt], bh[n]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < N; ++n) mma_tf32(d[mt] + 4 * n, ah[mt], bl[n]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < N; ++n) mma_tf32(d[mt] + 4 * n, ah[mt], bh[n]);
}

__device__ __forceinline__ float lds(const unsigned char* tile, uint32_t off) {
    return *reinterpret_cast<const float*>(tile + off);
}

// bf16: issue S = Q K^T (raw dot products) for the warpgroup's 64 rows on
// wgmma, both operands K-major in shared memory; the caller commits and
// waits. The accumulator layout gives each thread two rows' scores.
template <int HDP, int BM, int BN>
__device__ __forceinline__ void qk_issue(float (&sc)[BN / 2], uint32_t q_s, uint32_t k_s,
                                         int warp) {
    const uint32_t qa = q_s + (warp >> 2) * 64 * 128;         // this warpgroup's rows
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
        // Panel kk / 4, then 32 bytes (16 columns) per k-step inside the 128-byte row.
        const uint64_t da = gmma_desc(qa + (kk >> 2) * BM * 128 + (kk & 3) * 32, 16, 1024);
        const uint64_t db = gmma_desc(k_s + (kk >> 2) * BN * 128 + (kk & 3) * 32, 16, 1024);
        if constexpr (BN == 128) wgmma_ss_n128(sc, da, db, kk > 0);
        else wgmma_ss_n64(sc, da, db, kk > 0);
    }
}

// bf16: P as a bf16 pair, hi = p cut to bf16 and lo = bf16(p - hi), for
// two products: rounding P once to bf16 before P V (a rounding the TPU
// kernel, which computes p v in float32, does not make) costs up to 2^-9 of
// |v| on rows with few keys, more than one bf16 ulp of a small output; the
// pair keeps p to 2^-16. The accumulator's values 8kk..8kk+7 are wgmma's A
// fragment of k-step kk.
template <int BN>
__device__ __forceinline__ void to_bf16_pair(const float (&p)[BN / 2], uint32_t (&hi)[BN / 16][4],
                                             uint32_t (&lo)[BN / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const float a = p[8 * kk + 2 * r], b = p[8 * kk + 2 * r + 1];
            const uint32_t ta = __float_as_uint(a) & 0xffff0000u;
            const uint32_t tb = __float_as_uint(b) & 0xffff0000u;
            hi[kk][r] = __byte_perm(ta, tb, 0x7632);       // the top halves, a low
            lo[kk][r] = pack_bf16(a - __uint_as_float(ta), b - __uint_as_float(tb));
        }
}

// bf16: issue O += P_hi V + P_lo V on wgmma; the caller commits and waits.
template <int HDP, int BN>
__device__ __forceinline__ void pv_issue(float (&o)[HDP / 2], const uint32_t (&hi)[BN / 16][4],
                                         const uint32_t (&lo)[BN / 16][4], uint32_t v_s) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
        // V is MN-major: 16 keys = two 8-row groups (SBO 1024 bytes) per
        // k-step; the 64-column panels lie BN * 128 bytes apart (LBO).
        const uint64_t db = gmma_desc(v_s + kk * 16 * 128, BN * 128, 1024);
        if constexpr (HDP == 256) {
            wgmma_rs_n256(o, hi[kk], db, 1);
            wgmma_rs_n256(o, lo[kk], db, 1);
        } else if constexpr (HDP == 128) {
            wgmma_rs_n128(o, hi[kk], db, 1);
            wgmma_rs_n128(o, lo[kk], db, 1);
        } else {
            wgmma_rs_n64(o, hi[kk], db, 1);
            wgmma_rs_n64(o, lo[kk], db, 1);
        }
    }
}

// float32: sc[mt] = Q K^T (raw dot products) for the warp's MT m-tiles of
// 16 rows on mma.sync in 3xTF32, in the accumulator layout.
template <int HDP, int BM, int BN, int MT>
__device__ __forceinline__ void qk_scores_f32(float (&sc)[MT][BN / 2], const unsigned char* q_p,
                                              const unsigned char* k_p, int warp, int lane,
                                              int hd) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[mt][i] = 0.f;
    // Rows r with r % 8 == g (Q rows 16 MT warp + 16 mt + g and + 8, K rows
    // 8 nt + g) hold 16-byte chunk c at c ^ g; column k0 + t of a 128-byte
    // panel row lies in chunk 2 (kk % 4), column k0 + t + 4 in the next one.
    const int g = lane >> 2, t = lane & 3;
    const unsigned char* qrow = q_p + (16 * MT * warp + g) * 128 + 4 * t;
    const unsigned char* krow = k_p + g * 128 + 4 * t;
    float* d[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) d[mt] = sc[mt];
    const int kk_end = (hd + 7) >> 3;                         // columns past hd are zeros
#pragma unroll
    for (int kk4 = 0; kk4 < HDP / 8; kk4 += 4) {
        if (kk4 >= kk_end) break;
        const unsigned char* qp = qrow + (kk4 >> 2) * BM * 128;
        const unsigned char* kp = krow + (kk4 >> 2) * BN * 128;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (kk4 + j >= kk_end) break;
            const int o0 = ((2 * j) ^ g) << 4, o1 = ((2 * j + 1) ^ g) << 4;
            uint32_t ah[MT][4], al[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                const int r = mt * 16 * 128;                  // the m-tile's rows
                split_tf32(lds(qp, r + o0), ah[mt][0], al[mt][0]);
                split_tf32(lds(qp, r + 1024 + o0), ah[mt][1], al[mt][1]);
                split_tf32(lds(qp, r + o1), ah[mt][2], al[mt][2]);
                split_tf32(lds(qp, r + 1024 + o1), ah[mt][3], al[mt][3]);
            }
            float b[BN / 8][2];
#pragma unroll
            for (int nt = 0; nt < BN / 8; ++nt) {
                b[nt][0] = lds(kp, nt * 1024 + o0);
                b[nt][1] = lds(kp, nt * 1024 + o1);
            }
            mma_3xtf32<MT, BN / 8>(d, ah, al, b);
        }
    }
}

// float32: o[mt] += P V for the warp's MT m-tiles on mma.sync in 3xTF32;
// p[mt] holds P in the accumulator layout.
template <int HDP, int BN, int MT>
__device__ __forceinline__ void pv_accumulate_f32(float (&o)[MT][HDP / 2],
                                                  const float (&p)[MT][BN / 2],
                                                  const unsigned char* v_p, int lane, int hd) {
    // V rows ks 8 + 2t and + 1 hold chunk c at c ^ 2t and c ^ (2t + 1);
    // column nt 8 + g lies in panel nt / 4, chunk 2 (nt % 4) + g / 4.
    const int g = lane >> 2, t = lane & 3;
    const unsigned char* vrow = v_p + 2 * t * 128 + 4 * (g & 3);
#pragma unroll
    for (int ks = 0; ks < BN / 8; ++ks) {
        // k-slot t holds key 2t and slot t + 4 key 2t + 1: the score
        // fragment's own values, so no shuffles.
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            split_tf32(p[mt][ks * 4 + 0], ah[mt][0], al[mt][0]);
            split_tf32(p[mt][ks * 4 + 2], ah[mt][1], al[mt][1]);
            split_tf32(p[mt][ks * 4 + 1], ah[mt][2], al[mt][2]);
            split_tf32(p[mt][ks * 4 + 3], ah[mt][3], al[mt][3]);
        }
        // Groups of 8 n-tiles (64 columns, two panels); a group past hd is skipped.
#pragma unroll
        for (int n0 = 0; n0 < HDP / 8; n0 += 8) {
            if (n0 * 8 >= hd) break;
            float b[8][2];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int nt = n0 + j, c = 2 * (nt & 3) + (g >> 2);
                const unsigned char* vp = vrow + (nt >> 2) * BN * 128 + ks * 1024;
                b[j][0] = lds(vp, (c ^ (2 * t)) << 4);
                b[j][1] = lds(vp, 128 + ((c ^ (2 * t + 1)) << 4));
            }
            float* d[MT];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) d[mt] = o[mt] + 4 * n0;
            mma_3xtf32<MT, 8>(d, ah, al, b);
        }
    }
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// One key tile's online-softmax step for this thread's two rows (row0 and
// row0 + 8): sc holds the raw scores in the accumulator layout and becomes
// p = 2^(s * scale - m * scale), with scale = hd^-0.5 * log2(e) and m the
// running max of the raw scores; l (this thread's share of the row sums)
// is carried; alpha is the factor that rescales the rows' output. On an
// edge tile, keys past S get -inf (no weight) and, when causal, keys above
// the diagonal get -1e30, as the TPU kernel.
template <int SN>
__device__ __forceinline__ void softmax_step(float (&sc)[SN], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge, int k0, int row0,
                                             int t4, int S, int causal, float scale_log2) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < SN; ++i) {
        if (edge) {
            const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
            const int row = row0 + 8 * ((i >> 1) & 1);
            if (causal && col > row) sc[i] = FLASH_NEG_INF;
            if (col >= S) sc[i] = -INFINITY;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float ms[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = ex2((m[h] - m_new) * scale_log2);
        m[h] = m_new;
        ms[h] = m_new * scale_log2;
        l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < SN; ++i) {
        const int h = (i >> 1) & 1;
        const float p = ex2(fmaf(sc[i], scale_log2, -ms[h]));
        sc[i] = p;
        l[h] += p;
    }
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair, bool second) {
    if (pair) {
        *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
        p[0] = a;
        if (second) p[1] = b;
    }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool pair, bool second) {
    if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    } else {
        p[0] = __float2bfloat16(a);
        if (second) p[1] = __float2bfloat16(b);
    }
}

template <typename T, int HDP, bool TMA>
__global__ void __launch_bounds__(FlashCfg<T, HDP>::THREADS, 1) flash_attn_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out, int BH, int S,
    int hd, int causal, float scale_log2, int word_ok)
{
    using C = FlashCfg<T, HDP>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const unsigned char* base_p = smem_raw + (base - raw);
    const uint32_t bar_q = base;
    const uint32_t bar_k = base + 8;                          // FLASH_STAGES each
    const uint32_t bar_v = bar_k + 8 * FLASH_STAGES;
    const uint32_t bar_e = bar_v + 8 * FLASH_STAGES;
    const uint32_t q_s = base + 1024;
    const uint32_t kv_s = q_s + C::Q_BYTES;                   // stage s: K at + 2s KV, V after

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_qt = (S + C::BM - 1) / C::BM;
    const int qt = n_qt - 1 - (int)(blockIdx.x / BH);         // heaviest tiles first
    const int bh = (int)(blockIdx.x % BH);
    const int q0 = qt * C::BM;
    const int q_end = causal ? min(S, q0 + C::BM) : S;
    const int n_kt = (q_end + C::BN - 1) / C::BN;
    const int64_t head = (int64_t)bh * S * hd;

    if (threadIdx.x == 0) {
        mbar_init(bar_q, 1);
        for (int s = 0; s < FLASH_STAGES; ++s) {
            mbar_init(bar_k + 8 * s, 1);
            mbar_init(bar_v + 8 * s, 1);
            mbar_init(bar_e + 8 * s, C::CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp >= C::CONSUMER_WARPS) {
        // Producer: the query tile once, then the ring of key and value tiles.
        // 24 registers for the producer warpgroup, 240 for each consumer
        // warpgroup: 128 * 24 + 256 * 240 <= 65536.
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
        if (warp != C::CONSUMER_WARPS) return;
        if constexpr (TMA) {
            if (lane == 0) {
                mbar_expect_tx(bar_q, C::Q_BYTES);
                for (int p = 0; p < HDP / C::PW; ++p)
                    tma_load_3d(q_s + p * C::BM * 128, &q_map, bar_q, p * C::PW, q0, bh);
                for (int kt = 0; kt < n_kt; ++kt) {
                    const int s = kt % FLASH_STAGES;
                    const uint32_t ks = kv_s + s * 2 * C::KV_BYTES;
                    mbar_wait(bar_e + 8 * s, ((kt / FLASH_STAGES) & 1) ^ 1);
                    mbar_expect_tx(bar_k + 8 * s, C::KV_BYTES);
                    for (int p = 0; p < HDP / C::PW; ++p)
                        tma_load_3d(ks + p * C::BN * 128, &k_map, bar_k + 8 * s, p * C::PW,
                                    kt * C::BN, bh);
                    mbar_expect_tx(bar_v + 8 * s, C::KV_BYTES);
                    for (int p = 0; p < HDP / C::PW; ++p)
                        tma_load_3d(ks + C::KV_BYTES + p * C::BN * 128, &v_map, bar_v + 8 * s,
                                    p * C::PW, kt * C::BN, bh);
                }
            }
        } else {
            load_tile_async<T, HDP, C::BM>(q_s, q + head, q0, S, hd, word_ok, lane);
            if (lane == 0) mbar_arrive(bar_q);
            for (int kt = 0; kt < n_kt; ++kt) {
                const int s = kt % FLASH_STAGES;
                const uint32_t ks = kv_s + s * 2 * C::KV_BYTES;
                mbar_wait(bar_e + 8 * s, ((kt / FLASH_STAGES) & 1) ^ 1);
                load_tile_async<T, HDP, C::BN>(ks, k + head, kt * C::BN, S, hd, word_ok, lane);
                if (lane == 0) mbar_arrive(bar_k + 8 * s);
                load_tile_async<T, HDP, C::BN>(ks + C::KV_BYTES, v + head, kt * C::BN, S, hd,
                                               word_ok, lane);
                if (lane == 0) mbar_arrive(bar_v + 8 * s);
            }
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // Consumers: in m-tile mt, rows row_lo + 16 mt and + 8 of the tile, 4
    // lanes per row.
    const int row_lo = 16 * C::MT * warp + (lane >> 2);
    const int t4 = lane & 3;
    float o[C::MT][C::ON];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int i = 0; i < C::ON; ++i) o[mt][i] = 0.f;
    float m[C::MT][2], l[C::MT][2], alpha[C::MT][2];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
        m[mt][0] = m[mt][1] = FLASH_NEG_INF;
        l[mt][0] = l[mt][1] = 0.f;
    }
    const unsigned char* q_p = base_p + 1024;
    auto k_stage = [&](int kt) { return kv_s + (kt % FLASH_STAGES) * 2 * C::KV_BYTES; };
    auto parity = [](int kt) { return (uint32_t)((kt / FLASH_STAGES) & 1); };
    // A key tile needs masks when it reaches past S, or above the diagonal of
    // the warp's first row.
    auto edge = [&](int kt) {
        return (kt + 1) * C::BN > S ||
               (causal && (kt + 1) * C::BN - 1 > q0 + 16 * C::MT * warp);
    };
    auto release = [&](int kt) {                         // this warp is done with the stage
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_e + 8 * (kt % FLASH_STAGES));
    };

    mbar_wait(bar_q, 0);
    if constexpr (C::BF16) {
        // The softmax of tile kt runs while the tensor cores compute tile
        // kt - 1's P V: S_kt and PV_{kt-1} are issued together, S_kt is
        // waited for, and PV_{kt-1} only before O is rescaled.
        float sc[C::SN];
        uint32_t hi[C::BN / 16][4], lo[C::BN / 16][4];
        mbar_wait(bar_k, 0);
        wgmma_fence();
        qk_issue<HDP, C::BM, C::BN>(sc, q_s, k_stage(0), warp);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        softmax_step(sc, m[0], l[0], alpha[0], edge(0), 0, q0 + row_lo, t4, S, causal,
                     scale_log2);
        to_bf16_pair<C::BN>(sc, hi, lo);
        for (int kt = 1; kt < n_kt; ++kt) {
            mbar_wait(bar_k + 8 * (kt % FLASH_STAGES), parity(kt));
            wgmma_fence();
            qk_issue<HDP, C::BM, C::BN>(sc, q_s, k_stage(kt), warp);
            wgmma_commit();
            mbar_wait(bar_v + 8 * ((kt - 1) % FLASH_STAGES), parity(kt - 1));
            pv_issue<HDP, C::BN>(o[0], hi, lo, k_stage(kt - 1) + C::KV_BYTES);
            wgmma_commit();
            wgmma_wait<1>();                              // S_kt is complete
            fence_regs(sc);
            softmax_step(sc, m[0], l[0], alpha[0], edge(kt), kt * C::BN, q0 + row_lo, t4, S,
                         causal, scale_log2);
            wgmma_wait<0>();                              // PV_{kt-1} is complete
            fence_regs(o[0]);
            release(kt - 1);
#pragma unroll
            for (int i = 0; i < C::ON; ++i) o[0][i] *= alpha[0][(i >> 1) & 1];
            to_bf16_pair<C::BN>(sc, hi, lo);
        }
        mbar_wait(bar_v + 8 * ((n_kt - 1) % FLASH_STAGES), parity(n_kt - 1));
        wgmma_fence();
        pv_issue<HDP, C::BN>(o[0], hi, lo, k_stage(n_kt - 1) + C::KV_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o[0]);
        release(n_kt - 1);
    } else {
        for (int kt = 0; kt < n_kt; ++kt) {
            const unsigned char* k_p = q_p + C::Q_BYTES + (kt % FLASH_STAGES) * 2 * C::KV_BYTES;
            float sc[C::MT][C::SN];
            mbar_wait(bar_k + 8 * (kt % FLASH_STAGES), parity(kt));
            qk_scores_f32<HDP, C::BM, C::BN, C::MT>(sc, q_p, k_p, warp, lane, hd);
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt) {
                softmax_step(sc[mt], m[mt], l[mt], alpha[mt], edge(kt), kt * C::BN,
                             q0 + row_lo + 16 * mt, t4, S, causal, scale_log2);
#pragma unroll
                for (int i = 0; i < C::ON; ++i) o[mt][i] *= alpha[mt][(i >> 1) & 1];
            }
            mbar_wait(bar_v + 8 * (kt % FLASH_STAGES), parity(kt));
            pv_accumulate_f32<HDP, C::BN, C::MT>(o, sc, k_p + C::KV_BYTES, lane, hd);
            release(kt);
        }
    }

    const bool pair_ok = (hd & 1) == 0 && (reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T))) == 0;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float lt = l[mt][h];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float den = fmaxf(lt, 1e-30f);
        const int row = q0 + row_lo + 16 * mt + 8 * h;
        if (row >= S) continue;
        T* orow = out + head + (int64_t)row * hd;
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
            const int col = 8 * j + 2 * t4;
            if (col < hd)
                store2(orow + col, o[mt][4 * j + 2 * h] / den, o[mt][4 * j + 2 * h + 1] / den,
                       pair_ok, col + 1 < hd);
        }
    }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library links against nothing but cudart.
static EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// A (BH, S, hd) tensor as a 3-D map over (hd, S, BH), boxes of one panel
// (128 bytes) by `rows` rows by one head, 128-byte swizzle, zeros out of bounds.
template <typename T, int HDP>
static int make_map(CUtensorMap* map, const void* ptr, int BH, int S, int hd, int rows) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return FLASH_ERR_ENCODE + (int)CUDA_ERROR_NOT_FOUND;
    const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)BH};
    const cuuint64_t strides[2] = {(cuuint64_t)hd * sizeof(T), (cuuint64_t)S * hd * sizeof(T)};
    const cuuint32_t box[3] = {(cuuint32_t)FlashCfg<T, HDP>::PW, (cuuint32_t)rows, 1};
    const cuuint32_t elem_strides[3] = {1, 1, 1};
    const CUresult r = encode(
        map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
        3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : FLASH_ERR_ENCODE + (int)r;
}

template <typename T, int HDP, bool TMA>
static int launch(const void* q, const void* k, const void* v, void* out, int BH, int S,
                  int hd, int causal, float scale, int word_ok, cudaStream_t stream) {
    using C = FlashCfg<T, HDP>;
    CUtensorMap maps[3] = {};
    if (TMA) {
        int rc = make_map<T, HDP>(&maps[0], q, BH, S, hd, C::BM);
        if (rc == 0) rc = make_map<T, HDP>(&maps[1], k, BH, S, hd, C::BN);
        if (rc == 0) rc = make_map<T, HDP>(&maps[2], v, BH, S, hd, C::BN);
        if (rc != 0) return rc;
    }
    auto kernel = flash_attn_kernel<T, HDP, TMA>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (int64_t)BH * ((S + C::BM - 1) / C::BM);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    kernel<<<(unsigned)blocks, C::THREADS, C::SMEM, stream>>>(
        maps[0], maps[1], maps[2], (const T*)q, (const T*)k, (const T*)v, (T*)out, BH, S, hd,
        causal, scale * 1.4426950408889634f, word_ok);
    return (int)cudaGetLastError();
}

template <typename T, int HDP>
static int dispatch_path(const void* q, const void* k, const void* v, void* out, int BH, int S,
                         int hd, int causal, float scale, int use_tma, int word_ok,
                         cudaStream_t st) {
    if (use_tma) return launch<T, HDP, true>(q, k, v, out, BH, S, hd, causal, scale, 0, st);
    return launch<T, HDP, false>(q, k, v, out, BH, S, hd, causal, scale, word_ok, st);
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* out, int BH, int S,
                    int hd, int causal, float scale, int use_tma, int word_ok, cudaStream_t st) {
    if (hd <= 64)
        return dispatch_path<T, 64>(q, k, v, out, BH, S, hd, causal, scale, use_tma, word_ok, st);
    if (hd <= 128)
        return dispatch_path<T, 128>(q, k, v, out, BH, S, hd, causal, scale, use_tma, word_ok, st);
    return dispatch_path<T, 256>(q, k, v, out, BH, S, hd, causal, scale, use_tma, word_ok, st);
}

template <typename T, int HDP>
static void plan_of(int* v) {
    using C = FlashCfg<T, HDP>;
    v[0] = HDP;
    v[1] = C::BM;
    v[2] = C::BN;
    v[3] = C::THREADS;
    v[4] = C::SMEM;
}

extern "C" {

int flash_attn_max_head_dim(void) { return FLASH_MAX_HD; }

const char* flash_attn_error_string(int code) {
    if (code >= FLASH_ERR_ENCODE) return "cuTensorMapEncodeTiled failed (CUresult = code - 1000)";
    return cudaGetErrorString((cudaError_t)code);
}

// Tile plan for head dim hd and dtype (0 float32, 1 bfloat16):
// {padded hd, query rows per block, key rows per tile, threads, shared bytes}.
int flash_attn_plan(int hd, int dtype, int* out5) {
    if (hd < 1 || hd > FLASH_MAX_HD || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const int hdp = hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
    if (dtype == 0) {
        if (hdp == 64) plan_of<float, 64>(out5);
        else if (hdp == 128) plan_of<float, 128>(out5);
        else plan_of<float, 256>(out5);
    } else {
        if (hdp == 64) plan_of<__nv_bfloat16, 64>(out5);
        else if (hdp == 128) plan_of<__nv_bfloat16, 128>(out5);
        else plan_of<__nv_bfloat16, 256>(out5);
    }
    return 0;
}

// q, k, v, out: (BH, S, hd) contiguous; dtype 0 = float32, 1 = bfloat16.
// use_tma: load through TMA descriptors (hd * itemsize % 16 == 0 and
// 16-byte-aligned bases); else cp.async, with 4-byte copies when word_ok.
// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// 1000 + the CUresult when a TMA descriptor cannot be made.
int flash_attn_forward(const void* q, const void* k, const void* v, void* out,
                       int BH, int S, int hd, int causal, int dtype, float scale,
                       int use_tma, int word_ok, void* stream) {
    if (BH < 1 || S < 1 || hd < 1 || hd > FLASH_MAX_HD) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch<float>(q, k, v, out, BH, S, hd, causal, scale, use_tma, word_ok, st);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(q, k, v, out, BH, S, hd, causal, scale, use_tma, word_ok,
                                       st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
