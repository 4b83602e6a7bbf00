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
// flash_attn.py::launch_plan mirrors them. The parts poly_attn.cu shares
// (mbarriers, TMA, the cp.async path, the products with A from registers,
// the bf16 pair, 3xTF32, the P V steps) are in attn_common.cuh.
#include "attn_common.cuh"

#define FLASH_MAX_HD 256
#define FLASH_NEG_INF -1e30f
#define FLASH_STAGES 2
#define FLASH_ERR_ENCODE ATTN_ERR_ENCODE

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

// wgmma wrappers, m64nNk16 bf16 -> f32 (one per shape: the operand lists name every
// accumulator register), A and B from shared memory, both K-major. The wrappers
// with A from registers are in attn_common.cuh.
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

template <typename T, int HDP, bool TMA>
static int launch(const void* q, const void* k, const void* v, void* out, int BH, int S,
                  int hd, int causal, float scale, int word_ok, cudaStream_t stream) {
    using C = FlashCfg<T, HDP>;
    CUtensorMap maps[3] = {};
    if (TMA) {
        int rc = make_map<T>(&maps[0], q, BH, S, hd, C::BM);
        if (rc == 0) rc = make_map<T>(&maps[1], k, BH, S, hd, C::BN);
        if (rc == 0) rc = make_map<T>(&maps[2], v, BH, S, hd, C::BN);
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
