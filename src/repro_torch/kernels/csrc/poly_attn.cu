// Additive polynomial attention (FedGAT's score on sequences), for Hopper
// (sm_90a), with the e . v product on the tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/poly_attn.py::poly_attn
// (pallas_call at :99, body _poly_kernel at :25). For one (batch, head h) and
// query row i, in float32:
//
//   sq_i = q_i . a1_h,  sk_j = k_j . a2_h,  x_ij = clip(sq_i + sk_j, -domain, domain)
//   e_ij = Horner(coeffs, x_ij), 0 where causal and j > i
//   out_i = sum_j e_ij v_j / guard(sum_j e_ij),  guard(d) = |d| < 1e-9 ? 1e-9 : d
//
// stored in the input's type. The guard is the TPU kernel's (poly_attn.py:66):
// a negative denominator divides.
//
// Bound. The scores are rank one, so there is no q k^T product: per allowed
// (i, j) the kernel does the clip, Horner (2p flops) and the e . v sum (2 hd
// flops). At the yi-6b shape (B2 H32 S4096 hd128, p = 8, causal) e . v is
// 256 of the ~280 flops of a pair, so it has to run on the tensor cores; the
// bytes of q, k, v and out take 0.16 ms (bf16 0.08 ms). What stays on the CUDA
// cores is Horner, the clip and the denominator, ~23 instructions a pair.
//
// Design. One block per (query tile of BM rows, batch*head), the heaviest
// causal tiles first, with a loop over key tiles of BN keys inside the
// block; key tiles wholly above the diagonal are never loaded. The block is
// warp-specialised as flash_attn.cu's, from whose parts (attn_common.cuh) it
// is built:
//
// - a producer warpgroup that gives its registers to the consumers
//   (setmaxnreg). Its first warp keeps a ring of STAGES key and value tiles
//   in shared memory: TMA tile copies into the 128-byte-swizzled layout
//   where a descriptor can describe the tensor, otherwise cp.async copies
//   that write the same layout (poly_attn.py::launch_plan reports which).
//   Its next BN / 32 warps turn each key tile into sk (one key per lane, a2
//   from shared memory) and write it beside the tile, so the consumers' CUDA
//   cores keep to Horner. A stage is full when its value tile has landed and
//   its sk is written (one mbarrier: the TMA bytes and the sk warps'
//   arrivals).
// - consumer warps, each owning 16 query rows per m-tile (one m-tile for
//   bf16, so that two warpgroups take 128 rows; two for float32 up to hd 128,
//   as flash_attn's float32 path, so that each split value fragment feeds
//   both). Each warp computes the sq of its rows once, lane by row. A thread
//   then computes its e values straight in the accumulator layout (value
//   i: row lane/4 + 8 ((i/2)%2), key 8 (i/4) + 2 (lane%4) + i%2) from its
//   rows' sq in registers and the tile's sk in shared memory, and adds them
//   to its rows' partial denominators (reduced over the 4 lanes of a row by
//   shuffles at the end, from the unsplit e, in float32). There is no
//   running max and no rescaling: polynomial partial sums are associative.
//   - bf16: e becomes wgmma's A fragment as a bf16 pair hi + lo (one bf16
//     rounding of e fails the one-ulp check of the output on early causal
//     rows, as it did for flash's P), and O += E_hi V + E_lo V runs as
//     wgmma with A from registers, V read MN-major from the swizzled tile.
//     The product of tile kt runs while the warp computes e of tile kt + 1.
//   - float32: mma.sync.m16n8k8 in 3xTF32 (e and v each split hi + lo), the
//     key order inside each k-step permuted so that the e values are the A
//     fragment (flash_attn's pv_accumulate_f32).
//
// Ragged S and hd are masked here (TMA zero-fills out of bounds; the
// cp.async path writes zeros), so the caller pads nothing. Tile sizes per
// (dtype, padded hd) are in PolyCfg; poly_attn.py::launch_plan mirrors them.
#include "attn_common.cuh"

#define POLY_MAX_HD 256
#define POLY_MAX_COEFFS 64
#define POLY_SMEM_MAX (227 * 1024)

template <typename T, int HDP>
struct PolyCfg {
    static constexpr bool BF16 = sizeof(T) == 2;
    static constexpr int MT = (!BF16 && HDP <= 128) ? 2 : 1;          // 16-row m-tiles per warp
    static constexpr int CONSUMER_WARPS = 8;
    static constexpr int BM = CONSUMER_WARPS * 16 * MT;               // query rows per block
    static constexpr int BN = (BF16 && HDP <= 128) ? 64 : 32;         // keys per tile
    static constexpr int THREADS = CONSUMER_WARPS * 32 + 128;         // + the producer warpgroup
    static constexpr int PW = 128 / (int)sizeof(T);                   // columns per panel
    static constexpr int KV_BYTES = BN * HDP * (int)sizeof(T);
    // 1 KB to align the tiles to 1024 bytes (the swizzle's period), 3 KB of
    // barriers, coefficients, sk and a2; then as many stages as fit, at most 4.
    static constexpr int FIXED = 4096;
    static constexpr int STAGES = (POLY_SMEM_MAX - FIXED) / (2 * KV_BYTES) < 4
                                      ? (POLY_SMEM_MAX - FIXED) / (2 * KV_BYTES) : 4;
    static constexpr int SMEM = FIXED + STAGES * 2 * KV_BYTES;
    static constexpr int SKW = BN / 32;                               // warps computing sk
    static constexpr int SN = BN / 2;                                 // e values per m-tile
    static constexpr int ON = HDP / 2;                                // output values per m-tile
    static_assert(STAGES >= 2, "two stages of key and value tiles must fit");
    static_assert(STAGES * BN * 4 <= 1024 && HDP * 4 <= 1024, "sk and a2 fit their 1 KB");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// sk[r] = k_r . a2 for row r of a swizzled key tile of BN rows; each lane
// takes one row (the 16-byte chunks of 8 consecutive rows lie in distinct
// banks). a2_s holds HDP floats, zero past hd, as the tile's columns past hd
// are.
template <typename T, int HDP, int BN>
__device__ __forceinline__ void key_scores(float* sk, const unsigned char* tile,
                                           const float* a2_s, int r) {
    constexpr int EPC = 16 / (int)sizeof(T);                 // elements per 16-byte chunk
    constexpr int NC = HDP / EPC;                            // chunks per row
    {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int j = 0; j < NC; ++j) {
            const uint4 w = *reinterpret_cast<const uint4*>(
                tile + (j >> 3) * BN * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4));
            const float* a = a2_s + j * EPC;
            if constexpr (sizeof(T) == 4) {
                acc[0] = fmaf(__uint_as_float(w.x), a[0], acc[0]);
                acc[1] = fmaf(__uint_as_float(w.y), a[1], acc[1]);
                acc[2] = fmaf(__uint_as_float(w.z), a[2], acc[2]);
                acc[3] = fmaf(__uint_as_float(w.w), a[3], acc[3]);
            } else {
                const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {                // bf16 pair: low half first
                    acc[u] = fmaf(__uint_as_float(ws[u] << 16), a[2 * u], acc[u]);
                    acc[u] = fmaf(__uint_as_float(ws[u] & 0xffff0000u), a[2 * u + 1], acc[u]);
                }
            }
        }
        sk[r] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
}

// A thread's e values of one key tile (keys k0..k0+BN) in the accumulator
// layout, for its MT m-tiles (rows row0 + 16 mt and + 8), added to its
// partial denominators. Horner from the highest coefficient with separate
// roundings, as the TPU kernel's e * x + q_n, eight values at a time. On an
// edge tile, keys past S and, when causal, keys above the diagonal get 0.
template <int MT, int SN>
__device__ __forceinline__ void poly_scores(float (&e)[MT][SN], float (&den)[MT][2],
                                            const float (&sq)[MT][2], const float* sk,
                                            const float* c_s, int P, float domain, bool edge,
                                            int k0, int row0, int t4, int S, int causal) {
    // The reference's first Horner step, 0 * x + q[P-1], is q[P-1] for a
    // finite x (and NaN for a NaN x, which the next step gives as well).
    const float q_top = c_s[P - 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < SN; j += 8) {
            float xv[8], acc[8];
#pragma unroll
            for (int u = 0; u < 8; u += 4) {
                const float2 s2 = *reinterpret_cast<const float2*>(sk + 2 * (j + u) + 2 * t4);
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    const float x = sq[mt][(w >> 1) & 1] + ((w & 1) ? s2.y : s2.x);
                    xv[u + w] = fminf(fmaxf(x, -domain), domain);
                    acc[u + w] = q_top;
                }
            }
            for (int n = P - 2; n >= 0; --n) {
                const float qn = c_s[n];
#pragma unroll
                for (int u = 0; u < 8; ++u) acc[u] = __fadd_rn(__fmul_rn(acc[u], xv[u]), qn);
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int i = j + u;
                float ev = acc[u];
                if (edge) {
                    const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
                    const int row = row0 + 16 * mt + 8 * ((i >> 1) & 1);
                    if ((causal && col > row) || col >= S) ev = 0.f;
                }
                e[mt][i] = ev;
                den[mt][(i >> 1) & 1] += ev;
            }
        }
}

template <typename T, int HDP, bool TMA>
__global__ void __launch_bounds__(PolyCfg<T, HDP>::THREADS, 1) poly_attn_kernel(
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ a1, const float* __restrict__ a2, const float* __restrict__ coeffs,
    T* __restrict__ out, int BH, int H, int S, int hd, int P, int causal, float domain,
    int word_ok)
{
    using C = PolyCfg<T, HDP>;
    constexpr int ST = C::STAGES;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* base_p = smem_raw + (base - raw);
    const uint32_t bar_k = base;                               // ST each: key tile landed,
    const uint32_t bar_f = bar_k + 8 * ST;                     // stage full (v + sk),
    const uint32_t bar_e = bar_f + 8 * ST;                     // stage consumed
    float* c_s = reinterpret_cast<float*>(base_p + 256);       // POLY_MAX_COEFFS
    float* sk_s = reinterpret_cast<float*>(base_p + 1024);     // ST x BN (<= 1 KB)
    float* a2_s = reinterpret_cast<float*>(base_p + 2048);     // HDP (<= 1 KB)
    const uint32_t kv_s = base + 3072;                         // stage s: K at + 2s KV, V after
    const unsigned char* kv_p = base_p + 3072;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_qt = (S + C::BM - 1) / C::BM;
    const int qt = n_qt - 1 - (int)(blockIdx.x / BH);         // heaviest tiles first
    const int bh = (int)(blockIdx.x % BH);
    const int q0 = qt * C::BM;
    const int q_end = causal ? min(S, q0 + C::BM) : S;
    const int n_kt = (q_end + C::BN - 1) / C::BN;
    const int64_t head = (int64_t)bh * S * hd;
    const int64_t hrow = (int64_t)(bh % H) * hd;

    for (int i = threadIdx.x; i < P; i += C::THREADS) c_s[i] = coeffs[i];
    for (int i = threadIdx.x; i < HDP; i += C::THREADS) a2_s[i] = i < hd ? a2[hrow + i] : 0.f;
    if (threadIdx.x == 0) {
        for (int s = 0; s < ST; ++s) {
            mbar_init(bar_k + 8 * s, 1);
            mbar_init(bar_f + 8 * s, 1 + C::SKW);
            mbar_init(bar_e + 8 * s, C::CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    auto parity = [](int kt) { return (uint32_t)((kt / ST) & 1); };

    if (warp >= C::CONSUMER_WARPS) {
        // 40 registers for the producer warpgroup, 232 for each consumer
        // warpgroup: 128 * 40 + 256 * 232 <= 65536.
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (warp == C::CONSUMER_WARPS) {
            // The ring of key and value tiles.
            for (int kt = 0; kt < n_kt; ++kt) {
                const int s = kt % ST;
                const uint32_t ks = kv_s + s * 2 * C::KV_BYTES;
                mbar_wait(bar_e + 8 * s, parity(kt) ^ 1);
                if constexpr (TMA) {
                    if (lane == 0) {
                        mbar_expect_tx(bar_k + 8 * s, C::KV_BYTES);
                        for (int p = 0; p < HDP / C::PW; ++p)
                            tma_load_3d(ks + p * C::BN * 128, &k_map, bar_k + 8 * s, p * C::PW,
                                        kt * C::BN, bh);
                        mbar_expect_tx(bar_f + 8 * s, C::KV_BYTES);
                        for (int p = 0; p < HDP / C::PW; ++p)
                            tma_load_3d(ks + C::KV_BYTES + p * C::BN * 128, &v_map, bar_f + 8 * s,
                                        p * C::PW, kt * C::BN, bh);
                    }
                } else {
                    load_tile_async<T, HDP, C::BN>(ks, k + head, kt * C::BN, S, hd, word_ok, lane);
                    if (lane == 0) mbar_arrive(bar_k + 8 * s);
                    load_tile_async<T, HDP, C::BN>(ks + C::KV_BYTES, v + head, kt * C::BN, S, hd,
                                                   word_ok, lane);
                    if (lane == 0) mbar_arrive(bar_f + 8 * s);
                }
            }
        } else if (warp <= C::CONSUMER_WARPS + C::SKW) {
            // sk of each key tile, beside it: 32 keys per warp, one per lane.
            const int r = 32 * (warp - C::CONSUMER_WARPS - 1) + lane;
            for (int kt = 0; kt < n_kt; ++kt) {
                const int s = kt % ST;
                mbar_wait(bar_k + 8 * s, parity(kt));
                key_scores<T, HDP, C::BN>(sk_s + s * C::BN, kv_p + s * 2 * C::KV_BYTES, a2_s, r);
                __syncwarp();
                if (lane == 0) mbar_arrive(bar_f + 8 * s);
            }
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wrow0 = q0 + 16 * C::MT * warp;                 // the warp's first row
    const int row_lo = wrow0 + (lane >> 2);                   // m-tile mt: + 16 mt and + 8
    const int t4 = lane & 3;

    // sq of the warp's 16 MT rows, one row per lane, then each thread's own.
    float sq[C::MT][2];
    {
        float mine = 0.f;
        const int r = wrow0 + (lane & (16 * C::MT - 1));
        if (r < S) {
            const T* qr = q + head + (int64_t)r * hd;
            const float* a1h = a1 + hrow;
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            int c = 0;
#pragma unroll 4
            for (; c + 4 <= hd; c += 4)
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    acc[u] = fmaf(to_f32(qr[c + u]), __ldg(a1h + c + u), acc[u]);
            for (; c < hd; ++c) acc[0] = fmaf(to_f32(qr[c]), __ldg(a1h + c), acc[0]);
            mine = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        }
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                sq[mt][h] = __shfl_sync(0xffffffffu, mine, 16 * mt + 8 * h + (lane >> 2));
    }

    float o[C::MT][C::ON];
    float den[C::MT][2];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
        den[mt][0] = den[mt][1] = 0.f;
#pragma unroll
        for (int i = 0; i < C::ON; ++i) o[mt][i] = 0.f;
    }
    auto stage_of = [&](int kt) { return kt % ST; };
    auto v_stage = [&](int kt) { return kv_s + stage_of(kt) * 2 * C::KV_BYTES + C::KV_BYTES; };
    // A tile needs masks when it reaches past S or above the warp's first
    // row; it holds no allowed key of the warp when causal and wholly above
    // the warp's last row.
    auto edge = [&](int kt) {
        return (kt + 1) * C::BN > S || (causal && (kt + 1) * C::BN - 1 > wrow0);
    };
    auto dead = [&](int kt) { return causal && kt * C::BN > wrow0 + 16 * C::MT - 1; };
    auto scores = [&](float (&e)[C::MT][C::SN], int kt) {
        if (dead(kt)) {
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
                for (int i = 0; i < C::SN; ++i) e[mt][i] = 0.f;
        } else {
            poly_scores<C::MT, C::SN>(e, den, sq, sk_s + stage_of(kt) * C::BN, c_s, P, domain,
                                      edge(kt), kt * C::BN, row_lo, t4, S, causal);
        }
    };
    auto release = [&](int kt) {                         // this warp is done with the stage
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_e + 8 * stage_of(kt));
    };

    float e[C::MT][C::SN];
    if constexpr (C::BF16) {
        // The products of tile kt run on the tensor cores while the warp
        // computes the e values of tile kt + 1.
        uint32_t hi[C::BN / 16][4], lo[C::BN / 16][4];
        mbar_wait(bar_f, 0);
        scores(e, 0);
        to_bf16_pair<C::BN>(e[0], hi, lo);
        for (int kt = 0; kt < n_kt; ++kt) {
            wgmma_fence();
            pv_issue<HDP, C::BN>(o[0], hi, lo, v_stage(kt));
            wgmma_commit();
            if (kt + 1 < n_kt) {
                mbar_wait(bar_f + 8 * stage_of(kt + 1), parity(kt + 1));
                scores(e, kt + 1);
            }
            wgmma_wait<0>();
            fence_regs(o[0]);
            release(kt);
            if (kt + 1 < n_kt) to_bf16_pair<C::BN>(e[0], hi, lo);
        }
    } else {
        for (int kt = 0; kt < n_kt; ++kt) {
            mbar_wait(bar_f + 8 * stage_of(kt), parity(kt));
            if (!dead(kt)) {
                scores(e, kt);
                pv_accumulate_f32<HDP, C::BN, C::MT>(
                    o, e, kv_p + stage_of(kt) * 2 * C::KV_BYTES + C::KV_BYTES, lane, hd);
            }
            release(kt);
        }
    }

    const bool pair_ok = (hd & 1) == 0 && (reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T))) == 0;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float d = den[mt][h];
            d += __shfl_xor_sync(0xffffffffu, d, 1);
            d += __shfl_xor_sync(0xffffffffu, d, 2);
            d = fabsf(d) < 1e-9f ? 1e-9f : d;
            const int row = row_lo + 16 * mt + 8 * h;
            if (row >= S) continue;
            T* orow = out + head + (int64_t)row * hd;
#pragma unroll
            for (int j = 0; j < HDP / 8; ++j) {
                const int col = 8 * j + 2 * t4;
                if (col < hd)
                    store2(orow + col, o[mt][4 * j + 2 * h] / d, o[mt][4 * j + 2 * h + 1] / d,
                           pair_ok, col + 1 < hd);
            }
        }
}

template <typename T, int HDP, bool TMA>
static int launch(const void* q, const void* k, const void* v, const void* a1, const void* a2,
                  const void* coeffs, void* out, int BH, int H, int S, int hd, int P, int causal,
                  float domain, int word_ok, cudaStream_t stream) {
    using C = PolyCfg<T, HDP>;
    CUtensorMap maps[2] = {};
    if (TMA) {
        int rc = make_map<T>(&maps[0], k, BH, S, hd, C::BN);
        if (rc == 0) rc = make_map<T>(&maps[1], v, BH, S, hd, C::BN);
        if (rc != 0) return rc;
    }
    auto kernel = poly_attn_kernel<T, HDP, TMA>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::SMEM);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (int64_t)BH * ((S + C::BM - 1) / C::BM);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    kernel<<<(unsigned)blocks, C::THREADS, C::SMEM, stream>>>(
        maps[0], maps[1], (const T*)q, (const T*)k, (const T*)v, (const float*)a1,
        (const float*)a2, (const float*)coeffs, (T*)out, BH, H, S, hd, P, causal, domain, word_ok);
    return (int)cudaGetLastError();
}

template <typename T, int HDP>
static int dispatch_path(const void* q, const void* k, const void* v, const void* a1,
                         const void* a2, const void* coeffs, void* out, int BH, int H, int S,
                         int hd, int P, int causal, float domain, int use_tma, int word_ok,
                         cudaStream_t st) {
    if (use_tma)
        return launch<T, HDP, true>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal, domain,
                                    0, st);
    return launch<T, HDP, false>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal, domain,
                                 word_ok, st);
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, const void* a1, const void* a2,
                    const void* coeffs, void* out, int BH, int H, int S, int hd, int P, int causal,
                    float domain, int use_tma, int word_ok, cudaStream_t st) {
    if (hd <= 64)
        return dispatch_path<T, 64>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal, domain,
                                    use_tma, word_ok, st);
    if (hd <= 128)
        return dispatch_path<T, 128>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal, domain,
                                     use_tma, word_ok, st);
    return dispatch_path<T, 256>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal, domain,
                                 use_tma, word_ok, st);
}

template <typename T, int HDP>
static void plan_of(int* v) {
    using C = PolyCfg<T, HDP>;
    v[0] = HDP;
    v[1] = C::BM;
    v[2] = C::BN;
    v[3] = C::THREADS;
    v[4] = C::SMEM;
    v[5] = C::STAGES;
}

extern "C" {

void poly_attn_limits(int* max_hd, int* max_coeffs) {
    *max_hd = POLY_MAX_HD;
    *max_coeffs = POLY_MAX_COEFFS;
}

const char* poly_attn_error_string(int code) {
    if (code >= ATTN_ERR_ENCODE) return "cuTensorMapEncodeTiled failed (CUresult = code - 1000)";
    return cudaGetErrorString((cudaError_t)code);
}

// Tile plan for head dim hd and dtype (0 float32, 1 bfloat16): {padded hd,
// query rows per block, keys per tile, threads, shared bytes, stages}.
int poly_attn_plan(int hd, int dtype, int* out6) {
    if (hd < 1 || hd > POLY_MAX_HD || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const int hdp = hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
    if (dtype == 0) {
        if (hdp == 64) plan_of<float, 64>(out6);
        else if (hdp == 128) plan_of<float, 128>(out6);
        else plan_of<float, 256>(out6);
    } else {
        if (hdp == 64) plan_of<__nv_bfloat16, 64>(out6);
        else if (hdp == 128) plan_of<__nv_bfloat16, 128>(out6);
        else plan_of<__nv_bfloat16, 256>(out6);
    }
    return 0;
}

// q, k, v, out: (BH, S, hd) contiguous, dtype 0 = float32, 1 = bfloat16;
// a1, a2: (H, hd) float32, head of row bh = bh % H; coeffs: (P,) float32.
// use_tma: load k and v through TMA descriptors (hd * itemsize % 16 == 0 and
// 16-byte-aligned bases); else cp.async, with 4-byte copies when word_ok.
// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// 1000 + the CUresult when a TMA descriptor cannot be made.
int poly_attn_forward(const void* q, const void* k, const void* v, const void* a1,
                      const void* a2, const void* coeffs, void* out, int BH, int H, int S,
                      int hd, int P, int causal, float domain, int dtype, int use_tma,
                      int word_ok, void* stream) {
    if (BH < 1 || H < 1 || S < 1 || hd < 1 || hd > POLY_MAX_HD || P < 1 || P > POLY_MAX_COEFFS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch<float>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal, domain,
                               use_tma, word_ok, st);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal,
                                       domain, use_tma, word_ok, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
