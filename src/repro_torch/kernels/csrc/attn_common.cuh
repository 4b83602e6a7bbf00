// The parts the attention kernels of this directory share on Hopper (sm_90a):
// mbarriers, TMA tile copies (cp.async.bulk.tensor) and 1-D bulk copies
// (cp.async.bulk), the cp.async path that writes the same 128-byte-swizzled
// tile layout where a TMA descriptor cannot describe the tensor, the wgmma
// products with A from registers, the bf16 hi + lo split of an operand, and
// error-compensated TF32 (3xTF32) products on mma.sync; on the host, the
// TMA descriptor of a (BH, S, hd) tensor. flash_attn.cu and poly_attn.cu
// include it; _build.py hashes it into each library's name.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define ATTN_ERR_ENCODE 1000        // + the CUresult of cuTensorMapEncodeTiled

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

// A 1-D bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// both addresses 16-byte aligned, counted on `bar`'s transaction bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
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

// wgmma wrappers, m64nNk16 bf16 -> f32, A from registers and B from shared
// memory MN-major (trans-b); one per shape, since the operand lists name every
// accumulator register.
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
// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library links against nothing but cudart.
static inline EncodeTiledFn encode_tiled() {
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
template <typename T>
static int make_map(CUtensorMap* map, const void* ptr, int BH, int S, int hd, int rows) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return ATTN_ERR_ENCODE + (int)CUDA_ERROR_NOT_FOUND;
    const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)BH};
    const cuuint64_t strides[2] = {(cuuint64_t)hd * sizeof(T), (cuuint64_t)S * hd * sizeof(T)};
    const cuuint32_t box[3] = {(cuuint32_t)(128 / sizeof(T)), (cuuint32_t)rows, 1};
    const cuuint32_t elem_strides[3] = {1, 1, 1};
    const CUresult r = encode(
        map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
        3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ATTN_ERR_ENCODE + (int)r;
}
