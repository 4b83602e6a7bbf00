// Chunked RWKV6 wkv recurrence with data-dependent decay, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/wkv_chunk.py::wkv_chunked
// (pallas_call at :93, body _wkv_kernel at :31). Per (batch*head) row, with
// the hd x hd state S carried across chunks of C tokens, in float32:
//
//   P_t = prod_{u<=t} w_u (per channel),  a_t = r_t * P_{t-1},  k~_s = k_s / max(P_s, 1e-24)
//   M_ts = a_t . k~_s (t > s),  (r_t * u) . k_t (t == s),  0 (t < s)
//   y = M v + a S_0
//   S_C = diag(P_C) S_0 + ((P_C / max(P_s, 1e-24)) * k_s)^T v
//
// y is float32; the last state is written at the end.
//
// Bound. Memory: r, k, v, w are read once and y written once (at the
// rwkv6-1.6b shape BH256 S4096 hd64, 1.35 GB in float32, 0.40 ms at
// 3.35 TB/s; 0.81 GB and 0.24 ms with bf16 inputs, where ~2e10 float32
// operations at the CUDA cores' 67 TFLOP/s, 0.32 ms, bound it instead). On
// the tensor cores in 3xTF32 the products are three times those operations,
// about 0.13 ms at the 495 TFLOP/s TF32 peak. Only the chunk-to-chunk state
// is serial: 256 chunks a row, one row per block.
//
// Fast path (wkv_fast_kernel): C = 16 and hd a multiple of 16 up to 128, the
// rwkv6 shape among them. One block per batch*head row, warp-specialised:
//
// - a producer warp fills a ring of WKV_FAST_STAGES chunk stages. One chunk of
//   one row is C*hd contiguous elements of each of r, k, v and w, so it takes
//   four 1-D bulk copies (cp.async.bulk) on the stage's mbarriers where the
//   bases are 16-byte aligned, else 4-byte cp.async copies into the same
//   layout. (A bf16 base that is not 4-byte aligned takes the general path.)
// - min(hd/16, 4) decay warps, a group of 16 channels at a time (lanes l
//   and l ^ 16 take the chunk's two halves of one channel), turn the stage's
//   r, k and w into a = r * P_prev and k~ (rows of hd + 8 floats),
//   b = (P_C / P) * k (rows of hd + 4),
//   P_C and the diagonal terms (r * u) . k (a reduce-scatter over the lanes),
//   with the clamps above. Each then computes the group's part of
//   M = tril(a k~^T, -1) + diag((r u) . k) on mma.sync (4 n8k8 tiles, 3xTF32)
//   into the group's own 16 x 16 block. The stage is ready when v has landed and every
//   decay warp has arrived (one mbarrier counts both).
// - hd/16 consumer warps each own 16 columns of S and of y. A warp keeps its
//   slice of S transposed, S^T[j][i], as mma.sync m16n8k8 accumulators for
//   the whole sequence (hd/8 n-tiles, 32 floats a lane at hd 64), loaded from
//   S_0 at the start and stored at the end. Per chunk it computes, in 3xTF32
//   (each operand split hi + lo, three products; plain TF32 would miss the
//   1e-4 tolerance):
//     y^T cols  = S^T a^T + v^T M^T   (m = the warp's 16 columns, n = C; M
//                                      the sum of the groups' blocks)
//     S^T cols  = S^T diag(P_C) + v^T b   (n = hd, k = C)
//   Inside each 8-wide k-step the k index is permuted (slot t <-> 2t, slot
//   t + 4 <-> 2t + 1), so the state's accumulator registers are, as they
//   stand, the A fragment of S^T: the state never leaves the registers, and
//   a, b and M are read as float2 pairs or conflict-free scalars. The column
//   slices never meet, so no block-wide barrier lies on the chunk-to-chunk
//   chain: a consumer warp waits only for its stage to be ready. With bf16
//   inputs v is exact in TF32, so its lo products are skipped.
//
// General path (wkv_chunk_kernel): every other shape (hd not a multiple of
// 16, C other than 16). One block per batch*head row walks the chunks with
// the state in shared memory (dynamic shared memory opted in above 48 KB):
// per chunk the block stages r, k, v, w, computes P, a, k~, (r*u)*k and b
// per channel (one thread per channel), then M (one thread per (t, s)), y
// (one thread per (t, column)) and the state update (one thread per entry),
// with barriers between the steps, all on the CUDA cores.
//
// wkv_chunk.py::launch_plan names the path, the stages, the shared bytes and
// the load path of a call; wkv_chunk_fast_smem answers its size check.
#include "attn_common.cuh"

#define WKV_THREADS 256
#define WKV_FAST_C 16
#define WKV_FAST_STAGES 3
#define WKV_FAST_MAX_HD 128

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(WKV_THREADS) wkv_chunk_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u, const float* __restrict__ S0,
    float* __restrict__ y, float* __restrict__ S_out, int S, int hd, int C)
{
    extern __shared__ float smem[];
    const int ld = hd | 1;
    const int mld = C + 1;
    float* st = smem;                    // hd x hd state, [i][j]
    float* u_s = st + hd * hd;           // hd
    float* ruk_s = u_s + hd;             // C x ld: r, then r * u * k
    float* a_s = ruk_s + C * ld;         // C x ld: a = r * P_prev
    float* k_s = a_s + C * ld;           // C x ld
    float* v_s = k_s + C * ld;           // C x ld
    float* p_s = v_s + C * ld;           // C x ld: w, then P
    float* kt_s = p_s + C * ld;          // C x ld: k / max(P, 1e-24)
    float* b_s = kt_s + C * ld;          // C x ld: (P_C / max(P, 1e-24)) * k
    float* m_s = b_s + C * ld;           // C x (C + 1)

    const int tid = threadIdx.x;
    const int64_t bh = blockIdx.x;
    const int64_t base = bh * S * hd;
    const int hh = hd * hd;
    for (int i = tid; i < hh; i += WKV_THREADS) st[i] = S0[bh * hh + i];
    for (int i = tid; i < hd; i += WKV_THREADS) u_s[i] = u[i];

    for (int t0 = 0; t0 < S; t0 += C) {
        __syncthreads();                 // the previous chunk (and the state) is done
        for (int idx = tid; idx < C * hd; idx += WKV_THREADS) {
            const int t = idx / hd, i = idx - t * hd;
            const int64_t g = base + (int64_t)(t0 + t) * hd + i;
            ruk_s[t * ld + i] = to_f32(r[g]);
            k_s[t * ld + i] = to_f32(k[g]);
            v_s[t * ld + i] = to_f32(v[g]);
            p_s[t * ld + i] = to_f32(w[g]);
        }
        __syncthreads();

        // Per channel: cumulative decay, a, k~, the bonus products, then b.
        for (int i = tid; i < hd; i += WKV_THREADS) {
            float P = 1.f;
            for (int t = 0; t < C; ++t) {
                const float rt = ruk_s[t * ld + i], kk = k_s[t * ld + i];
                const float Pn = P * p_s[t * ld + i];
                a_s[t * ld + i] = rt * P;
                kt_s[t * ld + i] = kk / fmaxf(Pn, 1e-24f);
                ruk_s[t * ld + i] = rt * u_s[i] * kk;
                p_s[t * ld + i] = Pn;
                P = Pn;
            }
            for (int t = 0; t < C; ++t)
                b_s[t * ld + i] = (P / fmaxf(p_s[t * ld + i], 1e-24f)) * k_s[t * ld + i];
        }
        __syncthreads();

        for (int idx = tid; idx < C * C; idx += WKV_THREADS) {
            const int t = idx / C, s = idx - t * C;
            float acc = 0.f;
            if (t > s) {
                for (int i = 0; i < hd; ++i) acc = fmaf(a_s[t * ld + i], kt_s[s * ld + i], acc);
            } else if (t == s) {
                for (int i = 0; i < hd; ++i) acc += ruk_s[t * ld + i];
            }
            m_s[t * mld + s] = acc;
        }
        __syncthreads();

        for (int idx = tid; idx < C * hd; idx += WKV_THREADS) {
            const int t = idx / hd, j = idx - t * hd;
            float intra = 0.f, inter = 0.f;
            for (int s = 0; s < C; ++s) intra = fmaf(m_s[t * mld + s], v_s[s * ld + j], intra);
            for (int i = 0; i < hd; ++i) inter = fmaf(a_s[t * ld + i], st[i * hd + j], inter);
            y[base + (int64_t)(t0 + t) * hd + j] = intra + inter;
        }
        __syncthreads();                 // every read of S_0 is done

        const float* pc = p_s + (C - 1) * ld;
        for (int idx = tid; idx < hh; idx += WKV_THREADS) {
            const int i = idx / hd, j = idx - i * hd;
            float kv = 0.f;
            for (int s = 0; s < C; ++s) kv = fmaf(b_s[s * ld + i], v_s[s * ld + j], kv);
            st[idx] = pc[i] * st[idx] + kv;
        }
    }
    __syncthreads();
    for (int i = tid; i < hh; i += WKV_THREADS) S_out[bh * hh + i] = st[i];
}

extern "C" {

const char* wkv_chunk_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// r, k, v, w: (BH, S, hd) contiguous, dtype 0 = float32, 1 = bfloat16;
// u: (hd,), S0: (BH, hd, hd) float32; y: (BH, S, hd), S_out: (BH, hd, hd)
// float32. S is a multiple of C. smem_bytes is the layout above
// (repro_torch/kernels/wkv_chunk.py::shared_bytes). Launches on `stream`;
// returns cudaGetLastError() (0 on success).
int wkv_chunk_forward(const void* r, const void* k, const void* v, const void* w,
                      const void* u, const void* S0, void* y, void* S_out,
                      int BH, int S, int hd, int C, int dtype, long long smem_bytes,
                      void* stream) {
    if (BH < 1 || hd < 1 || C < 1 || S < C || S % C) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) {
        if (smem_bytes > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                wkv_chunk_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem_bytes);
            if (err != cudaSuccess) return (int)err;
        }
        wkv_chunk_kernel<float><<<BH, WKV_THREADS, (size_t)smem_bytes, st>>>(
            (const float*)r, (const float*)k, (const float*)v, (const float*)w,
            (const float*)u, (const float*)S0, (float*)y, (float*)S_out, S, hd, C);
    } else if (dtype == 1) {
        if (smem_bytes > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                wkv_chunk_kernel<__nv_bfloat16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem_bytes);
            if (err != cudaSuccess) return (int)err;
        }
        wkv_chunk_kernel<__nv_bfloat16><<<BH, WKV_THREADS, (size_t)smem_bytes, st>>>(
            (const __nv_bfloat16*)r, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
            (const __nv_bfloat16*)w, (const float*)u, (const float*)S0, (float*)y,
            (float*)S_out, S, hd, C);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fast path
// ---------------------------------------------------------------------------

template <int HD>
struct WkvFast {
    static constexpr int C = WKV_FAST_C;
    static constexpr int NCW = HD / 16;                 // consumer warps, 16 columns each
    static constexpr int NG = HD / 16;                  // channel groups of 16
    // Decay warps, a channel group at a time. At most 4: with one per group,
    // hd 128's 17-warp block got 96 registers a thread from ptxas and spilled.
    static constexpr int NDW = NG < 4 ? NG : 4;
    static constexpr int THREADS = 32 * (NCW + NDW + 1);
    static constexpr int NI = HD / 8;                   // n-tiles of a warp's S^T slice
    static constexpr int LDA = HD + 8;                  // a and k~ rows: float2 loads conflict-free
    static constexpr int LDB = HD + 4;                  // b rows: scalar loads conflict-free
    static constexpr int LDM = C + 8;                   // M rows: float2 loads conflict-free
    static_assert(HD % 16 == 0 && HD <= WKV_FAST_MAX_HD, "hd is a multiple of 16 up to 128");
};

// One stage: r, k, v, w as loaded (C*hd elements each), then a, k~, b, the
// channel groups' partial diagonal sums, P_C and the groups' blocks of M,
// in float32. Every part starts on a 16-byte boundary. 128 bytes of
// mbarriers lie before the stages.
__host__ __device__ constexpr int wkv_fast_stage_bytes(int hd, int esize) {
    return 4 * WKV_FAST_C * hd * esize +
           4 * (2 * WKV_FAST_C * (hd + 8) + WKV_FAST_C * (hd + 4) + WKV_FAST_C * (hd / 16) + hd +
                (hd / 16) * WKV_FAST_C * (WKV_FAST_C + 8));
}

__host__ __device__ constexpr int wkv_fast_smem_bytes(int hd, int esize) {
    return 128 + WKV_FAST_STAGES * wkv_fast_stage_bytes(hd, esize);
}

template <typename T, int HD>
struct WkvStage {
    static constexpr int C = WKV_FAST_C;
    static constexpr int CB = C * HD * (int)sizeof(T);  // bytes of one input's chunk
    static constexpr int BYTES = wkv_fast_stage_bytes(HD, (int)sizeof(T));
    const T* r;
    const T* k;
    const T* v;
    const T* w;
    float* a;
    float* kt;
    float* b;
    float* d;
    float* pc;
    float* m;
    __device__ __forceinline__ explicit WkvStage(unsigned char* p) {
        using F = WkvFast<HD>;
        r = reinterpret_cast<const T*>(p);
        k = reinterpret_cast<const T*>(p + CB);
        v = reinterpret_cast<const T*>(p + 2 * CB);
        w = reinterpret_cast<const T*>(p + 3 * CB);
        a = reinterpret_cast<float*>(p + 4 * CB);
        kt = a + C * F::LDA;
        b = kt + C * F::LDA;
        d = b + C * F::LDB;
        pc = d + C * F::NG;
        m = pc + HD;
    }
};

// One input's chunk (CB bytes, its base 4-byte aligned) into shared memory
// by the producer warp's lanes, in 4-byte cp.async copies.
template <int CB>
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const void* src, int lane) {
    const char* s = reinterpret_cast<const char*>(src);
    for (int i = lane; i < CB / 4; i += 32) cp_async4(smem_u32(dst + 4 * i), s + 4 * i, 4u);
}

// The decay terms of one stage for channel i of group grp, tokens [8h, 8h + 8)
// (two lanes per channel, lane l and l ^ 16): P over the chunk (each half's
// running product, the second half's started from the first half's last), a,
// k~, b, P_C, and the group's partial (r * u) . k of every token. The divisions are
// __fdividef (a reciprocal and a product, no slow-path branch, within 2 ulp),
// so the tokens' chains overlap; the diagonal sums leave the lanes by a
// reduce-scatter over each half-warp (8 shuffles), after which lane 16h + 2t'
// holds token 8h + t''s sum of the group's 16 channels.
template <typename T, int HD>
__device__ __forceinline__ void decay_terms(const WkvStage<T, HD>& st, int i, int h, float ui,
                                            int grp, int lane) {
    using F = WkvFast<HD>;
    constexpr int C = F::C, H = C / 2;
    float rt[H], kv[H], Pt[H], ruk[H];
#pragma unroll
    for (int t = 0; t < H; ++t) {
        const int e = (H * h + t) * HD + i;
        rt[t] = to_f32(st.r[e]);
        kv[t] = to_f32(st.k[e]);
        Pt[t] = to_f32(st.w[e]);
    }
    float P = 1.f;
#pragma unroll
    for (int t = 0; t < H; ++t) {
        P *= Pt[t];
        Pt[t] = P;
    }
    // The first half's P_7 starts the second half; both halves' running
    // products make P_C.
    const float other = __shfl_xor_sync(0xffffffffu, P, 16);
    const float p0 = h ? other : 1.f;
    const float pc = P * other;
    float prev = p0;
#pragma unroll
    for (int t = 0; t < H; ++t) {
        const float Pn = h ? p0 * Pt[t] : Pt[t];
        const int row = H * h + t;
        st.a[row * F::LDA + i] = rt[t] * prev;
        st.kt[row * F::LDA + i] = __fdividef(kv[t], fmaxf(Pn, 1e-24f));
        st.b[row * F::LDB + i] = __fdividef(pc, fmaxf(Pn, 1e-24f)) * kv[t];
        ruk[t] = rt[t] * ui * kv[t];
        prev = Pn;
    }
    if (h) st.pc[i] = pc;
    // Reduce-scatter over the half-warp: at each level a lane keeps the half
    // of its tokens that its lane bit selects and adds its partner's.
#pragma unroll
    for (int half = H / 2, bit = 8; half >= 1; half >>= 1, bit >>= 1) {
        const bool upper = lane & bit;
#pragma unroll
        for (int j = 0; j < half; ++j) {
            const float keep = upper ? ruk[j + half] : ruk[j];
            const float send = upper ? ruk[j] : ruk[j + half];
            ruk[j] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
        }
    }
    ruk[0] += __shfl_xor_sync(0xffffffffu, ruk[0], 1);
    if ((lane & 1) == 0) st.d[grp * C + H * h + ((lane >> 1) & 7)] = ruk[0];
}

// Split a fragment of N values into TF32 hi and lo.
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
    for (int n = 0; n < N; ++n) split_tf32(x[n], hi[n], lo[n]);
}

// The warp's v^T fragments of one chunk (A operand, m = its 16 columns, k =
// the chunk's tokens in the permuted order), split. With bf16 inputs lo is 0.
template <typename T, int HD>
__device__ __forceinline__ void v_frags(const WkvStage<T, HD>& st, int j0, int g, int q,
                                        uint32_t (&vh)[2][4], uint32_t (&vl)[2][4]) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
        const T* v0 = st.v + (8 * ks + 2 * q) * HD + j0 + g;
        const float x[4] = {to_f32(v0[0]), to_f32(v0[8]), to_f32(v0[HD]), to_f32(v0[HD + 8])};
        split_frag<4>(x, vh[ks], vl[ks]);
    }
}

// Channel group grp's part of M = tril(a k~^T, -1) + diag((r u) . k): the
// sums over its 16 channels (two k-steps, both n-tiles, 3xTF32), masked,
// into its own 16 x 16 block of st.m. The consumers add the NG blocks.
template <typename T, int HD>
__device__ __forceinline__ void chunk_scores(const WkvStage<T, HD>& st, int grp, int g, int q) {
    using F = WkvFast<HD>;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 2 * grp; kk < 2 * grp + 2; ++kk) {
        const float* ak = st.a + 8 * kk + 2 * q;
        const float2 a0 = *reinterpret_cast<const float2*>(ak + g * F::LDA);
        const float2 a1 = *reinterpret_cast<const float2*>(ak + (g + 8) * F::LDA);
        uint32_t ah[4], al[4];
        split_frag<4>({a0.x, a1.x, a0.y, a1.y}, ah, al);
#pragma unroll
        for (int ns = 0; ns < 2; ++ns) {
            const float2 kv =
                *reinterpret_cast<const float2*>(st.kt + (8 * ns + g) * F::LDA + 8 * kk + 2 * q);
            uint32_t kh[2], kl[2];
            split_frag<2>({kv.x, kv.y}, kh, kl);
            mma_tf32(acc[ns], al, kh);
            mma_tf32(acc[ns], ah, kl);
            mma_tf32(acc[ns], ah, kh);
        }
    }
    const float dg[2] = {st.d[grp * F::C + g], st.d[grp * F::C + g + 8]};
    float* mb = st.m + grp * F::C * F::LDM;
#pragma unroll
    for (int ns = 0; ns < 2; ++ns) {
        float m[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int t = g + 8 * (c >> 1), s = 8 * ns + 2 * q + (c & 1);
            m[c] = t > s ? acc[ns][c] : (t == s ? dg[c >> 1] : 0.f);
        }
        *reinterpret_cast<float2*>(mb + g * F::LDM + 8 * ns + 2 * q) = make_float2(m[0], m[1]);
        *reinterpret_cast<float2*>(mb + (g + 8) * F::LDM + 8 * ns + 2 * q) =
            make_float2(m[2], m[3]);
    }
}

// y of one chunk for the warp's 16 columns, y^T = S^T a^T + v^T M^T (M the
// sum of the groups' blocks), stored to yc (the chunk's first row of y).
// Even and odd k-steps of S^T a^T go to two accumulators.
template <typename T, int HD>
__device__ __forceinline__ void chunk_output(const float (&St)[HD / 8][4],
                                             const WkvStage<T, HD>& st,
                                             const uint32_t (&vh)[2][4], const uint32_t (&vl)[2][4],
                                             float* __restrict__ yc, int j0, int g, int q) {
    using F = WkvFast<HD>;
    float Y[2][2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) Y[e][n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < F::NI; ++kk) {
        // a^T's B fragments for tokens 0-7 (row g) and 8-15 (row g + 8),
        // channels 8kk + 2q and + 1.
        const float* ak = st.a + 8 * kk + 2 * q;
        const float2 a0 = *reinterpret_cast<const float2*>(ak + g * F::LDA);
        const float2 a1 = *reinterpret_cast<const float2*>(ak + (g + 8) * F::LDA);
        uint32_t bh[2][2], bl[2][2];
        split_frag<2>({a0.x, a0.y}, bh[0], bl[0]);
        split_frag<2>({a1.x, a1.y}, bh[1], bl[1]);
        // S^T's n-tile kk is the A fragment of k-step kk as it stands.
        uint32_t sh[4], sl[4];
        split_frag<4>({St[kk][0], St[kk][2], St[kk][1], St[kk][3]}, sh, sl);
        float (&acc)[2][4] = Y[kk & 1];
        mma_tf32(acc[0], sl, bh[0]);
        mma_tf32(acc[1], sl, bh[1]);
        mma_tf32(acc[0], sh, bl[0]);
        mma_tf32(acc[1], sh, bl[1]);
        mma_tf32(acc[0], sh, bh[0]);
        mma_tf32(acc[1], sh, bh[1]);
    }
    // v^T M^T: M^T's B fragment for tokens 8 nt + g is M's row 8 nt + g.
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            float2 mv = make_float2(0.f, 0.f);
#pragma unroll
            for (int grp = 0; grp < F::NG; ++grp) {
                const float2 p = *reinterpret_cast<const float2*>(
                    st.m + (grp * F::C + 8 * nt + g) * F::LDM + 8 * ks + 2 * q);
                mv.x += p.x;
                mv.y += p.y;
            }
            uint32_t mh[2], ml[2];
            split_frag<2>({mv.x, mv.y}, mh, ml);
            if constexpr (sizeof(T) == 4) mma_tf32(Y[1][nt], vl[ks], mh);
            mma_tf32(Y[1][nt], vh[ks], ml);
            mma_tf32(Y[1][nt], vh[ks], mh);
        }
    // Y[nt][c] is y[8 nt + 2q + (c & 1)][j0 + g + 8 (c >> 1)].
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
            yc[(8 * nt + 2 * q + (c & 1)) * HD + j0 + g + 8 * (c >> 1)] = Y[0][nt][c] + Y[1][nt][c];
}

// S^T cols <- S^T diag(P_C) + v^T b for the warp's 16 columns.
template <typename T, int HD>
__device__ __forceinline__ void state_update(float (&St)[HD / 8][4], const WkvStage<T, HD>& st,
                                             const uint32_t (&vh)[2][4],
                                             const uint32_t (&vl)[2][4], int g, int q) {
    using F = WkvFast<HD>;
#pragma unroll
    for (int ni = 0; ni < F::NI; ++ni) {
        const float2 p = *reinterpret_cast<const float2*>(st.pc + 8 * ni + 2 * q);
        St[ni][0] *= p.x;
        St[ni][1] *= p.y;
        St[ni][2] *= p.x;
        St[ni][3] *= p.y;
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int ni = 0; ni < F::NI; ++ni) {
            const float* b0 = st.b + (8 * ks + 2 * q) * F::LDB + 8 * ni + g;
            uint32_t bh[2], bl[2];
            split_frag<2>({b0[0], b0[F::LDB]}, bh, bl);
            if constexpr (sizeof(T) == 4) mma_tf32(St[ni], vl[ks], bh);
            mma_tf32(St[ni], vh[ks], bl);
            mma_tf32(St[ni], vh[ks], bh);
        }
}

template <typename T, int HD>
__global__ void __launch_bounds__(WkvFast<HD>::THREADS, HD <= 64 ? 2 : 1) wkv_fast_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u, const float* __restrict__ S0,
    float* __restrict__ y, float* __restrict__ S_out, int S, int load)
{
    using F = WkvFast<HD>;
    using Stage = WkvStage<T, HD>;
    constexpr int C = F::C, ST = WKV_FAST_STAGES, CB = Stage::CB;
    extern __shared__ __align__(16) unsigned char wkv_smem[];
    const uint32_t bar_load = smem_u32(wkv_smem);        // r, k, w landed
    const uint32_t bar_ready = bar_load + 8 * ST;      // v landed and the decay terms written
    const uint32_t bar_empty = bar_ready + 8 * ST;     // every consumer warp is done
    unsigned char* stages = wkv_smem + 128;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t bh = blockIdx.x;
    const int64_t base = bh * S * HD;
    const int n_chunks = S / C;

    if (threadIdx.x == 0) {
        for (int s = 0; s < ST; ++s) {
            mbar_init(bar_load + 8 * s, 1);
            mbar_init(bar_ready + 8 * s, 1 + F::NDW);
            mbar_init(bar_empty + 8 * s, F::NCW);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == F::NCW + F::NDW) {
        // Producer: chunk c into stage c % ST once every consumer is done with it.
        for (int c = 0; c < n_chunks; ++c) {
            const int s = c % ST;
            unsigned char* sp = stages + s * Stage::BYTES;
            const int64_t off = base + (int64_t)c * C * HD;
            mbar_wait(bar_empty + 8 * s, ((c / ST) & 1) ^ 1);
            if (load == 0) {
                if (lane == 0) {
                    mbar_expect_tx(bar_load + 8 * s, 3 * CB);
                    bulk_load(smem_u32(sp), r + off, CB, bar_load + 8 * s);
                    bulk_load(smem_u32(sp + CB), k + off, CB, bar_load + 8 * s);
                    bulk_load(smem_u32(sp + 3 * CB), w + off, CB, bar_load + 8 * s);
                    mbar_expect_tx(bar_ready + 8 * s, CB);
                    bulk_load(smem_u32(sp + 2 * CB), v + off, CB, bar_ready + 8 * s);
                }
            } else {
                copy_chunk<CB>(sp, r + off, lane);
                copy_chunk<CB>(sp + CB, k + off, lane);
                copy_chunk<CB>(sp + 3 * CB, w + off, lane);
                asm volatile("cp.async.wait_all;\n" ::: "memory");
                __syncwarp();
                if (lane == 0) mbar_arrive(bar_load + 8 * s);
                copy_chunk<CB>(sp + 2 * CB, v + off, lane);
                asm volatile("cp.async.wait_all;\n" ::: "memory");
                __syncwarp();
                if (lane == 0) mbar_arrive(bar_ready + 8 * s);
            }
        }
    } else if (warp >= F::NCW) {
        // Decay warps: channel groups dw, dw + NDW, ...; lanes l and l ^ 16
        // on one channel.
        const int dw = warp - F::NCW, h = lane >> 4;
        for (int c = 0; c < n_chunks; ++c) {
            const int s = c % ST;
            const Stage st(stages + s * Stage::BYTES);
            mbar_wait(bar_load + 8 * s, (c / ST) & 1);
            for (int grp = dw; grp < F::NG; grp += F::NDW) {
                const int i = 16 * grp + (lane & 15);
                decay_terms<T, HD>(st, i, h, __ldg(u + i), grp, lane);
                __syncwarp();
                chunk_scores<T, HD>(st, grp, lane >> 2, lane & 3);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_ready + 8 * s);
        }
    } else {
        // Consumers: S^T[j][i] for j in [j0, j0 + 16); St[ni][c] holds
        // S^T[j0 + g + 8 (c >> 1)][8 ni + 2q + (c & 1)].
        const int g = lane >> 2, q = lane & 3, j0 = 16 * warp;
        const float* s0 = S0 + bh * HD * HD;
        float St[F::NI][4];
#pragma unroll
        for (int ni = 0; ni < F::NI; ++ni)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                St[ni][c] = s0[(8 * ni + 2 * q + (c & 1)) * HD + j0 + g + 8 * (c >> 1)];
        for (int c = 0; c < n_chunks; ++c) {
            const int s = c % ST;
            const Stage st(stages + s * Stage::BYTES);
            mbar_wait(bar_ready + 8 * s, (c / ST) & 1);
            uint32_t vh[2][4], vl[2][4];
            v_frags<T, HD>(st, j0, g, q, vh, vl);
            chunk_output<T, HD>(St, st, vh, vl, y + base + (int64_t)c * C * HD, j0, g, q);
            state_update<T, HD>(St, st, vh, vl, g, q);
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_empty + 8 * s);
        }
        float* so = S_out + bh * HD * HD;
#pragma unroll
        for (int ni = 0; ni < F::NI; ++ni)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                so[(8 * ni + 2 * q + (c & 1)) * HD + j0 + g + 8 * (c >> 1)] = St[ni][c];
    }
}

template <typename T, int HD>
static int launch_fast(const void* r, const void* k, const void* v, const void* w, const void* u,
                       const void* S0, void* y, void* S_out, int BH, int S, int load,
                       cudaStream_t stream) {
    constexpr int smem = wkv_fast_smem_bytes(HD, (int)sizeof(T));
    auto kernel = wkv_fast_kernel<T, HD>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<BH, WkvFast<HD>::THREADS, smem, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u, (const float*)S0,
        (float*)y, (float*)S_out, S, load);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_fast(const void* r, const void* k, const void* v, const void* w,
                         const void* u, const void* S0, void* y, void* S_out, int BH, int S,
                         int hd, int load, cudaStream_t st) {
    switch (hd) {
        case 16: return launch_fast<T, 16>(r, k, v, w, u, S0, y, S_out, BH, S, load, st);
        case 32: return launch_fast<T, 32>(r, k, v, w, u, S0, y, S_out, BH, S, load, st);
        case 48: return launch_fast<T, 48>(r, k, v, w, u, S0, y, S_out, BH, S, load, st);
        case 64: return launch_fast<T, 64>(r, k, v, w, u, S0, y, S_out, BH, S, load, st);
        case 80: return launch_fast<T, 80>(r, k, v, w, u, S0, y, S_out, BH, S, load, st);
        case 96: return launch_fast<T, 96>(r, k, v, w, u, S0, y, S_out, BH, S, load, st);
        case 112: return launch_fast<T, 112>(r, k, v, w, u, S0, y, S_out, BH, S, load, st);
        case 128: return launch_fast<T, 128>(r, k, v, w, u, S0, y, S_out, BH, S, load, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" {

// Shared bytes of the fast path's block for head dim hd and dtype (0
// float32, 1 bfloat16), or -1 where the fast path does not take hd.
long long wkv_chunk_fast_smem(int hd, int dtype) {
    if (hd < 16 || hd > WKV_FAST_MAX_HD || hd % 16 || (dtype != 0 && dtype != 1)) return -1;
    return wkv_fast_smem_bytes(hd, dtype == 0 ? 4 : 2);
}

// The fast path: r, k, v, w: (BH, S, hd) contiguous, dtype 0 = float32, 1 =
// bfloat16; u, S0, y, S_out as wkv_chunk_forward; chunk 16 (S a multiple of
// it); hd a multiple of 16 up to 128. load: 0 bulk copies (every base 16-byte
// aligned), 1 cp.async 4-byte copies (every base 4-byte aligned). smem_bytes must be wkv_chunk_fast_smem(hd, dtype). Launches
// on `stream`; returns cudaGetLastError() (0 on success).
int wkv_chunk_fast_forward(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* S0, void* y, void* S_out, int BH, int S,
                           int hd, int dtype, int load, long long smem_bytes, void* stream) {
    if (BH < 1 || S < WKV_FAST_C || S % WKV_FAST_C || load < 0 || load > 1 ||
        smem_bytes != wkv_chunk_fast_smem(hd, dtype))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) return dispatch_fast<float>(r, k, v, w, u, S0, y, S_out, BH, S, hd, load, st);
    return dispatch_fast<__nv_bfloat16>(r, k, v, w, u, S0, y, S_out, BH, S, hd, load, st);
}

}  // extern "C"
