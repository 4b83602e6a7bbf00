// Chunked RWKV6 wkv recurrence with data-dependent decay, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/wkv_chunk.py::wkv_chunked
// (pallas_call at :93, body _wkv_kernel at :29). Per (batch*head) row, with
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
// rwkv6-1.6b shape BH256 S4096 hd64, 1.34 GB, 0.40 ms at 3.35 TB/s), against
// ~2e10 flops (0.3 ms at the float32 rate).
//
// Design. One block per batch*head row; the loop over the S/C chunks runs
// inside the block in place of the TPU's sequential chunk grid dimension,
// with the state in shared memory (16 KB at hd 64, 64 KB at hd 128, dynamic
// shared memory opted in above 48 KB). Per chunk the block stages r, k, v, w,
// computes P, a, k~, (r*u)*k and the state's b per channel (one thread per
// channel, sequential over the chunk, as cumprod is), then M (one thread per
// (t, s)), then y (one thread per (t, column): the M v sum and the a S_0 sum,
// added as the TPU kernel adds its two products), then updates the state in
// place (one thread per entry). Chunk arrays have an odd row stride so the
// per-(t, s) dot products read shared memory without bank conflicts.
//
// Parallelism is BH blocks only: 256 blocks at the rwkv6-1.6b shape, about
// 2 per SM, and each block walks its 256 chunks in sequence with five
// barriers per chunk. Splitting the state's columns across blocks (each
// column block of S evolves on its own) or overlapping the next chunk's
// loads with this chunk's products is what a later version would change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define WKV_THREADS 256

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
