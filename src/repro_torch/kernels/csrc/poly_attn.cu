// Additive polynomial attention (FedGAT's score on sequences), for Hopper
// (sm_90a).
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
// (i, j) the kernel does Horner (2p flops) and the e . v sum (2 hd flops). At
// the yi-6b shape (B2 H32 S4096 hd128, p = 8, causal) that is ~1.5e11 float32
// flops, 2.2 ms at the card's float32 rate, against 0.16 ms for the bytes of
// q, k, v and out. So the bound is the float32 rate.
//
// Design. One block per (query tile of 64 rows, batch*head), with a loop over
// key tiles inside the block; key tiles wholly above the diagonal are
// skipped when causal, heaviest query tiles first. The block computes its
// 64 sq once, then per key tile each warp computes 8 of the tile's sk while
// it stages the value tile in shared memory. The 256 threads form a 16 x 16
// grid: thread (ty, tx) evaluates e for rows ty + 16i and columns tx + 16j
// (i, j < 4) in registers, writes them to shared memory and adds its part of
// each row's denominator; then it accumulates rows ty + 16i, columns
// tx + 16c of num in registers. Polynomial partial sums are plain
// associative adds, so num and den need no running max and no rescaling,
// the property the TPU kernel is built on. Ragged S and hd are masked here.
//
// This is the simple kernel, on the CUDA cores; the e . v product on the
// tensor cores is for a later version (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define POLY_TILE 64
#define POLY_THREADS 256
#define POLY_MAX_HD 256
#define POLY_MAX_COEFFS 64

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Horner from the highest coefficient with separate roundings, as the
// reference's e * x + q_n.
__device__ __forceinline__ float horner(const float* q, int P, float x) {
    float acc = 0.f;
    for (int n = P - 1; n >= 0; --n) acc = __fadd_rn(__fmul_rn(acc, x), q[n]);
    return acc;
}

__device__ __forceinline__ float sum16(float v) {
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float sum32(float v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// DC: output columns per thread; hd <= 16 * DC.
template <typename T, int DC>
__global__ void __launch_bounds__(POLY_THREADS) poly_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ a1, const float* __restrict__ a2,
    const float* __restrict__ coeffs, T* __restrict__ out,
    int BH, int H, int S, int hd, int P, int causal, float domain)
{
    extern __shared__ float smem[];
    float* c_s = smem;                           // POLY_MAX_COEFFS
    float* sq_s = c_s + POLY_MAX_COEFFS;         // POLY_TILE
    float* sk_s = sq_s + POLY_TILE;              // POLY_TILE
    float* e_s = sk_s + POLY_TILE;               // POLY_TILE x (POLY_TILE + 1)
    float* v_s = e_s + POLY_TILE * (POLY_TILE + 1);   // POLY_TILE x hd
    const int eld = POLY_TILE + 1;

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int warp = tid >> 5, lane = tid & 31;
    const int n_qt = (S + POLY_TILE - 1) / POLY_TILE;
    const int qt = n_qt - 1 - (int)(blockIdx.x / BH);     // heaviest tiles first
    const int bh = (int)(blockIdx.x % BH);
    const int64_t base = (int64_t)bh * S * hd;
    const float* a1h = a1 + (int64_t)(bh % H) * hd;
    const float* a2h = a2 + (int64_t)(bh % H) * hd;
    const int q0 = qt * POLY_TILE;

    for (int i = tid; i < P; i += POLY_THREADS) c_s[i] = coeffs[i];
    for (int r = warp; r < POLY_TILE; r += POLY_THREADS / 32) {
        const int row = q0 + r;
        float dot = 0.f;
        if (row < S)
            for (int c = lane; c < hd; c += 32)
                dot = fmaf(to_f32(q[base + (int64_t)row * hd + c]), a1h[c], dot);
        dot = sum32(dot);
        if (lane == 0) sq_s[r] = dot;
    }

    float num[4][DC], den[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        den[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) num[i][c] = 0.f;
    }

    const int k_end = causal ? min(S, q0 + POLY_TILE) : S;
    for (int k0 = 0; k0 < k_end; k0 += POLY_TILE) {
        __syncthreads();                          // the previous tile is consumed
        for (int r = warp; r < POLY_TILE; r += POLY_THREADS / 32) {
            const int row = k0 + r;
            float dot = 0.f;
            for (int c = lane; c < hd; c += 32) {
                float kv = 0.f, vv = 0.f;
                if (row < S) {
                    kv = to_f32(k[base + (int64_t)row * hd + c]);
                    vv = to_f32(v[base + (int64_t)row * hd + c]);
                }
                dot = fmaf(kv, a2h[c], dot);
                v_s[r * hd + c] = vv;
            }
            dot = sum32(dot);
            if (lane == 0) sk_s[r] = dot;
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + ty + 16 * i;
            const float sq = sq_s[ty + 16 * i];
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = k0 + tx + 16 * j;
                const float x = fminf(fmaxf(sq + sk_s[tx + 16 * j], -domain), domain);
                float e = horner(c_s, P, x);
                if ((causal && col > row) || col >= S) e = 0.f;
                e_s[(ty + 16 * i) * eld + tx + 16 * j] = e;
                part += e;
            }
            den[i] += sum16(part);
        }
        __syncthreads();

        const int kn = min(POLY_TILE, S - k0);
        for (int j = 0; j < kn; ++j) {
            float vv[DC];
#pragma unroll
            for (int c = 0; c < DC; ++c) {
                const int d = tx + 16 * c;
                vv[c] = d < hd ? v_s[j * hd + d] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float e = e_s[(ty + 16 * i) * eld + j];
#pragma unroll
                for (int c = 0; c < DC; ++c) num[i][c] = fmaf(e, vv[c], num[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= S) continue;
        const float d = fabsf(den[i]) < 1e-9f ? 1e-9f : den[i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
            const int col = tx + 16 * c;
            if (col < hd) store(out + base + (int64_t)row * hd + col, num[i][c] / d);
        }
    }
}

template <typename T, int DC>
static int launch(const void* q, const void* k, const void* v, const void* a1, const void* a2,
                  const void* coeffs, void* out, int BH, int H, int S, int hd, int P,
                  int causal, float domain, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (POLY_MAX_COEFFS + 2 * POLY_TILE
                                         + POLY_TILE * (POLY_TILE + 1) + POLY_TILE * hd);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            poly_attn_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int64_t blocks = (int64_t)BH * ((S + POLY_TILE - 1) / POLY_TILE);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    poly_attn_kernel<T, DC><<<(unsigned)blocks, POLY_THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)a1, (const float*)a2,
        (const float*)coeffs, (T*)out, BH, H, S, hd, P, causal, domain);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, const void* a1, const void* a2,
                    const void* coeffs, void* out, int BH, int H, int S, int hd, int P,
                    int causal, float domain, cudaStream_t st) {
    if (hd <= 32) return launch<T, 2>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal, domain, st);
    if (hd <= 64) return launch<T, 4>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal, domain, st);
    if (hd <= 128) return launch<T, 8>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal, domain, st);
    return launch<T, 16>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal, domain, st);
}

extern "C" {

void poly_attn_limits(int* max_hd, int* max_coeffs) {
    *max_hd = POLY_MAX_HD;
    *max_coeffs = POLY_MAX_COEFFS;
}

const char* poly_attn_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// q, k, v, out: (BH, S, hd) contiguous, dtype 0 = float32, 1 = bfloat16;
// a1, a2: (H, hd) float32, head of row bh = bh % H; coeffs: (P,) float32.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int poly_attn_forward(const void* q, const void* k, const void* v, const void* a1,
                      const void* a2, const void* coeffs, void* out, int BH, int H, int S,
                      int hd, int P, int causal, float domain, int dtype, void* stream) {
    if (BH < 1 || H < 1 || S < 1 || hd < 1 || hd > POLY_MAX_HD || P < 1 || P > POLY_MAX_COEFFS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch<float>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal, domain, st);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(q, k, v, a1, a2, coeffs, out, BH, H, S, hd, P, causal,
                                       domain, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
