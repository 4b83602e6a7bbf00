// Causal softmax attention with an online softmax, for Hopper (sm_90a).
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
// take 2.75e11 flops: 0.28 ms at the bf16 tensor-core rate, 4.1 ms at the
// float32 rate; the bytes (q, k, v read once, out written once) take 0.08 ms
// in bf16. So the card's bound is its arithmetic rate.
//
// Design. One block per (query tile of 64 rows, batch*head), with a loop over
// key tiles inside the block in place of the TPU's sequential k grid
// dimension. Key tiles wholly above the diagonal are skipped when causal,
// and the heaviest query tiles (the last ones) are scheduled first. The
// query tile lives in shared memory for the whole loop; each key tile is
// staged, used for the 64 x 64 scores, then overwritten by the value tile.
// The 256 threads form a 16 x 16 grid: thread (ty, tx) computes the scores
// of rows ty + 16i and columns tx + 16j (i, j < 4) and owns rows ty + 16i,
// columns tx + 16c of the output accumulator in registers. Row max and row
// sum are reduced over the 16 threads of a row with xor shuffles; each
// thread keeps its rows' running max and normaliser. bf16 inputs are
// converted to float32 as they are staged. Ragged S (rows and keys past S)
// and ragged hd are masked here, so the caller pads nothing.
//
// This is the simple kernel: products run on the CUDA cores from shared
// memory. wgmma (bf16 on the tensor cores), TMA loads and a producer warp
// are what a later version would add; see PERF.md for its time against the
// bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define FLASH_TILE 64
#define FLASH_THREADS 256
#define FLASH_MAX_HD 256
#define FLASH_NEG_INF -1e30f

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows [r0, r0 + FLASH_TILE) of a (S, hd) matrix into a float32 tile with row
// stride ld; rows past S are zeros. One warp per row, lanes along hd.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int S, int hd, int ld) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < FLASH_TILE; r += FLASH_THREADS / 32) {
        const int row = r0 + r;
        for (int c = lane; c < hd; c += 32)
            dst[r * ld + c] = row < S ? to_f32(src[(int64_t)row * hd + c]) : 0.f;
    }
}

__device__ __forceinline__ float sum16(float v) {
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float max16(float v) {
    for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// DC: output columns per thread; hd <= 16 * DC.
template <typename T, int DC>
__global__ void __launch_bounds__(FLASH_THREADS) flash_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int BH, int S, int hd, int causal, float scale)
{
    extern __shared__ float smem[];
    const int ld = hd | 1;                       // odd stride: row reads are conflict-free
    float* q_s = smem;                           // FLASH_TILE x ld
    float* kv_s = q_s + FLASH_TILE * ld;         // FLASH_TILE x ld: keys, then values
    float* p_s = kv_s + FLASH_TILE * ld;         // FLASH_TILE x (FLASH_TILE + 1)
    const int pld = FLASH_TILE + 1;

    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int n_qt = (S + FLASH_TILE - 1) / FLASH_TILE;
    const int qt = n_qt - 1 - (int)(blockIdx.x / BH);     // heaviest tiles first
    const int64_t base = (int64_t)(blockIdx.x % BH) * S * hd;
    const int q0 = qt * FLASH_TILE;

    load_tile(q_s, q + base, q0, S, hd, ld);

    float m[4], l[4], acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = FLASH_NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    }

    const int k_end = causal ? min(S, q0 + FLASH_TILE) : S;
    for (int k0 = 0; k0 < k_end; k0 += FLASH_TILE) {
        __syncthreads();                          // the previous value tile is consumed
        load_tile(kv_s, k + base, k0, S, hd, ld);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int d = 0; d < hd; ++d) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * ld + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = kv_s[(tx + 16 * j) * ld + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + ty + 16 * i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = k0 + tx + 16 * j;
                float x = s[i][j] * scale;
                if (causal && col > row) x = FLASH_NEG_INF;
                if (col >= S) x = -INFINITY;      // past the sequence: no weight at all
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
            const float m_new = fmaxf(m[i], max16(mx));
            const float alpha = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                p_s[(ty + 16 * i) * pld + tx + 16 * j] = p;
                sum += p;
            }
            l[i] = alpha * l[i] + sum16(sum);
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();                          // scores written, key tile consumed
        load_tile(kv_s, v + base, k0, S, hd, ld);
        __syncthreads();

        const int kn = min(FLASH_TILE, S - k0);
        for (int j = 0; j < kn; ++j) {
            float vv[DC];
#pragma unroll
            for (int c = 0; c < DC; ++c) {
                const int d = tx + 16 * c;
                vv[c] = d < hd ? kv_s[j * ld + d] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float p = p_s[(ty + 16 * i) * pld + j];
#pragma unroll
                for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= S) continue;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
            const int d = tx + 16 * c;
            if (d < hd) store(out + base + (int64_t)row * hd + d, acc[i][c] / den);
        }
    }
}

template <typename T, int DC>
static int launch(const void* q, const void* k, const void* v, void* out, int BH, int S,
                  int hd, int causal, float scale, cudaStream_t stream) {
    const int ld = hd | 1;
    const size_t smem = sizeof(float) * (2 * FLASH_TILE * ld + FLASH_TILE * (FLASH_TILE + 1));
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            flash_attn_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int64_t blocks = (int64_t)BH * ((S + FLASH_TILE - 1) / FLASH_TILE);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    flash_attn_kernel<T, DC><<<(unsigned)blocks, FLASH_THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, BH, S, hd, causal, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* out, int BH, int S,
                    int hd, int causal, float scale, cudaStream_t stream) {
    if (hd <= 32) return launch<T, 2>(q, k, v, out, BH, S, hd, causal, scale, stream);
    if (hd <= 64) return launch<T, 4>(q, k, v, out, BH, S, hd, causal, scale, stream);
    if (hd <= 128) return launch<T, 8>(q, k, v, out, BH, S, hd, causal, scale, stream);
    return launch<T, 16>(q, k, v, out, BH, S, hd, causal, scale, stream);
}

extern "C" {

int flash_attn_max_head_dim(void) { return FLASH_MAX_HD; }

const char* flash_attn_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// q, k, v, out: (BH, S, hd) contiguous; dtype 0 = float32, 1 = bfloat16.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int flash_attn_forward(const void* q, const void* k, const void* v, void* out,
                       int BH, int S, int hd, int causal, int dtype, float scale,
                       void* stream) {
    if (BH < 1 || S < 1 || hd < 1 || hd > FLASH_MAX_HD) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) return dispatch<float>(q, k, v, out, BH, S, hd, causal, scale, st);
    if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, out, BH, S, hd, causal, scale, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
