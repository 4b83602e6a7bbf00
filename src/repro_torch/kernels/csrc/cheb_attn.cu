// Fused polynomial-attention aggregation (FedGAT Eq. 6-7) for Hopper, sm_90a:
// the forward kernel and its backward.
//
// Forward. Replaces the Pallas TPU kernel repro/kernels/cheb_attn.py::cheb_attn
// (pallas_call at :146, body _cheb_attn_kernel at :50). For graph g, head h
// and node n:
//
//   e[b]   = Horner(q, x[g,h,n,b]) * mask[g,n,b]      (highest coefficient first)
//   out[d] = sum_b e[b] * h_nb[g,n,b,d] / sum_b e[b]  (0 where the sum is exactly 0)
//
// Bound: memory. Per node the kernel reads H*B scores, B mask values and a
// B x D neighbour-feature tile, and writes H*D outputs; the arithmetic is
// O(H*B*(p + D)) flops, far below the card's rate for those bytes (at the
// serving shape H8 N1e6 B16 D16, ~2.1 GB moved against ~8 GFLOP).
//
// Design: one block per (tile of nodes) x (tile of feature columns), with
// every head handled inside the block, as the TPU kernel's heads-innermost
// grid does: the h_nb tile is read from device memory once for all heads,
// not once per head. The block first evaluates the H x tile x B polynomial
// weights and the H x tile denominators into shared memory; then each
// thread owns one (node, column) pair, streams the node's B neighbour
// values of its column once (loads coalesced along D) and accumulates up to
// HEAD_CHUNK heads in registers. Ragged edges of N and D are masked here,
// so the caller pads nothing. No wgmma/TMA: this is a batched GEMV bound by
// memory, and the tile is far below the tensor cores' shapes.
//
// The launch configuration (node_tile x d_tile threads, dynamic shared
// memory) is chosen by repro_torch/kernels/cheb_attn.py::launch_config; the
// shared-memory layout below must match its size formula.
//
// Backward (cheb_attn_bwd_kernel below). Replaces the backward of
// repro/kernels/cheb_attn.py::cheb_attn_diff (_cheb_attn_diff_bwd at :189,
// jax.vjp of the oracle). See that kernel's comment.
#include <cuda_runtime.h>
#include <stdint.h>

#define CHEB_MAX_COEFFS 64
#define HEAD_CHUNK 8
#define BWD_THREADS 256

// Horner from the highest coefficient with separate roundings, as the
// reference's e * x + q_n (no FMA contraction).
__device__ __forceinline__ float horner(const float* q, int P, float x) {
    float acc = 0.f;
    for (int k = P - 1; k >= 0; --k) acc = __fadd_rn(__fmul_rn(acc, x), q[k]);
    return acc;
}

__global__ void cheb_attn_kernel(
    const float* __restrict__ x,       // (G, H, N, B)
    const float* __restrict__ h_nb,    // (G, N, B, D)
    const float* __restrict__ mask,    // (G, N, B)
    const float* __restrict__ coeffs,  // (P,)
    float* __restrict__ out,           // (G, H, N, D)
    int H, int64_t N, int B, int D, int P, int node_tile)
{
    extern __shared__ float smem[];
    const int BP = B | 1;  // odd row stride: the denominator loop is conflict-free
    float* q_s = smem;                                   // CHEB_MAX_COEFFS
    float* e_s = q_s + CHEB_MAX_COEFFS;                  // H * node_tile * BP
    float* den_s = e_s + (size_t)H * node_tile * BP;     // H * node_tile

    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    const int64_t g = blockIdx.z;
    const int64_t n0 = (int64_t)blockIdx.x * node_tile;

    for (int i = tid; i < P; i += nthreads) q_s[i] = coeffs[i];
    __syncthreads();

    // Phase 1: polynomial weights for every head of the node tile.
    const int per_head = node_tile * B;
    for (int i = tid; i < H * per_head; i += nthreads) {
        const int h = i / per_head;
        const int r = i - h * per_head;
        const int nl = r / B;
        const int b = r - nl * B;
        const int64_t n = n0 + nl;
        float e = 0.f;
        if (n < N) {
            const float xv = x[((g * H + h) * N + n) * B + b];
            // The mask multiplies after Horner, so inf * 0 is NaN as in the reference.
            e = horner(q_s, P, xv) * mask[(g * N + n) * B + b];
        }
        e_s[(h * node_tile + nl) * BP + b] = e;
    }
    __syncthreads();
    for (int i = tid; i < H * node_tile; i += nthreads) {
        const float* row = e_s + (size_t)i * BP;
        float s = 0.f;
        for (int b = 0; b < B; ++b) s += row[b];
        den_s[i] = s;
    }
    __syncthreads();

    // Phase 2: one thread per (node, feature column), all heads.
    const int nl = threadIdx.y;
    const int64_t n = n0 + nl;
    const int d = blockIdx.y * blockDim.x + threadIdx.x;
    if (n >= N || d >= D) return;
    const float* col = h_nb + (g * N + n) * B * (int64_t)D + d;
    for (int h0 = 0; h0 < H; h0 += HEAD_CHUNK) {
        float acc[HEAD_CHUNK];
#pragma unroll
        for (int k = 0; k < HEAD_CHUNK; ++k) acc[k] = 0.f;
        for (int b = 0; b < B; ++b) {
            const float v = col[(int64_t)b * D];
#pragma unroll
            for (int k = 0; k < HEAD_CHUNK; ++k)
                if (h0 + k < H) acc[k] = fmaf(e_s[((h0 + k) * node_tile + nl) * BP + b], v, acc[k]);
        }
#pragma unroll
        for (int k = 0; k < HEAD_CHUNK; ++k) {
            const int h = h0 + k;
            if (h < H) {
                const float den = den_s[h * node_tile + nl];
                // Exact zero only for an exactly zero denominator; negative ones divide.
                out[((g * H + h) * N + n) * D + d] = den != 0.f ? acc[k] / den : 0.f;
            }
        }
    }
}

// Backward of the aggregation. Given dout (G, H, N, D), with e, den and out
// as in the forward (recomputed here, not saved):
//
//   g_e[h,n,b]   = sum_d dout[h,n,d] * (h_nb[n,b,d] - out[h,n,d]) / den[h,n]
//                  (0 where den == 0)
//   dx[h,n,b]    = g_e * mask * poly'(x)
//   dh_nb[n,b,d] = sum_h (e[h,n,b] / den[h,n]) * dout[h,n,d]   (0 where den == 0)
//   dmask[n,b]   = sum_h g_e * poly(x)
//   dcoeffs[k]   = sum_{h,n,b} g_e * mask * x^k
//
// Any of dx, dh_nb, dmask and dq_part may be null: that cotangent is not
// computed (training asks for dx alone). dcoeffs is reduced across blocks
// in a second pass: each block writes its P partial sums to
// dq_part[block], and the wrapper sums the rows, so the result does not
// depend on the order blocks run in.
//
// Bound: memory. dx alone reads x, h_nb, mask and dout once and writes dx
// once (at the sbm_1m training shape H8 N1e6 B16 D16, ~2.6 GB against
// ~12 GFLOP). h_nb is read twice per node tile (for out, then for g_e);
// the second read comes from L1/L2, as the tile was just touched.
//
// Design: the forward's layout, one block per node tile with every head
// inside the block. The tile's scores, mask, weights, denominators, out and
// dout live in shared memory; ragged N and D are masked here. The D-sums
// of g_e run on groups of `group` lanes (group = next power of two >= D,
// at most 32), one (node, neighbour) pair per group, reduced with xor
// shuffles, so each lane's h_nb loads run along D.
__global__ void __launch_bounds__(BWD_THREADS) cheb_attn_bwd_kernel(
    const float* __restrict__ x,       // (G, H, N, B)
    const float* __restrict__ h_nb,    // (G, N, B, D)
    const float* __restrict__ mask,    // (G, N, B)
    const float* __restrict__ coeffs,  // (P,)
    const float* __restrict__ dout,    // (G, H, N, D)
    float* __restrict__ dx,            // (G, H, N, B) or null
    float* __restrict__ dh,            // (G, N, B, D) or null
    float* __restrict__ dmask,         // (G, N, B) or null
    float* __restrict__ dq_part,       // (G * node tiles, P) or null
    int H, int64_t N, int B, int D, int P, int T, int group)
{
    extern __shared__ float smem[];
    const int BP = B | 1;
    const int nwarps = BWD_THREADS / 32;
    float* q_s = smem;                                  // CHEB_MAX_COEFFS
    float* dq_s = q_s + CHEB_MAX_COEFFS;                // nwarps * CHEB_MAX_COEFFS
    float* den_s = dq_s + nwarps * CHEB_MAX_COEFFS;     // H * T
    float* m_s = den_s + H * T;                         // T * BP
    float* x_s = m_s + T * BP;                          // H * T * BP
    float* w_s = x_s + (size_t)H * T * BP;              // H * T * BP: e, then e / den
    float* g_s = w_s + (size_t)H * T * BP;              // H * T * BP: g_e
    float* out_s = g_s + (size_t)H * T * BP;            // H * T * D
    float* do_s = out_s + (size_t)H * T * D;            // H * T * D

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int64_t g = blockIdx.z;
    const int64_t n0 = (int64_t)blockIdx.x * T;
    const int TB = T * B;
    const int TD = T * D;

    for (int i = tid; i < P; i += BWD_THREADS) q_s[i] = coeffs[i];
    for (int i = tid; i < nwarps * CHEB_MAX_COEFFS; i += BWD_THREADS) dq_s[i] = 0.f;
    for (int i = tid; i < TB; i += BWD_THREADS) {
        const int nl = i / B, b = i - nl * B;
        const int64_t n = n0 + nl;
        m_s[nl * BP + b] = n < N ? mask[(g * N + n) * B + b] : 0.f;
    }
    for (int i = tid; i < H * TD; i += BWD_THREADS) {
        const int h = i / TD, r = i - h * TD;
        const int nl = r / D, d = r - nl * D;
        const int64_t n = n0 + nl;
        do_s[i] = n < N ? dout[((g * H + h) * N + n) * D + d] : 0.f;
        out_s[i] = 0.f;
    }
    __syncthreads();

    // Scores and weights e = poly(x) * mask for every head of the tile.
    for (int i = tid; i < H * TB; i += BWD_THREADS) {
        const int h = i / TB, r = i - h * TB;
        const int nl = r / B, b = r - nl * B;
        const int64_t n = n0 + nl;
        const float xv = n < N ? x[((g * H + h) * N + n) * B + b] : 0.f;
        const int s = (h * T + nl) * BP + b;
        x_s[s] = xv;
        w_s[s] = horner(q_s, P, xv) * m_s[nl * BP + b];
    }
    __syncthreads();
    for (int i = tid; i < H * T; i += BWD_THREADS) {
        const float* row = w_s + (size_t)i * BP;
        float s = 0.f;
        for (int b = 0; b < B; ++b) s += row[b];
        den_s[i] = s;
    }
    __syncthreads();

    // out = sum_b e h_nb / den, one thread per (node, column), all heads.
    for (int i = tid; i < TD; i += BWD_THREADS) {
        const int nl = i / D, d = i - nl * D;
        const int64_t n = n0 + nl;
        if (n >= N) continue;
        const float* col = h_nb + (g * N + n) * B * (int64_t)D + d;
        for (int b = 0; b < B; ++b) {
            const float v = col[(int64_t)b * D];
            for (int h = 0; h < H; ++h) {
                float* o = out_s + (h * T + nl) * D + d;
                *o = fmaf(w_s[(h * T + nl) * BP + b], v, *o);
            }
        }
        for (int h = 0; h < H; ++h) {
            const float den = den_s[h * T + nl];
            float* o = out_s + (h * T + nl) * D + d;
            *o = den != 0.f ? *o / den : 0.f;
        }
    }
    __syncthreads();
    if (dh != nullptr) {
        for (int i = tid; i < H * TB; i += BWD_THREADS) {
            const int h = i / TB, r = i - h * TB;
            const int nl = r / B, b = r - nl * B;
            const float den = den_s[h * T + nl];
            const int s = (h * T + nl) * BP + b;
            w_s[s] = den != 0.f ? w_s[s] / den : 0.f;
        }
        __syncthreads();
    }

    // g_e (and dh_nb): one (node, neighbour) pair per group of lanes. The
    // loop bounds are uniform over the warp, so every lane reaches the shuffles.
    const int ppw = 32 / group;                  // pairs per warp
    const int sub = lane / group, dl = lane - sub * group;
    for (int base = warp * ppw; base < TB; base += nwarps * ppw) {
        const int pair = base + sub;
        const int nl = pair / B, b = pair - nl * B;
        const int64_t n = n0 + nl;
        const bool valid = pair < TB && n < N;
        const float* hrow = h_nb + ((g * N + n) * B + b) * (int64_t)D;
        const int dend = valid ? D : 0;
        for (int h0 = 0; h0 < H; h0 += HEAD_CHUNK) {
            float acc[HEAD_CHUNK];
#pragma unroll
            for (int k = 0; k < HEAD_CHUNK; ++k) acc[k] = 0.f;
            for (int d = dl; d < dend; d += group) {
                const float v = hrow[d];
#pragma unroll
                for (int k = 0; k < HEAD_CHUNK; ++k) {
                    if (h0 + k < H) {
                        const int o = ((h0 + k) * T + nl) * D + d;
                        acc[k] = fmaf(do_s[o], v - out_s[o], acc[k]);
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < HEAD_CHUNK; ++k)
                for (int off = group >> 1; off > 0; off >>= 1)
                    acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
            if (valid && dl == 0) {
#pragma unroll
                for (int k = 0; k < HEAD_CHUNK; ++k) {
                    const int h = h0 + k;
                    if (h < H) {
                        // Exact zero only for an exactly zero denominator, as the forward.
                        const float den = den_s[h * T + nl];
                        g_s[(h * T + nl) * BP + b] = den != 0.f ? acc[k] / den : 0.f;
                    }
                }
            }
        }
        if (dh != nullptr) {
            for (int d = dl; d < dend; d += group) {
                float v = 0.f;
                for (int h = 0; h < H; ++h)
                    v = fmaf(w_s[(h * T + nl) * BP + b], do_s[(h * T + nl) * D + d], v);
                dh[((g * N + n) * B + b) * (int64_t)D + d] = v;
            }
        }
    }
    __syncthreads();

    // dx and dmask: one thread per (node, neighbour), all heads.
    if (dx != nullptr || dmask != nullptr) {
        for (int i = tid; i < TB; i += BWD_THREADS) {
            const int nl = i / B, b = i - nl * B;
            const int64_t n = n0 + nl;
            if (n >= N) continue;
            const float mv = m_s[nl * BP + b];
            float dm = 0.f;
            for (int h = 0; h < H; ++h) {
                const int s = (h * T + nl) * BP + b;
                const float xv = x_s[s];
                float p = 0.f, dp = 0.f;
                for (int k = P - 1; k >= 0; --k) {
                    dp = fmaf(dp, xv, p);
                    p = __fadd_rn(__fmul_rn(p, xv), q_s[k]);
                }
                const float ge = g_s[s];
                if (dx != nullptr) dx[((g * H + h) * N + n) * B + b] = ge * mv * dp;
                dm = fmaf(ge, p, dm);
            }
            if (dmask != nullptr) dmask[(g * N + n) * B + b] = dm;
        }
    }

    // dcoeffs: warp sums of g_e * mask * x^k, then one partial row per block.
    if (dq_part != nullptr) {
        const int HTB = H * TB;
        for (int base = warp * 32; base < HTB; base += BWD_THREADS) {
            const int i = base + lane;
            float gp = 0.f, xv = 0.f;
            if (i < HTB) {
                const int h = i / TB, r = i - h * TB;
                const int nl = r / B, b = r - nl * B;
                if (n0 + nl < N) {
                    const int s = (h * T + nl) * BP + b;
                    gp = g_s[s] * m_s[nl * BP + b];
                    xv = x_s[s];
                }
            }
            float pw = gp;
            for (int k = 0; k < P; ++k) {
                float v = pw;
                for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
                if (lane == 0) dq_s[warp * CHEB_MAX_COEFFS + k] += v;
                pw *= xv;
            }
        }
        __syncthreads();
        for (int k = tid; k < P; k += BWD_THREADS) {
            float s = 0.f;
            for (int w = 0; w < nwarps; ++w) s += dq_s[w * CHEB_MAX_COEFFS + k];
            dq_part[((int64_t)blockIdx.z * gridDim.x + blockIdx.x) * P + k] = s;
        }
    }
}

extern "C" {

int cheb_attn_max_coeffs(void) { return CHEB_MAX_COEFFS; }

const char* cheb_attn_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int cheb_attn_forward(
    const void* x, const void* h_nb, const void* mask, const void* coeffs, void* out,
    int G, int H, long long N, int B, int D, int P,
    int node_tile, int d_tile, long long smem_bytes, void* stream)
{
    if (smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            cheb_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 block(d_tile, node_tile);
    const dim3 grid((unsigned)((N + node_tile - 1) / node_tile),
                    (unsigned)((D + d_tile - 1) / d_tile), (unsigned)G);
    cheb_attn_kernel<<<grid, block, (size_t)smem_bytes, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)h_nb, (const float*)mask, (const float*)coeffs,
        (float*)out, H, (int64_t)N, B, D, P, node_tile);
    return (int)cudaGetLastError();
}

int cheb_attn_bwd_threads(void) { return BWD_THREADS; }

// Launches the backward on `stream`; null output pointers are skipped.
// Returns cudaGetLastError() (0 on success).
int cheb_attn_backward(
    const void* x, const void* h_nb, const void* mask, const void* coeffs, const void* dout,
    void* dx, void* dh, void* dmask, void* dq_part,
    int G, int H, long long N, int B, int D, int P,
    int node_tile, int group, long long smem_bytes, void* stream)
{
    if (smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            cheb_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((unsigned)((N + node_tile - 1) / node_tile), 1u, (unsigned)G);
    cheb_attn_bwd_kernel<<<grid, BWD_THREADS, (size_t)smem_bytes, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)h_nb, (const float*)mask, (const float*)coeffs,
        (const float*)dout, (float*)dx, (float*)dh, (float*)dmask, (float*)dq_part,
        H, (int64_t)N, B, D, P, node_tile, group);
    return (int)cudaGetLastError();
}

}  // extern "C"
