// Fused polynomial-attention aggregation (FedGAT Eq. 6-7) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/cheb_attn.py::cheb_attn
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
#include <cuda_runtime.h>
#include <stdint.h>

#define CHEB_MAX_COEFFS 64
#define HEAD_CHUNK 8

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
            float acc = 0.f;
            // Separate roundings, as the reference's e * x + q_n.
            for (int k = P - 1; k >= 0; --k) acc = __fadd_rn(__fmul_rn(acc, xv), q_s[k]);
            // The mask multiplies after Horner, so inf * 0 is NaN as in the reference.
            e = acc * mask[(g * N + n) * B + b];
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

}  // extern "C"
