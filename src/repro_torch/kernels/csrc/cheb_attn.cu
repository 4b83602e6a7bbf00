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
// Design (cheb_attn_fwd_kernel below): a persistent grid of one wave (as
// many blocks as fit on the card, from the occupancy query) walks tiles of
// T consecutive nodes in a fixed stride. Each block keeps a ring of
// FWD_STAGES stages in shared memory, filled by one producer warp: a node
// tile's H score segments (each T*B floats, contiguous in (G,H,N,B)), its
// T*B*D neighbour span and its T*B mask span arrive as 1-D bulk copies
// (cp.async.bulk, completing on the stage's mbarrier), so the loads of the
// next tiles are in flight while the consumer warps work on this one. Where
// a bulk copy cannot take them (B not a multiple of 4, a base not 16-byte
// aligned, or a D cut into chunks) the same warp fills the same stage
// layout with cp.async copies. Consumer warps take one node at a time:
// Horner on the staged scores (lanes walk the (h, b) items without integer
// division), den by xor shuffles over the B lanes of a head where B is a
// power of two up to 32 (else a sum over the warp's staged weights), then
// each lane accumulates a head's run of 4 columns (float4 reads of the
// staged neighbour tile, one weight read per neighbour) and stores its 16
// bytes of the output row; a warp's stores fill whole 32-byte sectors, so
// the output is not staged. Tiles too large for shared memory cut D into
// chunks of d_chunk columns, one node at a time. The heads stay inside the
// block, as the TPU kernel's heads-innermost grid does: the neighbour tile
// is read from device memory once for all heads. With the loads in flight
// the consumers' arithmetic sets the time on an H100 (the loads alone run
// near the bound; PERF.md): Horner keeps the reference's separate
// roundings, so each coefficient load serves four chains, and B is a
// template constant where it is a power of two up to 32.
//
// The plan (tile, d_chunk, warps, shared memory, load path) is chosen by
// repro_torch/kernels/cheb_attn.py::launch_plan; its size formula is
// fwd_smem_bytes below.
//
// Backward (cheb_attn_bwd_kernel below). Replaces the backward of
// repro/kernels/cheb_attn.py::cheb_attn_diff (_cheb_attn_diff_bwd at :189,
// jax.vjp of the oracle). See that kernel's comment.
#include "attn_common.cuh"

#define CHEB_MAX_COEFFS 64
#define FWD_MAX_WARPS 8
#define FWD_STAGES 2
#define BWD_MAX_WARPS 8

// Horner from the highest coefficient with separate roundings, as the
// reference's e * x + q_n (no FMA contraction).
__device__ __forceinline__ float horner(const float* q, int P, float x) {
    float acc = 0.f;
    for (int k = P - 1; k >= 0; --k) acc = __fadd_rn(__fmul_rn(acc, x), q[k]);
    return acc;
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
// dq_part[block], and the wrapper sums the rows. Nodes go to warps in a
// fixed order, so the result does not depend on the order blocks run in.
//
// Bound: memory. dx alone reads x, h_nb, mask and dout once and writes dx
// once (at the sbm_1m training shape H8 N1e6 B16 D16, ~2.6 GB against
// ~12 GFLOP).
//
// Design: one warp owns one node at a time, in a grid-stride loop over the
// G*N nodes. It stages the node's H x B scores, its mask row, its B x D
// neighbour tile and its H x D dout in its own slice of shared memory
// (16-byte loads where the rows allow), each read from device memory once,
// and syncs only with __syncwarp. Horner runs once per score, for p and
// p' together, four scores of a lane at a time. g_e is factored into two
// small products:
//
//   A[h,b] = sum_d dout[h,d] * h_nb[b,d]
//   c[h]   = sum_d dout[h,d] * out[h,d] = sum_b w[h,b] * A[h,b],  w = e / den
//   g_e    = (A - c) / den
//
// so `out` is never formed: w, den, A and c live in the slice, and nothing
// is accumulated across heads by read-modify-write. Shapes whose tile does
// not fit a slice loop over D in chunks of d_chunk columns (A accumulates
// over the chunks). The copies are cp.async, all of a node's in flight at
// once. Lanes walk their (h, b) items by increments, without integer
// division. A second staged buffer, to fetch the next node during this
// one, measured slower than the warps it costs. Where B is a power of two
// up to 32, H*B is 32, 64 or 128, the tile is one chunk and neither dh_nb
// nor dcoeffs is asked for (training's request), the register path keeps
// each lane's items in registers and sums den and c over the B lanes of a
// head with xor shuffles. dcoeffs
// accumulates in registers (PQ >= P of them) and meets the only
// block-wide barrier, around the per-block partial. The slice layout
// (floats, each array rounded up to 4) must match
// repro_torch/kernels/cheb_attn.py::backward_launch_config:
//
//   xs H*B (scores) | ms B | hs B*ld (h_nb chunk) | ds H*ld (dout chunk) |
//   ps H*B (p) | dps H*B (p') | ws H*B (e, then w) | as H*B (A, then g_e) |
//   inv H (1 / den) | cs H
//
// with ld = bwd_ld(d_chunk): a multiple of 4 whose quarter is odd when
// d_chunk is (16-byte rows, and 8 lanes' rows in distinct banks), else
// d_chunk | 1 (odd: the lanes' rows in distinct banks).

__host__ __device__ __forceinline__ int bwd_ld(int dc) {
    if (dc % 4) return dc | 1;
    const int q = dc / 4 + 1;
    return 4 * (q + 1 - (q & 1));
}

// A lane's walk over the entries of a rows x cols block, 32 entries apart:
// (r, c) advances by (dr, dc) and carries, so no loop divides.
struct Walk {
    int r, c, dr, dc, cols;
    __device__ __forceinline__ Walk(int cols_, int lane)
        : r(lane / cols_), c(lane % cols_), dr(32 / cols_), dc(32 % cols_), cols(cols_) {}
    __device__ __forceinline__ void next() {
        r += dr;
        c += dc;
        if (c >= cols) {
            c -= cols;
            ++r;
        }
    }
};

// Rows x cols floats from src (row stride src_stride) into dst (row stride
// ld), as cp.async copies spread over the warp's lanes along `w` (a walk
// over cols, or over cols / 4 when vec: then cols, src_stride, src and the
// rows of dst are 16-byte multiples, and each lane copies 16 bytes at a
// time). No lane waits here: every copy of a node is in flight at once.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* __restrict__ src,
                                           int64_t src_stride, int rows, Walk w, bool vec) {
    if (vec) {
        for (; w.r < rows; w.next())
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(smem_u32(dst + w.r * ld + 4 * w.c)),
                            "l"(src + w.r * src_stride + 4 * w.c) : "memory");
    } else {
        for (; w.r < rows; w.next())
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                         :: "r"(smem_u32(dst + w.r * ld + w.c)),
                            "l"(src + w.r * src_stride + w.c) : "memory");
    }
}

__device__ __forceinline__ void stage_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for all but the newest n groups of this lane's copies, then make the
// warp's copies visible to every lane.
template <int n>
__device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
    __syncwarp();
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ long long round4(long long n) { return (n + 3) & ~3LL; }

// Forward stage layout, in floats, each array at a 16-byte multiple: H score
// segments of T*B at stride fwd_xld (one node row past T*B, so that
// consecutive heads' segments continue each other's banks), the mask span
// and the neighbour span (T*B rows of d_chunk).
__host__ __device__ __forceinline__ int fwd_xld(int T, int B) { return round4((T + 1) * B); }

__host__ __device__ __forceinline__ long long fwd_stage_floats(int H, int B, int T, int DC) {
    return (long long)H * fwd_xld(T, B) + round4(T * B) + round4((long long)T * B * DC);
}

// The forward's shared memory: 128 bytes of barriers, the coefficients, each
// consumer warp's weights (H rows at the odd stride B | 1) and denominators,
// then FWD_STAGES stages. repro_torch/kernels/cheb_attn.py::launch_plan
// computes the same.
__host__ __device__ __forceinline__ long long fwd_smem_bytes(int H, int B, int T, int DC, int W) {
    return 128 + 4 * CHEB_MAX_COEFFS + 4LL * W * (round4(H * (B | 1)) + round4(H)) +
           4LL * FWD_STAGES * fwd_stage_floats(H, B, T, DC);
}

// One node's weights e (into ew, H rows at the odd stride ES) and
// denominators (into dw), from its staged scores xr (head h at h * xld) and
// mask row mr. BP > 0: B == BP, a power of two up to 32, so a lane's items
// share one neighbour b = lane % B and a head's B items lie in B
// consecutive lanes: den by xor shuffles. Four items of a lane at a time,
// so that one coefficient load serves four independent Horner chains.
// BP == 0: any B; lanes walk the (h, b) items, den summed from ew.
template <int BP>
__device__ __forceinline__ void node_weights(float* ew, float* dw, const float* xr,
                                             const float* mr, const float* q_s, int H, int B,
                                             int ES, int xld, int P, Walk wx, int lane) {
    if constexpr (BP > 0) {
        constexpr int HPW = 32 / BP;                        // heads per warp row
        const int b = lane & (BP - 1), h0 = lane / BP;
        const float m = mr[b];
        const int nit = (H + HPW - 1) / HPW;
        // Horner's first step, 0 * x + q[P-1], is q[P-1] for a finite x; an
        // infinite x then gives an infinite weight where the reference's is
        // NaN, and the node's outputs are NaN all the same (inf / inf, inf * 0).
        const float q_top = q_s[P - 1];
        for (int j0 = 0; j0 < nit; j0 += 4) {
            float xv[4], acc[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int h = h0 + HPW * (j0 + u);
                xv[u] = (j0 + u < nit && h < H) ? xr[h * xld + b] : 0.f;
                acc[u] = q_top;
            }
#pragma unroll 2
            for (int kq = P - 2; kq >= 0; --kq) {
                const float qk = q_s[kq];
#pragma unroll
                for (int u = 0; u < 4; ++u) acc[u] = __fadd_rn(__fmul_rn(acc[u], xv[u]), qk);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                if (j0 + u >= nit) break;                   // the same for every lane
                const int h = h0 + HPW * (j0 + u);
                // The mask multiplies after Horner, so inf * 0 is NaN as in the reference.
                float e = h < H ? acc[u] * m : 0.f;
                if (h < H) ew[h * ES + b] = e;
#pragma unroll
                for (int off = BP / 2; off > 0; off >>= 1)
                    e += __shfl_xor_sync(0xffffffffu, e, off);
                if (b == 0 && h < H) dw[h] = e;
            }
        }
    } else {
        for (Walk w = wx; w.r < H; w.next())
            ew[w.r * ES + w.c] = horner(q_s, P, xr[w.r * xld + w.c]) * mr[w.c];
        __syncwarp();
        for (int h = lane; h < H; h += 32) {
            float sum = 0.f;
            for (int b = 0; b < B; ++b) sum += ew[h * ES + b];
            dw[h] = sum;
        }
    }
}

// blockDim.x = 32 (W + 1): W consumer warps and the producer warp. Items are
// (graph, node tile, D chunk), walked from blockIdx.x in steps of gridDim.x;
// the k-th item of a block uses stage k % FWD_STAGES. bulk: the stage is
// filled by 1-D bulk copies (B % 4 == 0, one D chunk, 16-byte-aligned bases);
// else by cp.async, 16 bytes at a time for the neighbour rows when vec_h.
// BP: B when it is a power of two up to 32 (node_weights), else 0.
template <int BP>
__global__ void __launch_bounds__((FWD_MAX_WARPS + 1) * 32, 3) cheb_attn_fwd_kernel(
    const float* __restrict__ x,       // (G, H, N, B)
    const float* __restrict__ h_nb,    // (G, N, B, D)
    const float* __restrict__ mask,    // (G, N, B)
    const float* __restrict__ coeffs,  // (P,)
    float* __restrict__ out,           // (G, H, N, D)
    int G, int H, int64_t N, int B_, int D, int P, int T, int DC, int bulk, int vec_h)
{
    extern __shared__ float smem[];
    const int B = BP > 0 ? BP : B_;
    const int W = (int)(blockDim.x >> 5) - 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const uint32_t bar_full = smem_u32(smem), bar_empty = bar_full + 8 * FWD_STAGES;
    float* q_s = smem + 32;
    const int ES = B | 1, e_floats = round4(H * ES), per_warp = e_floats + round4(H);
    float* stages = q_s + CHEB_MAX_COEFFS + W * per_warp;
    const int xld = fwd_xld(T, B);
    const long long stage_floats = fwd_stage_floats(H, B, T, DC);
    const int n_dc = (D + DC - 1) / DC;
    const int64_t tiles = (N + T - 1) / T;

    for (int i = threadIdx.x; i < P; i += blockDim.x) q_s[i] = coeffs[i];
    if (threadIdx.x == 0) {
        for (int s = 0; s < FWD_STAGES; ++s) {
            mbar_init(bar_full + 8 * s, 1);
            mbar_init(bar_empty + 8 * s, W);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // The item (g, node tile t, chunk c), advanced by gridDim.x items at a
    // time with carries, so that no loop divides.
    int c = (int)(blockIdx.x % n_dc);
    int64_t t = blockIdx.x / n_dc, g = t / tiles;
    t -= g * tiles;
    const int c_step = (int)(gridDim.x % n_dc);
    const int64_t t_step = gridDim.x / n_dc;
    const Walk wx(B, lane);
    float* ew = q_s + CHEB_MAX_COEFFS + warp * per_warp;     // H x ES weights
    float* dw = ew + e_floats;                              // H denominators
    for (int k = 0; g < G; ++k) {
        const int s = k % FWD_STAGES;
        const uint32_t ph = (uint32_t)(k / FWD_STAGES) & 1u;
        const int64_t n0 = t * T;
        const int tv = (int)min((int64_t)T, N - n0);
        const int dcv = min(DC, D - c * DC);
        float* xs = stages + s * stage_floats;
        float* ms = xs + (int64_t)H * xld;
        float* hs = ms + round4(T * B);

        if (warp == W) {
            // Producer: fill stage s once every consumer warp is done with it.
            const float* hsrc = h_nb + (g * N + n0) * B * (int64_t)D + (int64_t)c * DC;
            mbar_wait(bar_empty + 8 * s, ph ^ 1u);
            if (bulk) {
                if (lane == 0) {
                    const uint32_t xb = 4u * tv * B, full = bar_full + 8 * s;
                    mbar_expect_tx(full, (uint32_t)H * xb + xb + xb * (uint32_t)D);
                    for (int h = 0; h < H; ++h)
                        bulk_load(smem_u32(xs + h * xld), x + ((g * H + h) * N + n0) * B, xb, full);
                    bulk_load(smem_u32(ms), mask + (g * N + n0) * B, xb, full);
                    bulk_load(smem_u32(hs), hsrc, xb * (uint32_t)D, full);
                }
            } else {
                for (int h = 0; h < H; ++h)
                    stage_rows(xs + h * xld, 0, x + ((g * H + h) * N + n0) * B, 0, 1,
                               Walk(tv * B, lane), false);
                stage_rows(ms, 0, mask + (g * N + n0) * B, 0, 1, Walk(tv * B, lane), false);
                stage_rows(hs, DC, hsrc, D, tv * B, Walk(vec_h ? dcv / 4 : dcv, lane), vec_h);
                asm volatile("cp.async.wait_all;\n" ::: "memory");
                __syncwarp();
                if (lane == 0) mbar_arrive(bar_full + 8 * s);
            }
        } else {
            // Consumers: one node per warp at a time; each lane accumulates a
            // head's run of 4 columns (or 1) over the node's neighbours.
            const bool vec = (D & 3) == 0 && (DC & 3) == 0;
            const Walk wo(vec ? dcv / 4 : dcv, lane);
            mbar_wait(bar_full + 8 * s, ph);
            for (int nl = warp; nl < tv; nl += W) {
                const int64_t n = n0 + nl;
                node_weights<BP>(ew, dw, xs + nl * B, ms + nl * B, q_s, H, B, ES, xld, P, wx,
                                 lane);
                __syncwarp();
                const float* hr = hs + (int64_t)nl * B * DC;
                float* orow = out + ((g * H) * N + n) * D + (int64_t)c * DC;
                for (Walk w = wo; w.r < H; w.next()) {
                    const float* er = ew + w.r * ES;
                    // Exact zero only for an exactly zero denominator; negative ones divide.
                    const float den = dw[w.r], inv = __frcp_rn(den);
                    float* o = orow + w.r * N * D;
                    if (vec) {
                        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
                        for (int b = 0; b < B; ++b) {
                            const float e = er[b];
                            const float4 hv =
                                *reinterpret_cast<const float4*>(hr + b * DC + 4 * w.c);
                            acc.x = fmaf(e, hv.x, acc.x);
                            acc.y = fmaf(e, hv.y, acc.y);
                            acc.z = fmaf(e, hv.z, acc.z);
                            acc.w = fmaf(e, hv.w, acc.w);
                        }
                        *reinterpret_cast<float4*>(o + 4 * w.c) = den != 0.f
                            ? make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
                    } else {
                        float acc = 0.f;
                        for (int b = 0; b < B; ++b) acc = fmaf(er[b], hr[b * DC + w.c], acc);
                        o[w.c] = den != 0.f ? acc * inv : 0.f;
                    }
                }
                __syncwarp();                  // the next node rewrites the weights
            }
            if (lane == 0) mbar_arrive(bar_empty + 8 * s);
        }
        c += c_step;
        t += t_step;
        if (c >= n_dc) {
            c -= n_dc;
            ++t;
        }
        while (t >= tiles) {
            t -= tiles;
            ++g;
        }
    }
}

// Register caps: 64 without dcoeffs (4 blocks of 8 warps per SM, so that
// shared memory, not registers, bounds the warps in flight), 128 with its
// PQ accumulators.
// PQ: registers for the dcoeffs partial (0: not asked for). IPL > 0: the
// register path, for B a power of two up to 32, H*B = 32 IPL, one D chunk,
// and neither dh_nb nor dcoeffs asked for.
template <int PQ, int IPL>
__global__ void __launch_bounds__(BWD_MAX_WARPS * 32, PQ > 0 ? 2 : 4) cheb_attn_bwd_kernel(
    const float* __restrict__ x,       // (G, H, N, B)
    const float* __restrict__ h_nb,    // (G, N, B, D)
    const float* __restrict__ mask,    // (G, N, B)
    const float* __restrict__ coeffs,  // (P,)
    const float* __restrict__ dout,    // (G, H, N, D)
    float* __restrict__ dx,            // (G, H, N, B) or null
    float* __restrict__ dh,            // (G, N, B, D) or null
    float* __restrict__ dmask,         // (G, N, B) or null
    float* __restrict__ dq_part,       // (grid, P), used when PQ > 0
    int G, int H, int64_t N, int B, int D, int P, int DC, int vec_b, int vec_d)
{
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int HB = H * B, ld = bwd_ld(DC);
    const int per_warp = 5 * round4(HB) + round4(B) + round4(B * ld) + round4(H * ld) +
                         2 * round4(H);
    float* q_s = smem;                                   // CHEB_MAX_COEFFS
    float* dq_s = q_s + CHEB_MAX_COEFFS;                 // nwarps * CHEB_MAX_COEFFS
    float* xs = dq_s + nwarps * CHEB_MAX_COEFFS + (size_t)warp * per_warp;
    float* ms = xs + round4(HB);
    float* hs = ms + round4(B);
    float* ds = hs + round4(B * ld);
    float* ps = ds + round4(H * ld);
    float* dps = ps + round4(HB);
    float* ws = dps + round4(HB);
    float* as = ws + round4(HB);
    float* inv = as + round4(HB);                        // 1 / den, 0 where den == 0
    float* cs = inv + round4(H);
    const bool need_ge = PQ > 0 || dx != nullptr || dmask != nullptr;
    const bool ld4 = DC % 4 == 0;

    for (int i = threadIdx.x; i < P; i += blockDim.x) q_s[i] = coeffs[i];
    __syncthreads();

    float dq[PQ > 0 ? PQ : 1];
#pragma unroll
    for (int k = 0; k < (PQ > 0 ? PQ : 1); ++k) dq[k] = 0.f;

    // Walks that do not depend on the node: the (h, b) items, the staging of
    // the B-rows, and of the full and the last D chunk.
    const Walk items(B, lane);
    const Walk wb(vec_b ? B / 4 : B, lane);
    const int n_chunks = (D + DC - 1) / DC, last = D - (n_chunks - 1) * DC;
    const Walk wd_full(vec_d ? DC / 4 : DC, lane), wd_last(vec_d ? last / 4 : last, lane);
    const Walk wh_full(DC, lane), wh_last(last, lane);

    const int64_t total = (int64_t)G * N;
    const int64_t step = (int64_t)gridDim.x * nwarps;
    int64_t t = (int64_t)blockIdx.x * nwarps + warp;
    int64_t g = t / N, n = t - g * N;
    for (; t < total; t += step) {
        const int64_t xrow = (g * H * N + n) * B;        // x[g, 0, n, 0]
        const int64_t orow = (g * H * N + n) * D;        // dout[g, 0, n, 0]
        stage_rows(ms, B, mask + t * B, 0, 1, wb, vec_b);
        stage_rows(xs, B, x + xrow, N * B, H, wb, vec_b);
        if (n_chunks == 1) stage_rows(hs, ld, h_nb + t * B * D, D, B, wd_last, vec_d);
        if (n_chunks == 1) stage_rows(ds, ld, dout + orow, N * D, H, wd_last, vec_d);
        stage_commit();
        stage_wait<0>();

        if constexpr (IPL > 0) {
            // The register path: lane holds items h = lane / B + j 32 / B,
            // b = lane % B (j < IPL); each h's B items lie in one aligned
            // group of B lanes, so den and c are xor-shuffle sums there.
            const int b = lane & (B - 1), h0 = lane / B, dh_step = 32 / B;
            const float mv = ms[b];
            float xv[IPL], p[IPL], dp[IPL], w[IPL], r[IPL], a[IPL];
#pragma unroll
            for (int j = 0; j < IPL; ++j) {
                xv[j] = xs[lane + 32 * j];
                p[j] = dp[j] = a[j] = 0.f;
            }
            for (int k = P - 1; k >= 0; --k) {
                const float q = q_s[k];
#pragma unroll
                for (int j = 0; j < IPL; ++j) {
                    dp[j] = __fadd_rn(__fmul_rn(dp[j], xv[j]), p[j]);
                    p[j] = __fadd_rn(__fmul_rn(p[j], xv[j]), q);
                }
            }
#pragma unroll
            for (int j = 0; j < IPL; ++j) {
                const float e = p[j] * mv;
                float den = e;
                for (int off = B >> 1; off > 0; off >>= 1)
                    den += __shfl_xor_sync(0xffffffffu, den, off);
                r[j] = den != 0.f ? __frcp_rn(den) : 0.f;     // 1 / den, rounded as 1.f / den
                w[j] = e * r[j];
            }
            // A for the lane's items: one h_nb row (b) against IPL dout rows,
            // the row loaded once per step and the IPL sums independent.
            const float* hr = hs + b * ld;
            const float* dr = ds + h0 * ld;
            const int dstep = dh_step * ld;
            if (ld4) {
                for (int d = 0; d < D; d += 4) {
                    const float4 hv = *reinterpret_cast<const float4*>(hr + d);
#pragma unroll
                    for (int j = 0; j < IPL; ++j) {
                        const float4 dv = *reinterpret_cast<const float4*>(dr + j * dstep + d);
                        a[j] = fmaf(dv.x, hv.x, a[j]);
                        a[j] = fmaf(dv.y, hv.y, a[j]);
                        a[j] = fmaf(dv.z, hv.z, a[j]);
                        a[j] = fmaf(dv.w, hv.w, a[j]);
                    }
                }
            } else {
                for (int d = 0; d < D; ++d)
#pragma unroll
                    for (int j = 0; j < IPL; ++j) a[j] = fmaf(dr[j * dstep + d], hr[d], a[j]);
            }
            float dm = 0.f;
            float* dxp = dx != nullptr ? dx + xrow + (int64_t)h0 * N * B + b : nullptr;
            const int64_t dx_step = (int64_t)dh_step * N * B;
#pragma unroll
            for (int j = 0; j < IPL; ++j) {
                float c = w[j] * a[j];
                for (int off = B >> 1; off > 0; off >>= 1)
                    c += __shfl_xor_sync(0xffffffffu, c, off);
                const float ge = r[j] != 0.f ? (a[j] - c) * r[j] : 0.f;
                if (dx != nullptr) dxp[j * dx_step] = ge * mv * dp[j];
                dm = fmaf(ge, p[j], dm);
            }
            if (dmask != nullptr) {
                for (int off = B; off < 32; off <<= 1) dm += __shfl_xor_sync(0xffffffffu, dm, off);
                if (lane < B) dmask[t * B + b] = dm;
            }
            __syncwarp();                                // this node's slice is consumed
            n += step;
            while (n >= N) {
                n -= N;
                ++g;
            }
            continue;
        }

        // Horner for p and p' on up to 4 items at once: one coefficient load
        // serves 4 independent chains.
        for (Walk w0 = items; w0.r < H;) {
            Walk w = w0;
            int idx[4], col[4];
            float xv[4], p[4], dp[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                idx[j] = w.r < H ? w.r * B + w.c : -1;
                col[j] = w.c;
                xv[j] = idx[j] >= 0 ? xs[idx[j]] : 0.f;
                p[j] = dp[j] = 0.f;
                w.next();
            }
            for (int k = P - 1; k >= 0; --k) {
                const float q = q_s[k];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    // Separate roundings in the reference's order (dp * x + p,
                    // then p * x + q_n): the degree-16 series cancels, and
                    // fused rounding moves p' by more than the tolerance.
                    dp[j] = __fadd_rn(__fmul_rn(dp[j], xv[j]), p[j]);
                    p[j] = __fadd_rn(__fmul_rn(p[j], xv[j]), q);
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (idx[j] < 0) break;
                ps[idx[j]] = p[j];
                dps[idx[j]] = dp[j];
                // The mask after Horner: inf * 0 is NaN, as the reference.
                ws[idx[j]] = p[j] * ms[col[j]];
                as[idx[j]] = 0.f;
            }
            w0 = w;
        }
        __syncwarp();
        for (int h = lane; h < H; h += 32) {
            float s = 0.f;
#pragma unroll 4
            for (int b = 0; b < B; ++b) s += ws[h * B + b];
            inv[h] = s != 0.f ? __frcp_rn(s) : 0.f;
        }
        __syncwarp();
        for (Walk w = items; w.r < H; w.next()) ws[w.r * B + w.c] *= inv[w.r];

        for (int d0 = 0, chunk = 0; d0 < D; d0 += DC, ++chunk) {
            const bool is_last = chunk == n_chunks - 1;
            const int dc = is_last ? last : DC;
            __syncwarp();                                // ws is complete; the chunk consumed
            if (n_chunks > 1) {
                const Walk w = is_last ? wd_last : wd_full;
                stage_rows(hs, ld, h_nb + t * B * D + d0, D, B, w, vec_d);
                stage_rows(ds, ld, dout + orow + d0, N * D, H, w, vec_d);
                stage_commit();
                stage_wait<0>();
            }
            if (need_ge) {
                for (Walk w = items; w.r < H; w.next()) {
                    const float* hr = hs + w.c * ld;
                    const float* dr = ds + w.r * ld;
                    float a = 0.f;
                    if (ld4 && (dc & 3) == 0) {
                        for (int d = 0; d < dc; d += 4) {
                            const float4 hv = *reinterpret_cast<const float4*>(hr + d);
                            const float4 dv = *reinterpret_cast<const float4*>(dr + d);
                            a = fmaf(dv.x, hv.x, a);
                            a = fmaf(dv.y, hv.y, a);
                            a = fmaf(dv.z, hv.z, a);
                            a = fmaf(dv.w, hv.w, a);
                        }
                    } else {
                        for (int d = 0; d < dc; ++d) a = fmaf(dr[d], hr[d], a);
                    }
                    as[w.r * B + w.c] += a;
                }
            }
            if (dh != nullptr) {
                for (Walk w = is_last ? wh_last : wh_full; w.r < B; w.next()) {
                    float v = 0.f;
                    for (int h = 0; h < H; ++h) v = fmaf(ws[h * B + w.r], ds[h * ld + w.c], v);
                    dh[(t * B + w.r) * D + d0 + w.c] = v;
                }
            }
        }

        if (need_ge) {
            __syncwarp();
            for (int h = lane; h < H; h += 32) {
                float s = 0.f;
#pragma unroll 4
                for (int b = 0; b < B; ++b) s = fmaf(ws[h * B + b], as[h * B + b], s);
                cs[h] = s;
            }
            __syncwarp();
            for (Walk w = items; w.r < H; w.next()) {
                const int i = w.r * B + w.c;
                const float r = inv[w.r];
                // Exact zero only for an exactly zero denominator, as the forward.
                const float ge = r != 0.f ? (as[i] - cs[w.r]) * r : 0.f;
                const float mv = ms[w.c];
                if (dx != nullptr) dx[xrow + (int64_t)w.r * N * B + w.c] = ge * mv * dps[i];
                as[i] = ge;
                if (PQ > 0) {
                    const float xv = xs[i];
                    float pw = ge * mv;
#pragma unroll
                    for (int k = 0; k < (PQ > 0 ? PQ : 1); ++k) {
                        if (k < P) {
                            dq[k] += pw;
                            pw *= xv;
                        }
                    }
                }
            }
            if (dmask != nullptr) {
                __syncwarp();
                for (int b = lane; b < B; b += 32) {
                    float s = 0.f;
                    for (int h = 0; h < H; ++h) s = fmaf(as[h * B + b], ps[h * B + b], s);
                    dmask[t * B + b] = s;
                }
            }
        }
        __syncwarp();                                    // this node's slice is consumed
        n += step;                                       // the next node, without dividing
        while (n >= N) {
            n -= N;
            ++g;
        }
    }

    if (PQ > 0) {
        // Lane sums in a fixed shuffle order, then the warps in order.
#pragma unroll
        for (int k = 0; k < (PQ > 0 ? PQ : 1); ++k) {
            if (k < P) {
                float v = dq[k];
                for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
                if (lane == 0) dq_s[warp * CHEB_MAX_COEFFS + k] = v;
            }
        }
        __syncthreads();
        for (int k = threadIdx.x; k < P; k += blockDim.x) {
            float s = 0.f;
            for (int w = 0; w < nwarps; ++w) s += dq_s[w * CHEB_MAX_COEFFS + k];
            dq_part[(int64_t)blockIdx.x * P + k] = s;
        }
    }
}

typedef void (*FwdKernel)(const float*, const float*, const float*, const float*, float*, int,
                          int, int64_t, int, int, int, int, int, int, int);

// The forward's instance for B: the shuffle path for a power of two up to 32.
static FwdKernel fwd_kernel(int B) {
    switch (B) {
        case 1: return &cheb_attn_fwd_kernel<1>;
        case 2: return &cheb_attn_fwd_kernel<2>;
        case 4: return &cheb_attn_fwd_kernel<4>;
        case 8: return &cheb_attn_fwd_kernel<8>;
        case 16: return &cheb_attn_fwd_kernel<16>;
        case 32: return &cheb_attn_fwd_kernel<32>;
        default: return &cheb_attn_fwd_kernel<0>;
    }
}

extern "C" {

int cheb_attn_max_coeffs(void) { return CHEB_MAX_COEFFS; }

const char* cheb_attn_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The forward's shared-memory bytes for a plan (fwd_smem_bytes), so that the
// wrapper can hold its own formula against this one.
long long cheb_attn_fwd_smem(int H, int B, int tile, int d_chunk, int warps) {
    return fwd_smem_bytes(H, B, tile, d_chunk, warps);
}

int cheb_attn_fwd_max_warps(void) { return FWD_MAX_WARPS; }

// Forward blocks (B's instance) of `warps` consumer warps plus the producer
// with `smem_bytes` of shared memory that fit on one SM at once, written to
// *out: the persistent grid is one wave of them.
int cheb_attn_fwd_blocks_per_sm(int B, int warps, long long smem_bytes, int* out) {
    const FwdKernel kernel = fwd_kernel(B);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, (warps + 1) * 32,
                                                            (size_t)smem_bytes);
    return (int)err;
}

// Launches the forward on `stream`: `grid` blocks of `warps` consumer warps
// and one producer warp, tiles of `tile` nodes and `d_chunk` columns; bulk:
// 1-D bulk copies fill the stages, else cp.async (16 bytes for the
// neighbour rows when vec_h). Returns cudaGetLastError() (0 on success).
int cheb_attn_forward(
    const void* x, const void* h_nb, const void* mask, const void* coeffs, void* out,
    int G, int H, long long N, int B, int D, int P, int tile, int d_chunk, int warps, int grid,
    int bulk, int vec_h, long long smem_bytes, void* stream)
{
    if (warps < 1 || warps > FWD_MAX_WARPS || tile < 1 || d_chunk < 1 || d_chunk > D || grid < 1 ||
        smem_bytes != fwd_smem_bytes(H, B, tile, d_chunk, warps))
        return (int)cudaErrorInvalidValue;
    const FwdKernel kernel = fwd_kernel(B);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)grid, (warps + 1) * 32, (size_t)smem_bytes, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)h_nb, (const float*)mask, (const float*)coeffs,
        (float*)out, G, H, (int64_t)N, B, D, P, tile, d_chunk, bulk, vec_h);
    return (int)cudaGetLastError();
}

int cheb_attn_bwd_max_warps(void) { return BWD_MAX_WARPS; }

}  // extern "C"

typedef void (*BwdKernel)(const float*, const float*, const float*, const float*, const float*,
                          float*, float*, float*, float*, int, int, int64_t, int, int, int, int,
                          int, int);

// The instance: dcoeffs' registers cover P, none without it; the register
// path where the shape and the cotangents allow it (see the kernel).
static BwdKernel bwd_kernel(int P, bool want_dq, bool want_dh, int H, int B, int D, int DC) {
    if (!want_dq && !want_dh && DC >= D && B <= 32 && (B & (B - 1)) == 0) {
        if (H * B == 32) return &cheb_attn_bwd_kernel<0, 1>;
        if (H * B == 64) return &cheb_attn_bwd_kernel<0, 2>;
        if (H * B == 128) return &cheb_attn_bwd_kernel<0, 4>;
    }
    if (!want_dq) return &cheb_attn_bwd_kernel<0, 0>;
    if (P <= 16) return &cheb_attn_bwd_kernel<16, 0>;
    if (P <= 32) return &cheb_attn_bwd_kernel<32, 0>;
    return &cheb_attn_bwd_kernel<CHEB_MAX_COEFFS, 0>;
}

static cudaError_t allow_smem(BwdKernel kernel, long long smem_bytes) {
    if (smem_bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_bytes);
}

extern "C" {

// Blocks of `warps` warps with `smem_bytes` of shared memory that fit on one
// SM at once (by registers, threads and shared memory), written to *out: the
// grid-stride loop's grid is one wave of them. Every instance without
// dcoeffs has the same register cap, so the general one answers for them.
int cheb_attn_bwd_blocks_per_sm(int P, int want_dq, int warps, long long smem_bytes, int* out) {
    const BwdKernel kernel = bwd_kernel(P, want_dq != 0, true, 0, 0, 0, 0);
    cudaError_t err = allow_smem(kernel, smem_bytes);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, warps * 32,
                                                            (size_t)smem_bytes);
    return (int)err;
}

// Launches the backward on `stream`: `grid` blocks of `warps` warps, in a
// grid-stride loop over the G*N nodes; null output pointers are skipped,
// and a non-null dq_part has `grid` rows of P. vec_b / vec_d: the B- and
// D-rows may be loaded as float4. Returns cudaGetLastError() (0 on success).
int cheb_attn_backward(
    const void* x, const void* h_nb, const void* mask, const void* coeffs, const void* dout,
    void* dx, void* dh, void* dmask, void* dq_part,
    int G, int H, long long N, int B, int D, int P,
    int warps, int d_chunk, int grid, int vec_b, int vec_d, long long smem_bytes, void* stream)
{
    if (warps < 1 || warps > BWD_MAX_WARPS || d_chunk < 1 || grid < 1)
        return (int)cudaErrorInvalidValue;
    const BwdKernel kernel = bwd_kernel(P, dq_part != nullptr, dh != nullptr, H, B, D, d_chunk);
    const cudaError_t err = allow_smem(kernel, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)grid, warps * 32, (size_t)smem_bytes, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)h_nb, (const float*)mask, (const float*)coeffs,
        (const float*)dout, (float*)dx, (float*)dh, (float*)dmask, (float*)dq_part,
        G, H, (int64_t)N, B, D, P, d_chunk, vec_b, vec_d);
    return (int)cudaGetLastError();
}

}  // extern "C"
