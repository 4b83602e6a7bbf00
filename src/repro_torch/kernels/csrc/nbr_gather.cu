// The backward of the neighbour gather y = x[:, idx, :] for Hopper, sm_90a:
//
//   dx[h, j, :] = sum over the slots s with idx[s] == j, in slot order, of dy[h, s, :]
//
// It replaces no TPU kernel: the reference leaves the gather's backward to
// XLA's scatter-add. It was added because PyTorch's own backward of plain
// indexing (index_put_ with accumulate) sorts the indices and then walks
// each run of equal indices in one warp; a padded neighbour list points
// every padded slot at node 0, so that run holds about half of all slots
// and one warp walks it while the card waits.
//
// Bound: memory. The kernel reads the cotangent once (H*S*F floats), the
// sorted slot ids and keys once, and writes dx once; there is one add per
// float read. At ogbn-arxiv's size (S = 5.4M slots, F = 40) that is ~0.9 GB.
//
// Design. The wrapper sorts the slots by their index (stably) into `perm`
// (slot ids) and `keys` (the index of each sorted slot). The sorted list is
// cut into chunks of CHUNK slots, and each thread takes one chunk and one
// unit of the row: a float4 of F columns where F is a multiple of 4 and the
// rows are 16-byte aligned, else one float, for one head. It walks its
// chunk in order and adds the rows of each run of equal keys. A run that
// starts and ends inside the chunk is written to dx directly. A run that
// crosses the chunk's edge leaves a partial instead: the chunk writes two
// entries, L (the run it began inside, if that one started in an earlier
// chunk) and R (the run that starts inside it and goes on past its end).
// The 2 * chunks entries, each with its key, are again a list of runs in
// order, so the same kernel sums them in a next level, until one chunk
// holds the whole list. So a hub's run of millions of slots spreads over
// thousands of threads, and its partials fold in a few small levels. No
// atomics: every sum is taken in an order fixed by the chunking, so two
// runs give the same bits. An empty L or R entry holds a zero; an empty R
// takes L's key (or -1 where L is empty too), so that a run's entries stay
// contiguous in the next level; a key of -1 is never written.
#include <cuda_runtime.h>
#include <stdint.h>

#define NBR_CHUNK 64
#define NBR_THREADS 256
#define NBR_ILP 4

namespace {

template <bool VEC> struct Word { typedef float T; };
template <> struct Word<true> { typedef float4 T; };

__device__ __forceinline__ float load_word(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 load_word(const float4* p) { return __ldg(p); }
__device__ __forceinline__ void add_word(float& a, float b) { a += b; }
__device__ __forceinline__ void add_word(float4& a, float4 b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
template <typename T> __device__ __forceinline__ T zero_word();
template <> __device__ __forceinline__ float zero_word<float>() { return 0.0f; }
template <> __device__ __forceinline__ float4 zero_word<float4>() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One level. src: (H, n, F) floats, read at row perm[p] (level 1) or p (later
// levels). Complete runs go to dst (H, m, F); with part non-null the chunks'
// L and R entries go to part (H, 2 * chunks, F) and part_keys (2 * chunks).
template <bool VEC>
__global__ void __launch_bounds__(NBR_THREADS)
nbr_gather_bwd_level(const float* __restrict__ src, const int* __restrict__ perm,
                     const int* __restrict__ keys, int64_t n, int H, int F, int64_t m,
                     float* __restrict__ dst, float* __restrict__ part,
                     int* __restrict__ part_keys, int64_t chunks)
{
    typedef typename Word<VEC>::T T;
    const int words = VEC ? F / 4 : F;                 // units of one head's row
    const int64_t t = (int64_t)blockIdx.x * NBR_THREADS + threadIdx.x;
    const int64_t c = t / (H * words);
    if (c >= chunks) return;
    const int unit = (int)(t - c * (H * words));
    const int h = unit / words, w = unit - h * words;
    const T* row0 = reinterpret_cast<const T*>(src + (int64_t)h * n * F) + w;
    const int64_t row_words = VEC ? F / 4 : F;

    const int64_t start = c * NBR_CHUNK;
    const int64_t end = start + NBR_CHUNK < n ? start + NBR_CHUNK : n;
    int cur = __ldg(keys + start);
    const bool before = start > 0 && __ldg(keys + start - 1) == cur;
    const bool after = end < n && __ldg(keys + end) == __ldg(keys + end - 1);
    bool first = true;
    T acc = zero_word<T>(), l_val = zero_word<T>(), r_val = zero_word<T>();
    int l_key = -1, r_key = -1;

    auto flush = [&](bool ends_after) {
        if (cur < 0) return;
        if (first && before) {
            l_val = acc; l_key = cur;
        } else if (ends_after) {
            r_val = acc; r_key = cur;
        } else {
            reinterpret_cast<T*>(dst + ((int64_t)h * m + cur) * F)[w] = acc;
        }
    };

    for (int64_t p = start; p < end; p += NBR_ILP) {
        int k[NBR_ILP];
        T v[NBR_ILP];
#pragma unroll
        for (int i = 0; i < NBR_ILP; ++i) {
            if (p + i < end) {
                k[i] = __ldg(keys + p + i);
                const int64_t s = perm != nullptr ? (int64_t)__ldg(perm + p + i) : p + i;
                v[i] = load_word(row0 + s * row_words);
            }
        }
#pragma unroll
        for (int i = 0; i < NBR_ILP; ++i) {
            if (p + i < end) {
                if (k[i] != cur) {
                    flush(false);
                    first = false;
                    cur = k[i];
                    acc = zero_word<T>();
                }
                add_word(acc, v[i]);
            }
        }
    }
    flush(after);

    if (part != nullptr) {
        T* out = reinterpret_cast<T*>(part + ((int64_t)h * 2 * chunks + 2 * c) * F) + w;
        out[0] = l_val;
        out[row_words] = r_val;
        if (unit == 0) {
            part_keys[2 * c] = l_key;
            part_keys[2 * c + 1] = r_key >= 0 ? r_key : l_key;
        }
    }
}

}  // namespace

extern "C" {

int nbr_gather_chunk(void) { return NBR_CHUNK; }

const char* nbr_gather_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Launches one level on `stream`: `chunks` = ceil(n / NBR_CHUNK) chunks of
// the n entries, H * F / 4 threads a chunk with vec (F a multiple of 4, src,
// dst and part 16-byte aligned), else H * F. perm is null after level 1;
// part and part_keys are null on the last level (one chunk). Returns
// cudaGetLastError() (0 on success).
int nbr_gather_backward_level(
    const void* src, const void* perm, const void* keys, long long n, int H, int F,
    long long m, void* dst, void* part, void* part_keys, long long chunks, int vec,
    void* stream)
{
    if (n < 1 || H < 1 || F < 1 || (vec && F % 4) ||
        chunks != (n + NBR_CHUNK - 1) / NBR_CHUNK || (chunks > 1 && part == nullptr))
        return (int)cudaErrorInvalidValue;
    const long long threads = chunks * H * (vec ? F / 4 : F);
    const long long grid = (threads + NBR_THREADS - 1) / NBR_THREADS;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (vec)
        nbr_gather_bwd_level<true><<<(unsigned)grid, NBR_THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)src, (const int*)perm, (const int*)keys, n, H, F, m, (float*)dst,
            (float*)part, (int*)part_keys, chunks);
    else
        nbr_gather_bwd_level<false><<<(unsigned)grid, NBR_THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)src, (const int*)perm, (const int*)keys, n, H, F, m, (float*)dst,
            (float*)part, (int*)part_keys, chunks);
    return (int)cudaGetLastError();
}

}  // extern "C"
