// The MoE dispatch's positions: for each (token, choice) pair of a
// capacity-bounded top-k routing, its position among the pairs routed to
// the same expert, counted in token-major, choice-minor order, and from
// it the pair that fills each row of the experts' capacity.
//
// Replaces no TPU kernel: the JAX package's dispatch
// (src/repro/nn/moe.py::moe_apply) takes the positions as a cumsum over a
// (pairs x experts) one-hot, which XLA fuses.  Ported as it was, that
// cumsum was a PyTorch scan of an int64 (t*k, e) tensor that puts one
// thread on each of the e columns and walks the t*k rows one after
// another: a wave prefill's 131k pairs took ~50 ms a layer on the H100.
//
// Bound: bytes.  The pairs' expert ids are read (8 bytes a pair) and
// each slot's pair written (8 bytes a slot): ~2.4 MB at a wave prefill's
// 131k pairs and 163k slots, ~0.7 us at 3.35 TB/s, so the two launches
// are launch-bound.
//
// Design: two launches, no (pairs x experts) tensor anywhere.
//   (a) count_kernel: each block counts its tile of TILE pairs per expert
//       (a warp's pairs of one expert are grouped with __match_any_sync,
//       so one shared atomic a group) into row `tile` of a (tiles, e)
//       int32 table.  It also writes the sentinel `n` (no pair) into
//       every slot and zeroes the drop count, ahead of pass (b).
//   (b) rank_kernel: each block takes as its base, per expert, the rows
//       of the table before its own tile in its block of offsets (plus
//       that block's offset).  It walks its tile in rounds of THREADS
//       pairs: inside a warp a pair's rank among its same-expert peers is
//       the popcount of the lower lanes of its __match_any_sync group;
//       the warps' group sizes, through shared memory, give each warp's
//       exclusive count.  It writes each kept pair into `pair_of_slot`
//       and adds its pairs past capacity to the drop count with one
//       atomic.
//   Shared memory is sized from e (dbrx-132b has 16 experts, qwen3-moe
//   128).  Tiles never cross a block of offsets: the sharded step's rank
//   routes `nb` blocks of tokens (its pod group's), each counted from
//   its own place in the global token order.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;          // pairs a block (a tile)
constexpr int THREADS = 256;        // pairs a round
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Tile {
    long long start, end;           // the tile's pairs [start, end)
    int block;                      // its block of offsets
    int index;                      // its index inside the block
};

__device__ __forceinline__ Tile tile_of(int g, long long block_len, int tiles_per_block) {
    Tile t;
    t.block = g / tiles_per_block;
    t.index = g % tiles_per_block;
    const long long block_end = (long long)(t.block + 1) * block_len;
    t.start = (long long)t.block * block_len + (long long)t.index * TILE;
    t.end = t.start + TILE < block_end ? t.start + TILE : block_end;
    return t;
}

// The pair's expert, or -1 past the tile's end or for an id outside [0, e)
// (such a pair is counted nowhere and fills no slot).
__device__ __forceinline__ int expert_of(const long long* eid, long long i, long long end, int e) {
    if (i >= end) return -1;
    const long long v = eid[i];
    return v >= 0 && v < e ? (int)v : -1;
}

__global__ void count_kernel(const long long* __restrict__ eid, int* __restrict__ table,
                             long long* __restrict__ pair_of_slot,
                             unsigned long long* __restrict__ dropped, long long n,
                             long long block_len, int tiles_per_block, int e, long long n_slots) {
    extern __shared__ int hist[];
    const int tid = threadIdx.x, lane = tid & 31;
    const Tile t = tile_of(blockIdx.x, block_len, tiles_per_block);
    for (int x = tid; x < e; x += THREADS) hist[x] = 0;
    __syncthreads();
    for (long long i0 = t.start; i0 < t.end; i0 += THREADS) {
        const int ex = expert_of(eid, i0 + tid, t.end, e);
        const unsigned peers = __match_any_sync(FULL, ex);
        if (ex >= 0 && (peers & ((1u << lane) - 1)) == 0) atomicAdd(&hist[ex], __popc(peers));
    }
    __syncthreads();
    for (int x = tid; x < e; x += THREADS) table[(long long)blockIdx.x * e + x] = hist[x];
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long s = (long long)blockIdx.x * THREADS + tid; s < n_slots; s += stride)
        pair_of_slot[s] = n;
    if (blockIdx.x == 0 && tid == 0) *dropped = 0;
}

__global__ void rank_kernel(const long long* __restrict__ eid,
                            const long long* __restrict__ offsets, const int* __restrict__ table,
                            long long* __restrict__ pair_of_slot,
                            unsigned long long* __restrict__ dropped, long long block_len,
                            int tiles_per_block, int e, int cap, int e0, int el) {
    extern __shared__ int sm[];
    int* running = sm;              // (e,) the expert's pairs before this round
    int* groups = sm + e;           // (WARPS, e) each warp's group size this round
    __shared__ unsigned block_drops;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lower = (1u << lane) - 1;
    const Tile t = tile_of(blockIdx.x, block_len, tiles_per_block);
    const int* rows = table + (long long)t.block * tiles_per_block * e;
    for (int x = tid; x < e; x += THREADS) {
        long long base = offsets == nullptr ? 0 : offsets[(long long)t.block * e + x];
        for (int j = 0; j < t.index; ++j) base += rows[(long long)j * e + x];
        running[x] = (int)base;
        for (int w = 0; w < WARPS; ++w) groups[w * e + x] = 0;
    }
    if (tid == 0) block_drops = 0;
    __syncthreads();
    unsigned drops = 0;
    for (long long i0 = t.start; i0 < t.end; i0 += THREADS) {
        const long long i = i0 + tid;
        const int ex = expert_of(eid, i, t.end, e);
        const unsigned peers = __match_any_sync(FULL, ex);
        const int rank = __popc(peers & lower);
        const bool leader = ex >= 0 && rank == 0;
        if (leader) groups[warp * e + ex] = __popc(peers);
        __syncthreads();
        bool over = false;
        if (ex >= 0) {
            int pos = running[ex] + rank;
            for (int w = 0; w < warp; ++w) pos += groups[w * e + ex];
            over = pos >= cap;
            if (!over && ex >= e0 && ex < e0 + el)
                pair_of_slot[(long long)(ex - e0) * cap + pos] = i;
        }
        const unsigned past = __ballot_sync(FULL, over);
        if (lane == 0) drops += __popc(past);
        __syncthreads();
        if (leader) {
            atomicAdd(&running[ex], __popc(peers));
            groups[warp * e + ex] = 0;
        }
        __syncwarp();
    }
    if (lane == 0 && drops) atomicAdd(&block_drops, drops);
    __syncthreads();
    if (tid == 0 && block_drops) atomicAdd(dropped, (unsigned long long)block_drops);
}

// Dynamic shared memory above the default 48 KB needs the kernel's leave.
template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

int stripe_moe_dispatch_tile() { return TILE; }

// Pass (a) on ``stream`` over ``n_tiles`` tiles; returns cudaGetLastError().
int stripe_moe_dispatch_count(const long long* eid, int* table, long long* pair_of_slot,
                              unsigned long long* dropped, long long n, long long block_len,
                              int n_tiles, int tiles_per_block, int e, long long n_slots,
                              void* stream) {
    const size_t bytes = (size_t)e * sizeof(int);
    cudaError_t rc = allow_shared(count_kernel, bytes);
    if (rc != cudaSuccess) return (int)rc;
    count_kernel<<<n_tiles, THREADS, bytes, (cudaStream_t)stream>>>(
        eid, table, pair_of_slot, dropped, n, block_len, tiles_per_block, e, n_slots);
    return (int)cudaGetLastError();
}

// Pass (b) on ``stream``; ``offsets`` (nb, e) or null; returns
// cudaGetLastError().
int stripe_moe_dispatch_rank(const long long* eid, const long long* offsets, const int* table,
                             long long* pair_of_slot, unsigned long long* dropped,
                             long long block_len, int n_tiles, int tiles_per_block, int e,
                             int cap, int e0, int el, void* stream) {
    const size_t bytes = (size_t)(WARPS + 1) * e * sizeof(int);
    cudaError_t rc = allow_shared(rank_kernel, bytes);
    if (rc != cudaSuccess) return (int)rc;
    rank_kernel<<<n_tiles, THREADS, bytes, (cudaStream_t)stream>>>(
        eid, offsets, table, pair_of_slot, dropped, block_len, tiles_per_block, e, cap, e0, el);
    return (int)cudaGetLastError();
}

}  // extern "C"
