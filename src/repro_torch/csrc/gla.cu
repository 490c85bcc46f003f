// Chunkwise gated linear attention (mLSTM, Mamba2's SSD): a kernel on the
// CUDA cores, and two paths of two kernels each on the tensor cores (bf16,
// and float32 in 3xTF32).
//
// Replaces: src/repro/kernels/mlstm_chunk/kernel.py::chunked_gla (the
// pl.pallas_call at :136, body _gla_kernel at :65).  The recurrence
//
//     C_t = exp(ld_t) C_{t-1} + g_t k_t v_t^T      (Dk x Dv state)
//     n_t = exp(ld_t) n_{t-1} + g_t k_t            (normalizer)
//     h_t = q_t C_t  [ / max(|q_t . n_t|, 1) ]
//
// evaluated a chunk of L steps at a time.  On the TPU the grid is (B*H,
// chunks) with the chunk axis sequential and the whole (Dk, Dv) state in
// VMEM scratch.  Three paths (kernel.py::path_of picks one before the
// launch): ``wgmma`` for bf16 and ``tf32x3`` for float32 (below, after the
// CUDA-core kernel), and ``cuda_cores`` for the shapes and types neither
// takes.
//
// cuda_cores: one CTA owns one (b*h, tile of TV = 64 columns of Dv), b*h
// and the tile flattened on grid x, and loops over the chunks itself, carrying its Dk x 64 float32
// slice of C in shared memory (384 x 64 x 4 = 96 KiB at xLSTM-125m's
// width, where the whole 384 x 384 state, 576 KiB, fits no CTA).  The
// columns of C evolve independently, so the Dv tiles share nothing but
// their inputs: each CTA recomputes the chunk's cumulative decay, the
// normalizer n and the intra-chunk scores q k^T, a redundancy of
// ceil(Dv / 64) this first version accepts.
//
// Per chunk, with the numerics of _gla_kernel (kernel.py:80-111):
//   cum = inclusive cumsum of ld (a warp scan), w_s = exp(cum_L - cum_s) g_s;
//   per row tile of 64 steps t (the L x L float32 scores, 256 KiB at
//   L = 256, fit no CTA; a 64 x 64 tile of them does):
//     h = exp(cum_t) (q_t . C_prev) + sum_{s<=t} (q_t . k_s) exp(cum_t - cum_s) g_s v_s
//     with the mask inside the exp (-inf above the diagonal: the upper
//     triangle never overflows), and under ``normalize``
//     h /= max(|sum_s scores_ts + exp(cum_t) (q_t . n_prev)|, 1);
//     column tiles of s above the row tile's diagonal are skipped (all 0);
//   C = exp(cum_L) C + (k w)^T v and n = exp(cum_L) n + sum_s k_s w_s.
// q is scaled by ``scale`` as it is read.  Every product is a 64 x 64
// output tile from 256 threads, each a 4 x 4 block of it, its operands
// staged in shared memory (float4 reads) in slabs of 32 along the depth;
// a thread issues all its loads of a slab before it stores any (the trip
// counts are compile-time), so a slab costs one round trip to L2.  The
// inter part q @ C_prev rides on the first score tile's q slabs.  q, k
// and v load as their type (f32 or bf16: a template parameter), the
// decays and gains by their type codes, once per chunk.
//
// What bounds it: operations.  At xLSTM-125m's width (Dk = Dv = 384,
// L = 256) a chunk does about 4 L Dk Dv + 2 L^2 (Dk + Dv) flops per
// (L (2 Dk + Dv) + L Dv) elements moved; far above the ridge.  This
// kernel runs them on the CUDA cores in float32.  The tensor-core paths
// compute the scores once per 128 columns of Dv: ``wgmma`` on bf16 inputs,
// ``tf32x3`` on float32 inputs with every product split into three tf32
// products, which keeps float32's accuracy (plain TF32 would not).

#include "dag.cuh"
#include "hopper.cuh"

#define GLA_THREADS 256
#define GLA_TV 64   // Dv columns per CTA
#define GLA_T 64    // rows (and columns) of a score tile
#define GLA_KD 32   // depth of a staged slab
#define GLA_LD 68   // row stride of the staging tiles (float4-aligned)

struct GlaParams {
    const void* q;   // (BH, S, Dk)
    const void* k;   // (BH, S, Dk)
    const void* v;   // (BH, S, Dv)
    const void* ld;  // (BH, S) log decay
    const void* g;   // (BH, S) gain
    void* o;         // (BH, S, Dv)
    int s, dk, dv, chunk;
    int qkv_dt, ld_dt, g_dt, out_dt;
    int normalize;
    float scale;
};

// shared memory of one CTA, in floats
// (n is padded to a multiple of 4 floats: the staging tiles after it are
// read as float4)
__host__ __device__ inline int gla_smem_floats(int dk, int chunk) {
    return dk * GLA_TV + ((dk + 3) & ~3) + 4 * chunk + GLA_T + 2 * GLA_T * GLA_LD;
}

// element ``off`` of a tensor of element type T, as float
template <typename T>
__device__ __forceinline__ float ld(const void* p, long long off) {
    return Elem<T>::f(__ldg((const T*)p + off));
}

// Stage a 32 x 64 slab of a row-major (rows, width) tensor into shared
// memory, zero outside ``n_rows`` x ``n_cols``: element (row0 + r, col0 + c)
// times ``scale``, or times the row's weight w[row0 + r] where ``w`` is
// given, goes to
//   dst[c * GLA_LD + r]   (transposed: ``trans``, r < 64, c < 32), or
//   dst[r * GLA_LD + c]   (r < 32, c < 64).
// A thread issues its eight loads before it stores any; consecutive
// threads read consecutive columns.
template <typename T, bool trans>
__device__ __forceinline__ void stage_slab(float* dst, const void* src, long long base, int width,
                                           int row0, int n_rows, int col0, int n_cols,
                                           float scale, const float* w) {
    constexpr int PER = GLA_KD * GLA_T / GLA_THREADS;  // 8
    constexpr int COLS = trans ? GLA_KD : GLA_T;
    float x[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int i = threadIdx.x + u * GLA_THREADS, r = i / COLS, c = i % COLS;
        x[u] = (row0 + r < n_rows && col0 + c < n_cols)
                   ? ld<T>(src, base + (long long)(row0 + r) * width + col0 + c) *
                         (w ? w[row0 + r] : scale)
                   : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int i = threadIdx.x + u * GLA_THREADS, r = i / COLS, c = i % COLS;
        dst[trans ? c * GLA_LD + r : r * GLA_LD + c] = x[u];
    }
}

// acc[i][j] += sum_kk A[kk][ty*4 + i] * B[kk][tx*4 + j] over kk < depth
__device__ __forceinline__ void mma_4x4(float acc[4][4], const float* A, int lda, const float* B,
                                        int ldb, int depth, int ty, int tx) {
#pragma unroll 4
    for (int kk = 0; kk < depth; ++kk) {
        const float4 a = *(const float4*)(A + kk * lda + ty * 4);
        const float4 b = *(const float4*)(B + kk * ldb + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

template <typename T>
__global__ void __launch_bounds__(GLA_THREADS, 1) gla_kernel(const __grid_constant__ GlaParams p) {
    extern __shared__ float4 gla_smem4[];
    const int L = p.chunk, dk = p.dk, dv = p.dv;
    float* Cs = (float*)gla_smem4;   // [dk][TV] state slice
    float* ns = Cs + dk * GLA_TV;    // [dk] normalizer (every CTA of the head keeps a copy)
    float* cum = ns + ((dk + 3) & ~3);  // [L] inclusive cumsum of the log decay
    float* gg = cum + L;             // [L] gain
    float* w = gg + L;               // [L] carry weight exp(total - cum) g
    float* ecum = w + L;             // [L] exp(cum)
    float* qn = ecum + L;            // [64] q . n_prev of the row tile
    float* X1 = qn + GLA_T;          // [64][GLA_LD] staging
    float* X2 = X1 + GLA_T * GLA_LD; // [64][GLA_LD] staging

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int ty = tid >> 4, tx = tid & 15;
    const int n_tv = (dv + GLA_TV - 1) / GLA_TV;  // b*h and the Dv tile share grid x
    const int v0 = (int)(blockIdx.x % n_tv) * GLA_TV;
    const long long bh = blockIdx.x / n_tv;
    const long long qk_base = bh * p.s * dk;
    const long long v_base = bh * p.s * dv;
    const long long g_base = bh * p.s;

    for (int i = tid; i < dk * GLA_TV; i += GLA_THREADS) Cs[i] = 0.0f;
    for (int i = tid; i < dk; i += GLA_THREADS) ns[i] = 0.0f;

    for (int c0 = 0; c0 < p.s; c0 += L) {
        // ---- the chunk's decays -----------------------------------------
        __syncthreads();
        for (int i = tid; i < L; i += GLA_THREADS) {
            cum[i] = load_as<float>(p.ld, p.ld_dt, g_base + c0 + i);
            gg[i] = load_as<float>(p.g, p.g_dt, g_base + c0 + i);
        }
        __syncthreads();
        if (warp == 0) {
            float carry = 0.0f;
            for (int base = 0; base < L; base += 32) {
                float x = base + lane < L ? cum[base + lane] : 0.0f;
                for (int o = 1; o < 32; o <<= 1) {
                    const float y = __shfl_up_sync(0xffffffffu, x, o);
                    if (lane >= o) x += y;
                }
                x += carry;
                if (base + lane < L) cum[base + lane] = x;
                carry = __shfl_sync(0xffffffffu, x, 31);
            }
        }
        __syncthreads();
        const float total = cum[L - 1];
        for (int i = tid; i < L; i += GLA_THREADS) {
            w[i] = expf(total - cum[i]) * gg[i];
            ecum[i] = expf(cum[i]);
        }

        // ---- outputs, one row tile of 64 steps at a time ---------------
        for (int t0 = 0; t0 < L; t0 += GLA_T) {
            float acc[4][4] = {}, nrm[4] = {};
            // intra: column tiles of s up to the diagonal.  The first one
            // also takes the inter part, acc = (scale q) @ C_prev, from the
            // same q slabs, and (threads < 64) q_t . n_prev of row t0 + tid.
            for (int s0 = 0; s0 <= t0; s0 += GLA_T) {
                const bool first = s0 == 0;
                float sc[4][4] = {}, qnt = 0.0f;
                for (int d0 = 0; d0 < dk; d0 += GLA_KD) {
                    __syncthreads();
                    stage_slab<T, true>(X1, p.q, qk_base, dk, c0 + t0, c0 + L, d0, dk, p.scale, nullptr);
                    stage_slab<T, true>(X2, p.k, qk_base, dk, c0 + s0, c0 + L, d0, dk, 1.0f, nullptr);
                    __syncthreads();
                    const int depth = min(GLA_KD, dk - d0);
                    mma_4x4(sc, X1, GLA_LD, X2, GLA_LD, depth, ty, tx);
                    if (first) {
                        mma_4x4(acc, X1, GLA_LD, Cs + d0 * GLA_TV, GLA_TV, depth, ty, tx);
                        if (p.normalize && tid < GLA_T)
                            for (int kk = 0; kk < depth; ++kk) qnt += X1[kk * GLA_LD + tid] * ns[d0 + kk];
                    }
                }
                if (first) {
                    if (p.normalize && tid < GLA_T) qn[tid] = qnt;
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int t = t0 + ty * 4 + i;
                        const float e = t < L ? ecum[t] : 0.0f;
#pragma unroll
                        for (int j = 0; j < 4; ++j) acc[i][j] = e * acc[i][j];
                    }
                }
                // scores: (q . k) exp(cum_t - cum_s) g_s, the mask inside the exp
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int t = t0 + ty * 4 + i;
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int s = s0 + tx * 4 + j;
                        float x = 0.0f;
                        if (t < L && s < L)
                            x = sc[i][j] * expf(t >= s ? cum[t] - cum[s] : -INFINITY) * gg[s];
                        sc[i][j] = x;
                        nrm[i] += x;
                    }
                }
                __syncthreads();  // the slabs are consumed
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) X1[(tx * 4 + j) * GLA_LD + ty * 4 + i] = sc[i][j];
                stage_slab<T, false>(X2, p.v, v_base, dv, c0 + s0, c0 + L, v0, dv, 1.0f, nullptr);
                stage_slab<T, false>(X2 + GLA_KD * GLA_LD, p.v, v_base, dv, c0 + s0 + GLA_KD,
                                     c0 + L, v0, dv, 1.0f, nullptr);
                __syncthreads();
                mma_4x4(acc, X1, GLA_LD, X2, GLA_LD, GLA_T, ty, tx);
            }
            // the row sums live in the 16 threads of a row group (one half warp)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                for (int o = 8; o > 0; o >>= 1) nrm[i] += __shfl_xor_sync(0xffffffffu, nrm[i], o);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int t = t0 + ty * 4 + i;
                if (t >= L) continue;
                float den = 1.0f;
                if (p.normalize) den = fmaxf(fabsf(nrm[i] + ecum[t] * qn[ty * 4 + i]), 1.0f);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = v0 + tx * 4 + j;
                    if (c < dv) store_as(p.o, p.out_dt, v_base + (long long)(c0 + t) * dv + c, acc[i][j] / den);
                }
            }
        }

        // ---- state update ------------------------------------------------
        const float et = expf(total);
        for (int d0 = 0; d0 < dk; d0 += GLA_T) {
            float a2[4][4] = {};
            float nsum = 0.0f;  // thread tid < 64: sum_s k_s w_s of column d0 + tid
            for (int s0 = 0; s0 < L; s0 += GLA_KD) {
                __syncthreads();  // also: every row tile is done reading C and n
                stage_slab<T, false>(X1, p.k, qk_base, dk, c0 + s0, c0 + L, d0, dk, 1.0f, w - c0);
                stage_slab<T, false>(X2, p.v, v_base, dv, c0 + s0, c0 + L, v0, dv, 1.0f, nullptr);
                __syncthreads();
                mma_4x4(a2, X1, GLA_LD, X2, GLA_LD, min(GLA_KD, L - s0), ty, tx);
                if (p.normalize && tid < GLA_T)
                    for (int ss = 0; ss < GLA_KD; ++ss) nsum += X1[ss * GLA_LD + tid];
            }
            if (p.normalize && tid < GLA_T && d0 + tid < dk) ns[d0 + tid] = et * ns[d0 + tid] + nsum;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int d = d0 + ty * 4 + i;
                if (d >= dk) continue;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float* c = Cs + d * GLA_TV + tx * 4 + j;
                    *c = et * *c + a2[i][j];
                }
            }
        }
    }
}

template <typename T>
static int launch_gla(const GlaParams* p, int n_bh, cudaStream_t st) {
    const int bytes = gla_smem_floats(p->dk, p->chunk) * (int)sizeof(float);
    const cudaError_t e =
        cudaFuncSetAttribute(gla_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    const unsigned grid = (unsigned)n_bh * (unsigned)((p->dv + GLA_TV - 1) / GLA_TV);
    gla_kernel<T><<<grid, GLA_THREADS, bytes, st>>>(*p);
    return (int)cudaGetLastError();
}


// ============================================================ wgmma path
// bf16 on the tensor cores, in two launches.  Per chunk c, cum is the
// inclusive cumsum of the log decay, total = cum[L-1], w_s = exp(total -
// cum_s) g_s.
//
// 1. gla_state_kernel: one CTA (one warpgroup) per (b*h, 64 rows of Dk, NV
//    columns of Dv) walks the chunks in order, 64 steps an item.  The
//    carried C tile is the wgmma accumulator itself, float32 in registers.
//    At each chunk's start it writes C_prev(c), the state before the
//    chunk, rounded once to bf16, to a scratch tensor (BH * NC, Dk, Dv)
//    in C's own (Dk, Dv) layout, which the output kernel reads MN-major;
//    then scales the registers by exp(total) and adds (k w)^T v with
//    accumulate on.  k and v are both s-major, so both operands are read
//    MN-major (A transposed, B transposed: both are 64 steps of 128-byte
//    rows).  w multiplies along the reduction axis, so it goes onto the k
//    slab in shared memory first: a generic-proxy pass that rounds k w to
//    bf16 in place, then fence.proxy.async.  The normalizer goes through
//    the same pass in float32 on the CUDA cores (n = exp(total) n + sum_s
//    k_s w_s, from the unrounded products); only the CTAs of the first Dv
//    tile keep it and write n_prev(c) (BH * NC, Dk), float32.
// 2. gla_output_kernel: one CTA (one warpgroup) per (b*h, chunk, 64-row
//    tile of the chunk, NV columns of Dv), all flattened on grid x, the
//    longest row tiles of a chunk first.  The row tile's q stays in shared
//    memory (Dk in 64-wide boxes); C_prev, k and v stream through a
//    3-stage TMA ring in the order the products take them:
//      inter  O = (q C_prev) over Dk (C_prev MN-major), then O *= scale
//             exp(cum_t) row by row;
//      intra  per 64-step tile s up to the diagonal: S = q k^T over Dk
//             (both K-major), P = S scale exp(cum_t - cum_s) g_s with the
//             mask inside the exp (-inf above the diagonal, as the
//             reference has it), row sums of the float32 P, and O += P V
//             with P rounded to bf16 as the register A operand (V
//             MN-major), as the flash kernel does;
//      normalize  den = max(|row sum + scale exp(cum_t) (q . n_prev)|, 1),
//             q . n_prev on the CUDA cores from the resident q tile.
//    The scores are computed once per NV = 128 columns of Dv.
// Numerics against the reference's float32: k w, C_prev and P are each
// rounded to bf16 once, and the output once (mlstm_chunk/kernel.py::
// gla_wgmma_bound is the elementwise bound that follows).  Dk and Dv
// multiples of 16, the chunk a multiple of 64, 16-byte aligned inputs
// (kernel.py::path_of); TMA reads zeros past Dk and Dv.
#define GW_THREADS 128  // one warpgroup; thread 0 also starts the TMA loads
#define GW_STAGES 3     // ring depth
#define GW_BOX 8192     // bytes of one box: 64 rows of 64 bf16 (128 bytes)

struct GlaState {
    void* c;  // (BH * NC, Dk, Dv) bf16: C before each chunk
    void* n;  // (BH * NC, Dk) float32: n before each chunk
};

// Shared memory of the two kernels, in bytes (1024 of slack for the
// swizzle's alignment).  State: the ring of (k box, NV / 64 v boxes), w
// and g of the chunk, the normalizer's partials and the total.  Output:
// the q tile, the ring of NV / 64 boxes, cum and g of the chunk, q . n_prev
// of the rows, n_prev.
__host__ __device__ inline int gw_state_smem(int nv, int chunk) {
    return 1024 + GW_STAGES * (1 + nv / 64) * GW_BOX + 4 * (2 * chunk + 4 * 64 + 4) +
           8 * GW_STAGES;
}
__host__ __device__ inline int gw_out_smem(int nv, int dk, int chunk) {
    return 1024 + ((dk + 63) / 64) * GW_BOX + GW_STAGES * (nv / 64) * GW_BOX +
           4 * (2 * chunk + 64 + dk) + 8 * (GW_STAGES + 1);
}

// d += A B over one k16 step, both operands bf16 and MN-major in shared
// memory (A: 16 rows of 64 M elements; B: 16 rows of N elements, boxes of
// 64 8192 bytes apart).  N = 64 or 128.
template <int N> struct GwMma;
template <> struct GwMma<128> {
    static __device__ __forceinline__ void mma_tt(float* d, uint64_t da, uint64_t db) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
                     ", %64, %65, p, 1, 1, 1, 1;\n}\n"
                     : WG_64("+f") : "l"(da), "l"(db), "r"(1));
    }
};
template <> struct GwMma<64> {
    static __device__ __forceinline__ void mma_tt(float* d, uint64_t da, uint64_t db) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
                     ", %32, %33, p, 1, 1, 1, 1;\n}\n"
                     : WG_32("+f") : "l"(da), "l"(db), "r"(1));
    }
};

// Every thread: the chunk's log decays (as F: float, or double on the
// tf32x3 path) and gains from ``off`` over its first ``n`` steps into
// shared memory, one round trip to memory (warp 0 then scans them there,
// with no load from memory in its serial chain).
template <typename F>
__device__ __forceinline__ void gw_decays(F* cum, float* g, const GlaParams& p, long long off,
                                          int n) {
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += GW_THREADS) {
        cum[i] = (F)load_as<float>(p.ld, p.ld_dt, off + i);
        g[i] = load_as<float>(p.g, p.g_dt, off + i);
    }
}

// Warp 0: cum[i] becomes the inclusive cumsum of cum over the first ``n``
// steps (n a multiple of 32), in F.  Returns cum[n - 1] in every lane.
template <typename F>
__device__ __forceinline__ F gw_scan(F* cum, int n, int lane) {
    F carry = 0;
    for (int base = 0; base < n; base += 32) {
        F x = cum[base + lane];
        for (int o = 1; o < 32; o <<= 1) {
            const F y = __shfl_up_sync(0xffffffffu, x, o);
            if (lane >= o) x += y;
        }
        x += carry;
        cum[base + lane] = x;
        carry = __shfl_sync(0xffffffffu, x, 31);
    }
    return carry;
}

__device__ __forceinline__ unsigned gw_pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *(const unsigned*)&v;
}

template <int NV>
__global__ void __launch_bounds__(GW_THREADS) gla_state_kernel(
        const __grid_constant__ GlaParams p, const __grid_constant__ GlaState st,
        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
    constexpr int VB = NV / 64;                // 64-column boxes of a v tile
    constexpr int STAGE = (1 + VB) * GW_BOX;   // an item: 64 steps of k and of v
    extern __shared__ __align__(16) unsigned char gs_raw[];
    unsigned char* ring = gs_raw + ((1024 - (smem_u32(gs_raw) & 1023)) & 1023);
    const int L = p.chunk, dk = p.dk, dv = p.dv;
    float* wv = (float*)(ring + GW_STAGES * STAGE);  // [L] cum, then w
    float* gv = wv + L;                              // [L] g
    float* red = gv + L;                             // [4 warps][64] normalizer partials
    float* tot = red + 4 * 64;                       // the chunk's total
    uint64_t* full = (uint64_t*)(tot + 4);

    const int nc = p.s / L, per = L / 64, n_items = nc * per;
    const int ndv = (dv + NV - 1) / NV, ndk = (dk + 63) / 64;
    const int dvt = (int)(blockIdx.x % ndv), dkt = (int)((blockIdx.x / ndv) % ndk);
    const long long bh = blockIdx.x / ((unsigned)ndv * ndk);
    const int d0 = dkt * 64, p0 = dvt * NV;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const bool norm = p.normalize && dvt == 0;  // CTA-uniform
    __nv_bfloat16* cst = (__nv_bfloat16*)st.c;
    float* nst = (float*)st.n;

    if (tid == 0) {
        for (int s = 0; s < GW_STAGES; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // item j: steps 64 j .. 64 j + 63 of the sequence, k's Dk tile and v's Dv tile
    auto fetch = [&](int j) {
        const int s = j % GW_STAGES;
        unsigned char* dst = ring + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load3(&tk, dst, &full[s], d0, 64 * j, (int)bh);
        for (int b = 0; b < VB; ++b)
            tma_load3(&tv, dst + (1 + b) * GW_BOX, &full[s], p0 + 64 * b, 64 * j, (int)bh);
    };
    if (tid == 0)
        for (int j = 0; j < GW_STAGES - 1 && j < n_items; ++j) fetch(j);

    float d[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) d[i] = 0.0f;
    float n_run = 0.0f;  // thread tid < 64: n of row d0 + tid
    for (int c = 0; c < nc; ++c) {
        // the chunk's carry weights (every reader of the last chunk's is
        // past the barrier of its last item)
        gw_decays(wv, gv, p, bh * p.s + (long long)c * L, L);
        __syncthreads();
        if (warp == 0) {
            const float total = gw_scan(wv, L, lane);
            for (int i = lane; i < L; i += 32) wv[i] = expf(total - wv[i]) * gv[i];
            if (lane == 0) *tot = total;
        }
        __syncthreads();
        const float et = expf(*tot);
        // C_prev(c), rounded once, and n_prev(c)
        const long long cbase = (bh * nc + c) * dk;
#pragma unroll
        for (int i = 0; i < NV / 2; i += 2) {
            int r, col;
            frag_mn(i, tid, r, col);
            if (d0 + r < dk && p0 + col < dv)
                *(__nv_bfloat162*)(cst + (cbase + d0 + r) * dv + p0 + col) =
                    __floats2bfloat162_rn(d[i], d[i + 1]);
        }
        if (norm && tid < 64 && d0 + tid < dk) nst[cbase + d0 + tid] = n_run;
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) d[i] *= et;  // fault site: bf16 carry decay

        float nacc[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) nacc[e] = 0.0f;
        for (int u = 0; u < per; ++u) {
            const int j = c * per + u, s = j % GW_STAGES;
            unsigned char* kb = ring + s * STAGE;
            mbar_wait(&full[s], (j / GW_STAGES) & 1);
            // k w, rounded to bf16 in place: thread tid takes 16-byte chunk
            // tid & 7 (columns 8 (tid & 7) ..) of rows tid / 8 + 16 q
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = (tid >> 3) + 16 * q, ch = tid & 7;
                uint4* ptr = (uint4*)(kb + r * 128 + ((ch ^ (r & 7)) << 4));
                uint4 raw = *ptr;
                const float wr = wv[u * 64 + r];
                unsigned* w4 = (unsigned*)&raw;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float2 f = __bfloat1622float2(*(const __nv_bfloat162*)&w4[e]);
                    const float lo = f.x * wr, hi = f.y * wr;
                    nacc[2 * e] += lo;
                    nacc[2 * e + 1] += hi;
                    w4[e] = gw_pack(lo, hi);
                }
                *ptr = raw;
            }
            fence_async_smem();
            // every thread's k w is in place, and every thread is done with
            // item j - 1, whose slot item j + GW_STAGES - 1 refills
            __syncthreads();
            if (tid == 0 && j + GW_STAGES - 1 < n_items) fetch(j + GW_STAGES - 1);
            fence_regs<NV / 2>(d);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)  // 16 steps a k16: 16 rows of 128 bytes
                GwMma<NV>::mma_tt(d, sw128_mn_desc(kb + kk * 16 * 128),
                                  sw128_mn_desc(kb + GW_BOX + kk * 16 * 128));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<NV / 2>(d);
        }
        if (norm) {
            // the 16 threads of a column chunk: lanes xor 8, 16, then the warps
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                nacc[e] += __shfl_xor_sync(0xffffffffu, nacc[e], 8);
                nacc[e] += __shfl_xor_sync(0xffffffffu, nacc[e], 16);
            }
            if (lane < 8)
#pragma unroll
                for (int e = 0; e < 8; ++e) red[warp * 64 + lane * 8 + e] = nacc[e];
            __syncthreads();
            if (tid < 64) n_run = et * n_run + red[tid] + red[64 + tid] + red[128 + tid] + red[192 + tid];
        }
    }
}

template <int NV>
__global__ void __launch_bounds__(GW_THREADS) gla_output_kernel(
        const __grid_constant__ GlaParams p, const __grid_constant__ GlaState st,
        const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tc) {
    constexpr int VB = NV / 64, STAGE = VB * GW_BOX;
    extern __shared__ __align__(16) unsigned char go_raw[];
    unsigned char* smem = go_raw + ((1024 - (smem_u32(go_raw) & 1023)) & 1023);
    const int L = p.chunk, dk = p.dk, dv = p.dv;
    const int nc = p.s / L, nr = L / 64, nd = (dk + 63) / 64, ndv = (dv + NV - 1) / NV;
    unsigned char* sq = smem;                          // [nd] boxes of the q tile
    unsigned char* ring = sq + nd * GW_BOX;            // [stage] NV / 64 boxes
    float* cum = (float*)(ring + GW_STAGES * STAGE);   // [L]
    float* gg = cum + L;                               // [L]
    float* qn = gg + L;                                // [64] q . n_prev of each row
    float* nps = qn + 64;                              // [dk] n_prev
    uint64_t* full = (uint64_t*)(nps + dk);
    uint64_t* qbar = full + GW_STAGES;

    unsigned long long bid = blockIdx.x;
    const int dvt = (int)(bid % ndv);
    bid /= ndv;
    const int rt = nr - 1 - (int)(bid % nr);  // the longest row tiles of a chunk first
    bid /= nr;
    const int c = (int)(bid % nc);
    const long long bh = (long long)(bid / nc);
    const int t0 = rt * 64, p0 = dvt * NV, lp = t0 + 64;
    const long long row0 = (long long)c * L;  // the chunk's first step
    const int n_items = nd + (rt + 1) * (nd + 1);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

    if (tid == 0) {
        for (int s = 0; s < GW_STAGES; ++s) mbar_init(&full[s], 1);
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // items: nd slabs of C_prev (64 rows of Dk, NV columns), then per s tile
    // up to the diagonal its nd slabs of k (64 steps, 64 of Dk) and its v tile
    auto fetch = [&](int j) {
        const int s = j % GW_STAGES;
        unsigned char* dst = ring + s * STAGE;
        if (j < nd) {
            mbar_expect_tx(&full[s], STAGE);
            for (int b = 0; b < VB; ++b)
                tma_load3(&tc, dst + b * GW_BOX, &full[s], p0 + 64 * b, 64 * j, (int)(bh * nc + c));
            return;
        }
        const int jj = j - nd, part = jj % (nd + 1);
        const int srow = (int)(row0 + 64 * (jj / (nd + 1)));
        if (part < nd) {
            mbar_expect_tx(&full[s], GW_BOX);
            tma_load3(&tk, dst, &full[s], 64 * part, srow, (int)bh);
        } else {
            mbar_expect_tx(&full[s], STAGE);
            for (int b = 0; b < VB; ++b)
                tma_load3(&tv, dst + b * GW_BOX, &full[s], p0 + 64 * b, srow, (int)bh);
        }
    };
    if (tid == 0) {
        mbar_expect_tx(qbar, nd * GW_BOX);
        for (int j = 0; j < nd; ++j)
            tma_load3(&tq, sq + j * GW_BOX, qbar, 64 * j, (int)(row0 + t0), (int)bh);
        for (int j = 0; j < GW_STAGES - 1 && j < n_items; ++j) fetch(j);
    }
    // the chunk's decays up to this tile's last row
    gw_decays(cum, gg, p, bh * p.s + row0, lp);
    if (p.normalize) {
        const float* np = (const float*)st.n + (bh * nc + c) * dk;
        for (int i = tid; i < dk; i += GW_THREADS) nps[i] = np[i];
    }
    __syncthreads();
    if (warp == 0) gw_scan(cum, lp, lane);  // the first item's barrier publishes it
    mbar_wait(qbar, 0);
    if (p.normalize) {
        // q . n_prev: two threads a row, 32 columns of each box apiece
        const int r = tid >> 1, h = tid & 1;
        float acc = 0.0f;
        for (int j = 0; j < nd; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int ch = 4 * h + q, dd = 64 * j + 8 * ch;
                const uint4 raw = *(const uint4*)(sq + j * GW_BOX + r * 128 + ((ch ^ (r & 7)) << 4));
                const unsigned* w4 = (const unsigned*)&raw;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float2 f = __bfloat1622float2(*(const __nv_bfloat162*)&w4[e]);
                    if (dd + 2 * e < dk) acc += f.x * nps[dd + 2 * e];
                    if (dd + 2 * e + 1 < dk) acc += f.y * nps[dd + 2 * e + 1];
                }
            }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (h == 0) qn[r] = acc;
    }

    int j = 0;
    // wait for item j; the barrier also frees item j - 1's slot for the refill
    auto take = [&]() -> const unsigned char* {
        const int s = j % GW_STAGES;
        mbar_wait(&full[s], (j / GW_STAGES) & 1);
        __syncthreads();
        if (tid == 0 && j + GW_STAGES - 1 < n_items) fetch(j + GW_STAGES - 1);
        ++j;
        return ring + s * STAGE;
    };

    // inter: O = q C_prev over Dk, then scale exp(cum_t) by row
    float o[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] = 0.0f;
    for (int b = 0; b < nd; ++b) {
        const unsigned char* cb = take();
        fence_regs<NV / 2>(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            Wgmma<__nv_bfloat16, NV>::template mma<1>(o, sw128_desc(sq + b * GW_BOX + kk * 32),
                                                       sw128_mn_desc(cb + kk * 16 * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NV / 2>(o);
    }
    const int rq = (tid >> 5) * 16 + ((tid & 31) >> 2);  // rows rq and rq + 8 of the tile
    const float ec[2] = {expf(cum[t0 + rq]), expf(cum[t0 + rq + 8])};
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] *= p.scale * ec[(i >> 1) & 1];

    // intra: the s tiles up to the diagonal
    float rs[2] = {0.0f, 0.0f};
    for (int stl = 0; stl <= rt; ++stl) {
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
        for (int b = 0; b < nd; ++b) {
            const unsigned char* kb = take();
            fence_regs<32>(sc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                Wgmma<__nv_bfloat16, 64>::template mma<0>(sc, sw128_desc(sq + b * GW_BOX + kk * 32),
                                                           sw128_desc(kb + kk * 32));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<32>(sc);
        }
        // P = S scale exp(cum_t - cum_s) g_s, the mask inside the exp
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1, t = t0 + rq + 8 * r;
            const int s = 64 * stl + (i >> 2) * 8 + (tid & 3) * 2 + (i & 1);
            const float x = sc[i] * p.scale * expf(t >= s ? cum[t] - cum[s] : -INFINITY) * gg[s];
            sc[i] = x;
            rs[r] += x;
        }
        unsigned a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int u = 0; u < 4; ++u) a[kk][u] = gw_pack(sc[kk * 8 + 2 * u], sc[kk * 8 + 2 * u + 1]);
        const unsigned char* vb = take();
        fence_regs<NV / 2>(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            Wgmma<__nv_bfloat16, NV>::template mma_rs<1>(o, a[kk], sw128_mn_desc(vb + kk * 16 * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NV / 2>(o);
    }

    // the row sums live in the quad of a row
    float den[2] = {1.0f, 1.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        if (p.normalize) den[r] = fmaxf(fabsf(rs[r] + p.scale * ec[r] * qn[rq + 8 * r]), 1.0f);
    }
    __nv_bfloat16* out = (__nv_bfloat16*)p.o;
    const long long obase = bh * p.s + row0 + t0;
#pragma unroll
    for (int i = 0; i < NV / 2; i += 2) {
        int row, col;
        frag_mn(i, tid, row, col);
        const int r = (i >> 1) & 1;
        if (p0 + col < dv)
            *(__nv_bfloat162*)(out + (obase + row) * dv + p0 + col) =
                __floats2bfloat162_rn(o[i] / den[r], o[i + 1] / den[r]);
    }
}

// The TMA map of a (heads, rows, width) bf16 tensor: boxes of 64 x 64,
// zeros past ``width``.
static int gw_map(CUtensorMap* map, const void* ptr, int width, int rows, long long heads) {
    const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)heads};
    const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)width * 2 * rows};
    const cuuint32_t box[3] = {64, 64, 1};
    return tensor_map3(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims, strides, box);
}

template <int NV>
static int launch_gw(const GlaParams* p, const GlaState* sc, int n_bh, cudaStream_t st) {
    const int nc = p->s / p->chunk;
    alignas(64) CUtensorMap tq, tk, tv, tc;
    int rc = gw_map(&tq, p->q, p->dk, p->s, n_bh);
    if (!rc) rc = gw_map(&tk, p->k, p->dk, p->s, n_bh);
    if (!rc) rc = gw_map(&tv, p->v, p->dv, p->s, n_bh);
    if (!rc) rc = gw_map(&tc, sc->c, p->dv, p->dk, (long long)n_bh * nc);
    if (rc) return rc;
    const int s_bytes = gw_state_smem(NV, p->chunk), o_bytes = gw_out_smem(NV, p->dk, p->chunk);
    cudaError_t e = cudaFuncSetAttribute(gla_state_kernel<NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s_bytes);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(gla_output_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 o_bytes);
    if (e != cudaSuccess) return (int)e;
    const unsigned ndv = (unsigned)((p->dv + NV - 1) / NV), ndk = (unsigned)((p->dk + 63) / 64);
    gla_state_kernel<NV><<<(unsigned)n_bh * ndk * ndv, GW_THREADS, s_bytes, st>>>(*p, *sc, tk, tv);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gla_output_kernel<NV><<<(unsigned)n_bh * (unsigned)(p->s / 64) * ndv, GW_THREADS, o_bytes, st>>>(
        *p, *sc, tq, tk, tv, tc);
    return (int)cudaGetLastError();
}

// ============================================================ tf32x3 path
// float32 on the tensor cores, in the wgmma path's decomposition (a state
// kernel, then a chunk-parallel output kernel), every product in 3xTF32
// (hopper.cuh: a b = a_hi b_hi + a_hi b_lo + a_lo b_hi, accumulated in
// float32 by the tensor cores).  wgmma reads 32-bit operands K-major only,
// so each product takes its A operand from registers, where the threads
// gather and split it, and its B operand K-major from shared memory:
//   q C_prev   A = q from the resident q tile; B = C_prev^T, which the
//              state kernel writes transposed, (BH * NC, Dv, Dk), already
//              split into hi and lo (float32 both, so C_prev is exact).
//   q k^T      A = q; B = the k box as TMA brings it (64 steps of 32 of
//              Dk); a generic-proxy pass clears the low bits of the box in
//              place and writes lo beside it, then fence.proxy.async.
//   P V and (k w)^T v   reduce over the steps s, so v has to be K-major in
//              s: gla_vt_kernel writes v^T, (BH, Dv, S), split into hi and
//              lo, once per call, with the steps of every group of 8 in
//              the order 0 2 4 6 1 3 5 7.  That order makes the score
//              accumulator's own registers the A operand of P V: a thread
//              holds columns 2t and 2t + 1 of each 8, and the A operand
//              wants columns t and t + 4.  The state kernel gathers (k w)^T
//              from the k box in the same order.
// Per chunk c, cum is the inclusive cumsum of the log decay, total =
// cum[L-1], w_s = exp(total - cum_s) g_s.  Warp 0 takes cum in float64:
// at |cum| in the thousands (an SSD head of A = -16) a float32 cum is off
// by 2^-12 and more, so exp(cum_t - cum_s) of neighbouring steps would move
// by 1e-4, far past what the split costs, in another direction than the
// plain version's own float32 cumsum; the differences go to float32 before
// the exp, the per-row and per-chunk exps are taken in float64.
// 1. gla_state_tf32_kernel: one CTA (one warpgroup) per (b*h, 64 rows of
//    Dk, NV columns of Dv) walks the chunks, 32 steps an item (two k boxes
//    of 32 x 32 and the v^T boxes hi, lo of 32 x NV).  The carried C tile
//    is the accumulator, float32; before each chunk it writes C_prev(c)^T
//    hi and lo and n_prev(c) (the CTAs of the first Dv tile), then C =
//    exp(total) C + (k w)^T v.  n = exp(total) n + sum_s k_s w_s in
//    float32 on the CUDA cores, from the products the gather makes.
// 2. gla_output_tf32_kernel: one CTA per (b*h, chunk, 64-row tile, NV
//    columns of Dv), the longest row tiles first, the q tile resident in
//    shared memory (Dk in boxes of 32), items through a 3-stage ring:
//    C_prev^T (hi, lo) per 32 of Dk; then per s tile up to the diagonal
//    its k boxes and its two v^T items of 32 steps.  O = q C_prev scale
//    exp(cum_t); S = q k^T; P = S scale exp(cum_t - cum_s) g_s, the mask
//    inside the exp; O += P V; den = max(|row sum of P + scale exp(cum_t)
//    q . n_prev|, 1) as the wgmma path has it.
// Numerics against the reference's float32: each product term moves by at
// most 3 2^-20 of |a| |b| (mlstm_chunk/kernel.py::gla_tf32x3_bound).  Dk
// and Dv multiples of 8 (k8, and TMA's 16-byte strides), the chunk a
// multiple of 64, 16-byte aligned inputs (kernel.py::path_of); TMA reads
// zeros past Dk and Dv.  Shared memory: the state kernel 85 KiB at NV 128
// (two stages; two CTAs an SM), the output kernel the 8 KiB q boxes plus
// three stages of 2 NV 128 bytes: 198 KiB at Dk 384 (one CTA an SM), 69
// KiB at Dk 64 (three).
#define GT_STAGES 3  // the output kernel's ring
#define GT_KBOX 8192 // 64 rows of 32 float32

struct GlaState3 {
    void* c_hi;   // (BH * NC, Dv, Dk) float32: C^T before each chunk, hi
    void* c_lo;   //   ... and lo
    void* n;      // (BH * NC, Dk) float32: n before each chunk
    void* vt_hi;  // (BH, Dv, S) float32: v^T, steps permuted within 8, hi
    void* vt_lo;  //   ... and lo
};

__host__ __device__ inline int gt_state_stages(int nv) { return nv == 64 ? 3 : 2; }
// Shared memory of the two kernels, in bytes (1024 of slack for the
// swizzle's alignment).  State: the ring of (two k boxes of 32 x 32, v^T
// hi and lo of 32 x NV), cum (float64), w and g of the chunk, the total
// (float64), the barriers.  Output: the q boxes, the ring of (a box of 32
// x NV or 32 x 64 and its lo), cum (float64) and g of the chunk, q .
// n_prev of the rows, n_prev, the barriers.
__host__ __device__ inline int gt_state_smem(int nv, int chunk) {
    return 1024 + gt_state_stages(nv) * (GT_KBOX + 256 * nv) + 16 * chunk + 8 +
           8 * gt_state_stages(nv);
}
__host__ __device__ inline int gt_out_smem(int nv, int dk, int chunk) {
    return 1024 + ((dk + 31) / 32) * GT_KBOX + GT_STAGES * 256 * nv + 12 * chunk +
           4 * (64 + dk) + 8 * (GT_STAGES + 1);
}

// d += A B over one k8 step in 3xTF32: A (hi, lo) in registers, B (hi, lo)
// K-major in shared memory.
template <int N>
__device__ __forceinline__ void mma3(float* d, const unsigned* ahi, const unsigned* alo,
                                     uint64_t bhi, uint64_t blo) {
    Wgmma<float, N>::template mma_rs<0>(d, ahi, bhi);
    Wgmma<float, N>::template mma_rs<0>(d, ahi, blo);  // fault site: tf32x3 lo product
    Wgmma<float, N>::template mma_rs<0>(d, alo, bhi);  // fault site: tf32x3 lo product
}

// v (BH, S, Dv) -> v^T (BH, Dv, S) hi and lo, the steps of each group of 8
// in the order 0 2 4 6 1 3 5 7.  One CTA per (b*h, 32 steps), Dv in tiles
// of 32 through shared memory.
__global__ void __launch_bounds__(256) gla_vt_kernel(const float* v, float* vt_hi, float* vt_lo,
                                                     int s, int dv) {
    __shared__ float tile[32][33];
    const int n_st = s / 32;
    const long long off = (long long)(blockIdx.x / n_st) * s * dv;
    transpose_split32(v + off, vt_hi + off, vt_lo + off, s, dv, s, (int)(blockIdx.x % n_st) * 32,
                      tile);
}

template <int NV>
__global__ void __launch_bounds__(GW_THREADS) gla_state_tf32_kernel(
        const __grid_constant__ GlaParams p, const __grid_constant__ GlaState3 st,
        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tvh,
        const __grid_constant__ CUtensorMap tvl) {
    constexpr int STAGES = NV == 64 ? 3 : 2, VBOX = NV * 128;
    constexpr int STAGE = GT_KBOX + 2 * VBOX;  // an item: 32 steps of k (two boxes) and v^T hi, lo
    extern __shared__ __align__(16) unsigned char ts_raw[];
    unsigned char* ring = ts_raw + ((1024 - (smem_u32(ts_raw) & 1023)) & 1023);
    const int L = p.chunk, dk = p.dk, dv = p.dv;
    double* cum = (double*)(ring + STAGES * STAGE);  // [L]
    float* wv = (float*)(cum + L);                   // [L] w
    float* gv = wv + L;                              // [L] g
    double* tot = (double*)(gv + L);                 // the chunk's total
    uint64_t* full = (uint64_t*)(tot + 1);

    const int nc = p.s / L, per = L / 32, n_items = nc * per;
    const int ndv = (dv + NV - 1) / NV, ndk = (dk + 63) / 64;
    const int dvt = (int)(blockIdx.x % ndv), dkt = (int)((blockIdx.x / ndv) % ndk);
    const long long bh = blockIdx.x / ((unsigned)ndv * ndk);
    const int d0 = dkt * 64, p0 = dvt * NV;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const bool norm = p.normalize && dvt == 0;  // CTA-uniform
    float* chi = (float*)st.c_hi;
    float* clo = (float*)st.c_lo;
    float* nst = (float*)st.n;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // item j: steps 32 j .. 32 j + 31 of the sequence, k's 64 rows of Dk
    // in two boxes, v^T's Dv tile hi and lo
    auto fetch = [&](int j) {
        const int s = j % STAGES;
        unsigned char* dst = ring + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load3(&tk, dst, &full[s], d0, 32 * j, (int)bh);
        tma_load3(&tk, dst + GT_KBOX / 2, &full[s], d0 + 32, 32 * j, (int)bh);
        tma_load3(&tvh, dst + GT_KBOX, &full[s], 32 * j, p0, (int)bh);
        tma_load3(&tvl, dst + GT_KBOX + VBOX, &full[s], 32 * j, p0, (int)bh);
    };
    if (tid == 0)
        for (int j = 0; j < STAGES - 1 && j < n_items; ++j) fetch(j);

    float d[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) d[i] = 0.0f;
    float n_run[2] = {0.0f, 0.0f};  // n of rows d0 + 16 warp + g (+ 8), in every lane of the quad
    for (int c = 0; c < nc; ++c) {
        // the chunk's carry weights (every reader of the last chunk's is
        // past the barrier of its last item)
        gw_decays(cum, gv, p, bh * p.s + (long long)c * L, L);
        __syncthreads();
        if (warp == 0) {
            const double total = gw_scan(cum, L, lane);
            for (int i = lane; i < L; i += 32) wv[i] = expf((float)(total - cum[i])) * gv[i];
            if (lane == 0) *tot = total;
        }
        __syncthreads();
        const float et = (float)exp(*tot);
        // C_prev(c)^T, split, and n_prev(c)
        const long long cb = bh * nc + c;
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) {
            int r, col;
            frag_mn(i, tid, r, col);
            if (d0 + r < dk && p0 + col < dv) {
                const long long off = (cb * dv + p0 + col) * dk + d0 + r;
                const float hi = tf32_hi(d[i]);
                chi[off] = hi;
                clo[off] = d[i] - hi;
            }
        }
        if (norm && t == 0)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                const int row = d0 + 16 * warp + g + 8 * rr;
                if (row < dk) nst[cb * dk + row] = n_run[rr];
            }
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) d[i] *= et;

        float nacc[2] = {0.0f, 0.0f};
        for (int u = 0; u < per; ++u) {
            const int j = c * per + u, s = j % STAGES;
            const unsigned char* kb = ring + s * STAGE;
            mbar_wait(&full[s], (j / STAGES) & 1);
            // A = (k w)^T: rows 16 warp + g (+ 8) of the 64 of Dk, k8 step kk
            // at steps 8 kk + 2 t and 8 kk + 2 t + 1 (v^T's order)
            unsigned ahi[4][4], alo[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int m = 16 * warp + g + 8 * (e & 1), step = 8 * kk + 2 * t + (e >> 1);
                    const float x = sw_at(kb + (m >> 5) * (GT_KBOX / 2), step, m & 31) *
                                    wv[u * 32 + step];
                    nacc[e & 1] += x;
                    split(x, ahi[kk][e], alo[kk][e]);
                }
            // every thread has gathered item j and is done with item j - 1,
            // whose slot item j + STAGES - 1 refills
            __syncthreads();
            if (tid == 0 && j + STAGES - 1 < n_items) fetch(j + STAGES - 1);
            const unsigned char* vh = kb + GT_KBOX;
            fence_regs<NV / 2>(d);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                mma3<NV>(d, ahi[kk], alo[kk], sw128_desc(vh + kk * 32),
                         sw128_desc(vh + VBOX + kk * 32));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<NV / 2>(d);
        }
        if (norm)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                nacc[rr] += __shfl_xor_sync(0xffffffffu, nacc[rr], 1);
                nacc[rr] += __shfl_xor_sync(0xffffffffu, nacc[rr], 2);
                n_run[rr] = et * n_run[rr] + nacc[rr];
            }
    }
}

// A fragment of q for k8 step ``kk`` of a q box (64 rows of 32 of Dk),
// split: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the warp's rows.
__device__ __forceinline__ void q_frag(const unsigned char* box, int kk, int warp, int g, int t,
                                       unsigned* hi, unsigned* lo) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
        split(sw_at(box, 16 * warp + g + 8 * (e & 1), 8 * kk + t + 4 * (e >> 1)), hi[e], lo[e]);
}

template <int NV>
__global__ void __launch_bounds__(GW_THREADS) gla_output_tf32_kernel(
        const __grid_constant__ GlaParams p, const __grid_constant__ GlaState3 st,
        const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tvh, const __grid_constant__ CUtensorMap tvl,
        const __grid_constant__ CUtensorMap tch, const __grid_constant__ CUtensorMap tcl) {
    constexpr int HALF = NV * 128, STAGE = 2 * HALF;  // an item: a box and its lo
    extern __shared__ __align__(16) unsigned char gt_raw[];
    unsigned char* smem = gt_raw + ((1024 - (smem_u32(gt_raw) & 1023)) & 1023);
    const int L = p.chunk, dk = p.dk, dv = p.dv;
    const int nc = p.s / L, nr = L / 64, nd = (dk + 31) / 32, ndv = (dv + NV - 1) / NV;
    unsigned char* sq = smem;                          // [nd] boxes of the q tile
    unsigned char* ring = sq + nd * GT_KBOX;           // [stage] a box, its lo
    double* cum = (double*)(ring + GT_STAGES * STAGE); // [L]
    float* gg = (float*)(cum + L);                     // [L]
    float* qn = gg + L;                                // [64] q . n_prev of each row
    float* nps = qn + 64;                              // [dk] n_prev
    uint64_t* full = (uint64_t*)(nps + dk);
    uint64_t* qbar = full + GT_STAGES;

    unsigned long long bid = blockIdx.x;
    const int dvt = (int)(bid % ndv);
    bid /= ndv;
    const int rt = nr - 1 - (int)(bid % nr);  // the longest row tiles of a chunk first
    bid /= nr;
    const int c = (int)(bid % nc);
    const long long bh = (long long)(bid / nc);
    const int t0 = rt * 64, p0 = dvt * NV, lp = t0 + 64;
    const long long row0 = (long long)c * L;  // the chunk's first step
    const int n_items = nd + (rt + 1) * (nd + 2);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

    if (tid == 0) {
        for (int s = 0; s < GT_STAGES; ++s) mbar_init(&full[s], 1);
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // items: nd boxes of C_prev^T (NV rows of Dv, 32 of Dk; hi, lo), then
    // per s tile up to the diagonal its nd k boxes (64 steps, 32 of Dk) and
    // two v^T items (NV rows of Dv, 32 steps; hi, lo)
    auto fetch = [&](int j) {
        const int s = j % GT_STAGES;
        unsigned char* dst = ring + s * STAGE;
        if (j < nd) {
            mbar_expect_tx(&full[s], STAGE);
            tma_load3(&tch, dst, &full[s], 32 * j, p0, (int)(bh * nc + c));
            tma_load3(&tcl, dst + HALF, &full[s], 32 * j, p0, (int)(bh * nc + c));
            return;
        }
        const int jj = j - nd, part = jj % (nd + 2);
        const int srow = (int)(row0 + 64 * (jj / (nd + 2)));
        if (part < nd) {
            mbar_expect_tx(&full[s], GT_KBOX);
            tma_load3(&tk, dst, &full[s], 32 * part, srow, (int)bh);
        } else {
            const int s0 = srow + 32 * (part - nd);
            mbar_expect_tx(&full[s], STAGE);
            tma_load3(&tvh, dst, &full[s], s0, p0, (int)bh);
            tma_load3(&tvl, dst + HALF, &full[s], s0, p0, (int)bh);
        }
    };
    if (tid == 0) {
        mbar_expect_tx(qbar, nd * GT_KBOX);
        for (int j = 0; j < nd; ++j)
            tma_load3(&tq, sq + j * GT_KBOX, qbar, 32 * j, (int)(row0 + t0), (int)bh);
        for (int j = 0; j < GT_STAGES - 1 && j < n_items; ++j) fetch(j);
    }
    // the chunk's decays up to this tile's last row
    gw_decays(cum, gg, p, bh * p.s + row0, lp);
    if (p.normalize) {
        const float* np = (const float*)st.n + (bh * nc + c) * dk;
        for (int i = tid; i < dk; i += GW_THREADS) nps[i] = np[i];
    }
    __syncthreads();
    if (warp == 0) gw_scan(cum, lp, lane);  // the first item's barrier publishes it
    mbar_wait(qbar, 0);
    if (p.normalize) {
        // q . n_prev: two threads a row, 16 columns of each box apiece
        const int r = tid >> 1, h = tid & 1;
        float acc = 0.0f;
        for (int b = 0; b < nd; ++b)
#pragma unroll
            for (int e = 0; e < 16; ++e) {
                const int col = 16 * h + e;
                if (32 * b + col < dk) acc += sw_at(sq + b * GT_KBOX, r, col) * nps[32 * b + col];
            }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (h == 0) qn[r] = acc;
    }

    int j = 0;
    // wait for item j (a k box: split it in place, lo beside it); the
    // barrier also frees item j - 1's slot for the refill
    auto take = [&](bool split_box) -> const unsigned char* {
        const int s = j % GT_STAGES;
        unsigned char* it = ring + s * STAGE;
        mbar_wait(&full[s], (j / GT_STAGES) & 1);
        if (split_box) {
#pragma unroll
            for (int q = 0; q < GT_KBOX / 16 / GW_THREADS; ++q) {
                float4* x = (float4*)it + tid + q * GW_THREADS;
                const float4 v = *x;
                const float4 h = make_float4(tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z), tf32_hi(v.w));
                *x = h;
                *(float4*)(it + GT_KBOX + 16 * (tid + q * GW_THREADS)) =
                    make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
            }
            fence_async_smem();
        }
        __syncthreads();
        if (tid == 0 && j + GT_STAGES - 1 < n_items) fetch(j + GT_STAGES - 1);
        ++j;
        return it;
    };

    // inter: O = q C_prev over Dk, then scale exp(cum_t) by row
    float o[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] = 0.0f;
    unsigned ahi[4][4], alo[4][4];
    for (int b = 0; b < nd; ++b) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) q_frag(sq + b * GT_KBOX, kk, warp, g, t, ahi[kk], alo[kk]);
        const unsigned char* cbx = take(false);
        fence_regs<NV / 2>(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            mma3<NV>(o, ahi[kk], alo[kk], sw128_desc(cbx + kk * 32), sw128_desc(cbx + HALF + kk * 32));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NV / 2>(o);
    }
    const int rq = warp * 16 + g;  // rows rq and rq + 8 of the tile
    const float ec[2] = {(float)exp(cum[t0 + rq]), (float)exp(cum[t0 + rq + 8])};
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] *= p.scale * ec[(i >> 1) & 1];

    // intra: the s tiles up to the diagonal
    float rs[2] = {0.0f, 0.0f};
    for (int stl = 0; stl <= rt; ++stl) {
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
        for (int b = 0; b < nd; ++b) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) q_frag(sq + b * GT_KBOX, kk, warp, g, t, ahi[kk], alo[kk]);
            const unsigned char* kb = take(true);
            fence_regs<32>(sc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                mma3<64>(sc, ahi[kk], alo[kk], sw128_desc(kb + kk * 32),
                         sw128_desc(kb + GT_KBOX + kk * 32));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<32>(sc);
        }
        // P = S scale exp(cum_t - cum_s) g_s, the mask inside the exp
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1, tt = t0 + rq + 8 * r;
            const int s = 64 * stl + (i >> 2) * 8 + t * 2 + (i & 1);
            const float x =
                sc[i] * p.scale * expf(tt >= s ? (float)(cum[tt] - cum[s]) : -INFINITY) * gg[s];
            sc[i] = x;
            rs[r] += x;
        }
        // O += P V, 32 steps an item: P's k8 step kk is its registers 4 kk
        // (row g, step 2t), 4 kk + 2 (g + 8, 2t), 4 kk + 1 (g, 2t + 1),
        // 4 kk + 3 (g + 8, 2t + 1), which v^T's order of steps matches
        for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const int i = 4 * (4 * u + kk);
                split(sc[i], ahi[kk][0], alo[kk][0]);
                split(sc[i + 2], ahi[kk][1], alo[kk][1]);
                split(sc[i + 1], ahi[kk][2], alo[kk][2]);
                split(sc[i + 3], ahi[kk][3], alo[kk][3]);
            }
            const unsigned char* vb = take(false);
            fence_regs<NV / 2>(o);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                mma3<NV>(o, ahi[kk], alo[kk], sw128_desc(vb + kk * 32), sw128_desc(vb + HALF + kk * 32));
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<NV / 2>(o);
        }
    }

    // the row sums live in the quad of a row
    float den[2] = {1.0f, 1.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        if (p.normalize) den[r] = fmaxf(fabsf(rs[r] + p.scale * ec[r] * qn[rq + 8 * r]), 1.0f);
    }
    float* out = (float*)p.o;
    const long long obase = bh * p.s + row0 + t0;
#pragma unroll
    for (int i = 0; i < NV / 2; i += 2) {
        int row, col;
        frag_mn(i, tid, row, col);
        const int r = (i >> 1) & 1;
        if (p0 + col < dv)
            *(float2*)(out + (obase + row) * dv + p0 + col) = make_float2(o[i] / den[r], o[i + 1] / den[r]);
    }
}

template <int NV>
static int launch_gt(const GlaParams* p, const GlaState3* sc, int n_bh, cudaStream_t st) {
    const int nc = p->s / p->chunk;
    alignas(64) CUtensorMap tq, tk, tk32, tvh, tvl, tch, tcl;
    int rc = f32_map(&tq, p->q, p->dk, p->s, n_bh, 64);
    if (!rc) rc = f32_map(&tk, p->k, p->dk, p->s, n_bh, 64);
    if (!rc) rc = f32_map(&tk32, p->k, p->dk, p->s, n_bh, 32);
    if (!rc) rc = f32_map(&tvh, sc->vt_hi, p->s, p->dv, n_bh, NV);
    if (!rc) rc = f32_map(&tvl, sc->vt_lo, p->s, p->dv, n_bh, NV);
    if (!rc) rc = f32_map(&tch, sc->c_hi, p->dk, p->dv, (long long)n_bh * nc, NV);
    if (!rc) rc = f32_map(&tcl, sc->c_lo, p->dk, p->dv, (long long)n_bh * nc, NV);
    if (rc) return rc;
    const int s_bytes = gt_state_smem(NV, p->chunk), o_bytes = gt_out_smem(NV, p->dk, p->chunk);
    cudaError_t e = cudaFuncSetAttribute(gla_state_tf32_kernel<NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s_bytes);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(gla_output_tf32_kernel<NV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, o_bytes);
    if (e != cudaSuccess) return (int)e;
    gla_vt_kernel<<<(unsigned)n_bh * (unsigned)(p->s / 32), 256, 0, st>>>(
        (const float*)p->v, (float*)sc->vt_hi, (float*)sc->vt_lo, p->s, p->dv);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const unsigned ndv = (unsigned)((p->dv + NV - 1) / NV), ndk = (unsigned)((p->dk + 63) / 64);
    gla_state_tf32_kernel<NV><<<(unsigned)n_bh * ndk * ndv, GW_THREADS, s_bytes, st>>>(
        *p, *sc, tk32, tvh, tvl);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gla_output_tf32_kernel<NV><<<(unsigned)n_bh * (unsigned)(p->s / 64) * ndv, GW_THREADS, o_bytes,
                                 st>>>(*p, *sc, tq, tk, tvh, tvl, tch, tcl);
    return (int)cudaGetLastError();
}

extern "C" {

// Launches one chunked GLA on the CUDA cores over ``n_bh`` = B * H rows of
// heads on ``stream`` (grid x: n_bh * ceil(Dv / 64)), q, k and v of type
// p->qkv_dt.  Returns cudaGetLastError(), or -1 for a type not built.
int stripe_gla_launch(const GlaParams* p, int n_bh, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    switch (p->qkv_dt) {
        case DT_F32: return launch_gla<float>(p, n_bh, st);
        case DT_BF16: return launch_gla<__nv_bfloat16>(p, n_bh, st);
        default: return -1;
    }
}

// Launches the wgmma path (bf16; Dk, Dv multiples of 16, the chunk a
// multiple of 64): the state kernel, then the output kernel, on
// ``stream``.  ``c`` and ``n`` are the scratch tensors of C_prev (BH * NC,
// Dk, Dv) bf16 and n_prev (BH * NC, Dk) float32.  Returns
// cudaGetLastError(), an error code of hopper.cuh, or -1 for inputs the
// path does not take.
int stripe_gla_wgmma(const GlaParams* p, void* c, void* n, int n_bh, void* stream) {
    if (p->qkv_dt != DT_BF16 || p->out_dt != DT_BF16 || p->dk % 16 || p->dv % 16 ||
        p->chunk % 64 || p->s % p->chunk)
        return -1;
    const GlaState sc = {c, n};
    const cudaStream_t st = (cudaStream_t)stream;
    return p->dv <= 64 ? launch_gw<64>(p, &sc, n_bh, st) : launch_gw<128>(p, &sc, n_bh, st);
}

// Launches the tf32x3 path (float32; Dk, Dv multiples of 8, the chunk a
// multiple of 64): v's transposed split copy, the state kernel, then the
// output kernel, on ``stream``.  ``st`` holds the scratch tensors: C_prev^T
// hi and lo (BH * NC, Dv, Dk), n_prev (BH * NC, Dk) and v^T hi and lo
// (BH, Dv, S), all float32.  Returns cudaGetLastError(), an error code of
// hopper.cuh, or -1 for inputs the path does not take.
int stripe_gla_tf32x3(const GlaParams* p, const GlaState3* st, int n_bh, void* stream) {
    if (p->qkv_dt != DT_F32 || p->out_dt != DT_F32 || p->dk % 8 || p->dv % 8 ||
        p->chunk % 64 || p->s % p->chunk)
        return -1;
    const cudaStream_t cs = (cudaStream_t)stream;
    return p->dv <= 64 ? launch_gt<64>(p, st, n_bh, cs) : launch_gt<128>(p, st, n_bh, cs);
}

// Shared memory of one CTA for (dk, chunk), in bytes.
int stripe_gla_smem(int dk, int chunk) { return gla_smem_floats(dk, chunk) * (int)sizeof(float); }

// Shared memory of the wgmma path's state and output kernels for (dk, dv,
// chunk), in bytes.
void stripe_gla_wgmma_smem(int dk, int dv, int chunk, long long* out) {
    const int nv = dv <= 64 ? 64 : 128;
    out[0] = gw_state_smem(nv, chunk);
    out[1] = gw_out_smem(nv, dk, chunk);
}

// Shared memory of the tf32x3 path's state and output kernels for (dk,
// dv, chunk), in bytes.
void stripe_gla_tf32x3_smem(int dk, int dv, int chunk, long long* out) {
    const int nv = dv <= 64 ? 64 : 128;
    out[0] = gt_state_smem(nv, chunk);
    out[1] = gt_out_smem(nv, dk, chunk);
}

// Layout of GlaParams as this compiler laid it out, for the binding's check.
void stripe_gla_layout(long long* out) {
    out[0] = (long long)sizeof(GlaParams);
    out[1] = (long long)offsetof(GlaParams, s);
    out[2] = (long long)offsetof(GlaParams, qkv_dt);
    out[3] = (long long)offsetof(GlaParams, normalize);
    out[4] = (long long)offsetof(GlaParams, scale);
}

}  // extern "C"
