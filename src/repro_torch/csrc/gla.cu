// Chunkwise gated linear attention (mLSTM, Mamba2's SSD) as one CUDA kernel.
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
// VMEM scratch.  Here one CTA owns one (b*h, tile of TV = 64 columns of
// Dv) and loops over the chunks itself, carrying its Dk x 64 float32
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
// (L (2 Dk + Dv) + L Dv) elements moved; far above the ridge.  They run on
// the CUDA cores in float32 here; tensor-core tiles (mma / wgmma on bf16
// operands) and the redundant score work are for a later PR.

#include "dag.cuh"

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
    const int v0 = blockIdx.x * GLA_TV;
    const long long bh = blockIdx.y;
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
    const dim3 grid((p->dv + GLA_TV - 1) / GLA_TV, n_bh);
    gla_kernel<T><<<grid, GLA_THREADS, bytes, st>>>(*p);
    return (int)cudaGetLastError();
}

extern "C" {

// Launches one chunked GLA over ``n_bh`` = B * H rows of heads on
// ``stream`` (grid: ceil(Dv / 64) x n_bh), q, k and v of type
// p->qkv_dt.  Returns cudaGetLastError(), or -1 for a type not built.
int stripe_gla_launch(const GlaParams* p, int n_bh, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    switch (p->qkv_dt) {
        case DT_F32: return launch_gla<float>(p, n_bh, st);
        case DT_BF16: return launch_gla<__nv_bfloat16>(p, n_bh, st);
        default: return -1;
    }
}

// Shared memory of one CTA for (dk, chunk), in bytes.
int stripe_gla_smem(int dk, int chunk) { return gla_smem_floats(dk, chunk) * (int)sizeof(float); }

// Layout of GlaParams as this compiler laid it out, for the binding's check.
void stripe_gla_layout(long long* out) {
    out[0] = (long long)sizeof(GlaParams);
    out[1] = (long long)offsetof(GlaParams, s);
    out[2] = (long long)offsetof(GlaParams, qkv_dt);
    out[3] = (long long)offsetof(GlaParams, normalize);
    out[4] = (long long)offsetof(GlaParams, scale);
}

}  // extern "C"
