// Flash attention forward, GQA, causal or full: two CUDA kernels, one on
// the tensor cores for bf16 and one on the CUDA cores for everything else.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention
// (the pl.pallas_call at :137, body _fa_kernel at :63).  On the TPU the
// grid is (B*Hq, q blocks, kv blocks) with the kv axis "arbitrary": the
// running (m, l, acc) of a q block sits in VMEM scratch from one kv step
// to the next.  CUDA blocks run in no order, so here one CTA owns one
// (b*Hq head, q tile) and loops over the kv tiles itself.
//
// What it computes, as the reference does: s = (q . k) * sm_scale in
// float32; under ``causal`` the mask qpos >= kpos with both counted from 0
// (top-left aligned when Sq != Sk), masked scores -1e30 (not -inf: exp
// gives 0, never NaN); the online softmax m, l, acc in float32; a row
// whose l is 0 writes 0; the output is rounded once to the type of q.  The
// kv head of q head h is h / (Hq / Hkv).  Under ``causal`` a CTA's kv loop
// ends after the last key its last query sees: every tile past that is
// masked for all its rows and adds exactly 0 (its probabilities are 0 and
// the running max does not move), which is why the reference's block skip
// (kernel.py:76-78) may stop later without changing the result.
//
// What bounds it: operations.  At Sq = Sk = 4096, D = 128 a q tile of 128
// rows does 2 * 128 * 4096 * 128 * 2 flops (half of them under causal)
// per 2 * 4096 * 128 operand elements: far above the H100's ridge.
//
// wgmma (bf16, D 64 or 128): the card's bf16 tensor cores (989 TFLOP/s
//   on the data sheet, against 67 for float32 on the CUDA cores).  A CTA
//   owns 128 q rows: two consumer warpgroups of 64 rows each and one
//   producer warp.  The producer loads Q once by TMA (a 3-D map over
//   (B*Hq, Sq, D)) and keeps a 3-stage ring of 64-key K and V tiles full
//   (3-D maps over (B*Hkv, Sk, D): rows past Sk read zeros, never the next
//   head's), with mbarriers for full and empty slots.  Each consumer forms
//   S = Q K^T by wgmma m64n64k16 (both operands K-major in shared memory,
//   the head dim as K), scales and masks it in registers (keys past Sk
//   -inf), keeps m, l and the rescale factor per row in float32 with the
//   quad shuffles of the accumulator layout, and adds P V by wgmma
//   m64nDk16 with P rounded to bf16 in registers as the A operand (the
//   accumulator's layout is the register operand's) and V MN-major in
//   shared memory, read transposed.  l sums the float32 P.  The tiles
//   are its own: block_q and block_k do not change its result.  Numerics:
//   the reference keeps P in float32 (kernel.py:88-97); rounding P to
//   bf16 moves each term of P V by at most 2^-8 of itself, so an output
//   moves by at most 2^-8 of the attention of |v|, and the output's own
//   rounding adds one bf16 step (kernel.wgmma_bound, which the tests and
//   chip_smoke.py hold it to element by element).
// cuda_cores (float32, other head dims): 8 warps; warp w owns R
//   consecutive rows of the q tile (R = block_q / 8 rounded up to a power
//   of two, a template parameter, so each thread keeps R rows of state in
//   registers).  The Q tile lives in
//   shared memory as float32 for the whole kv loop.  K and V come through
//   shared memory 32 keys at a time, one key per lane: for its key a lane
//   forms the R scores (float4 reads, the Q rows broadcast), the warp
//   reduces max and sum with shuffles, and the probabilities go through a
//   per-warp shared buffer for P @ V, where each lane owns the head-dim
//   columns lane, lane + 32, ... (DPL of them).  A warp whose rows all lie
//   above a 32-key slab skips it.  Operands load as their type (f32 or
//   bf16: a template parameter) and convert to float32 once, on the way
//   into shared memory.  Its shared-memory traffic (one float4 read of K
//   plus R broadcast float4 reads of Q per 4R multiply-adds) caps the
//   score loop near 80% of the float32 rate at R = 16.  For float32 it
//   beats SDPA's math backend; TF32 tensor cores would break the
//   reference's float32 semantics.

#include "dag.cuh"
#include "hopper.cuh"

#define FA_WARPS 8
#define FA_NEG -1e30f  // the reference's NEG_INF

struct FaParams {
    const void* q;  // (B, Hq, Sq, D)
    const void* k;  // (B, Hkv, Sk, D)
    const void* v;  // (B, Hkv, Sk, D)
    void* o;        // (B, Hq, Sq, D)
    int sq, sk, d;
    int hq, hkv, group;
    int block_q, block_k, n_q;
    int causal;
    int dt;  // element type of q, k, v and o (DT_F32 or DT_BF16)
    float sm_scale;
};

__device__ __forceinline__ float warp_max(float x) {
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// element ``off`` of a tensor of element type T, as float
template <typename T>
__device__ __forceinline__ float ld(const void* p, long long off) {
    return Elem<T>::f(__ldg((const T*)p + off));
}

// shared memory of one CTA, in floats
template <int DPL, int R>
__host__ __device__ constexpr int fa_smem_floats() {
    return FA_WARPS * R * (DPL * 32 + 4) + 32 * (DPL * 32 + 4) + 32 * DPL * 32 + FA_WARPS * R * 32;
}

// T: the element type of q, k, v and o
template <typename T, int DPL, int R>
__global__ void __launch_bounds__(FA_WARPS * 32, 1) flash_fwd_kernel(const __grid_constant__ FaParams p) {
    constexpr int NT = FA_WARPS * 32;
    constexpr int DP = DPL * 32;  // head dim padded to a multiple of the warp
    constexpr int QS = DP + 4;    // row stride of Q and K: float4-aligned, conflict-free
    constexpr int ROWS = FA_WARPS * R;
    constexpr int QN = ROWS * DP / NT, QB = QN < 8 ? QN : 8;  // Q tile: loads a thread, a batch
    constexpr int KN = 32 * DP / NT, KB = KN < 8 ? KN : 8;    // K, V slab: the same
    extern __shared__ float4 fa_smem4[];
    float* Qs = (float*)fa_smem4;  // [ROWS][QS]
    float* Ks = Qs + ROWS * QS;    // [32][QS]
    float* Vs = Ks + 32 * QS;      // [32][DP]
    float* Ps = Vs + 32 * DP;      // [FA_WARPS][R][32]

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // b*h and the q tile share grid x, a head's tiles together, the
    // longest causal ones first
    const int qi = p.n_q - 1 - (int)(blockIdx.x % p.n_q);
    const int bh = (int)(blockIdx.x / p.n_q);
    const int b = bh / p.hq, h = bh % p.hq;
    const int q0 = qi * p.block_q;
    const long long q_base = ((long long)bh * p.sq + q0) * p.d;
    const long long kv_base = ((long long)b * p.hkv + h / p.group) * p.sk * p.d;

#pragma unroll 1
    for (int u0 = 0; u0 < QN; u0 += QB) {
        float x[QB];
#pragma unroll
        for (int u = 0; u < QB; ++u) {
            const int i = threadIdx.x + (u0 + u) * NT, r = i / DP, c = i % DP;
            x[u] = (r < p.block_q && c < p.d) ? ld<T>(p.q, q_base + (long long)r * p.d + c) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < QB; ++u) {
            const int i = threadIdx.x + (u0 + u) * NT;
            Qs[(i / DP) * QS + i % DP] = x[u];
        }
    }

    int kv_end = p.sk;
    if (p.causal) {
        const long long last_q = (long long)q0 + p.block_q - 1;
        kv_end = (int)min((long long)p.sk, (last_q / p.block_k + 1) * p.block_k);
    }
    const int row0 = warp * R;                     // first row of this warp in the tile
    const int n_rows = min(R, p.block_q - row0);   // <= 0: an idle warp
    const int last_q = q0 + row0 + n_rows - 1;
    float* Pw = Ps + warp * R * 32;

    float m[R], l[R], acc[R][DPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        m[r] = FA_NEG;
        l[r] = 0.0f;
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[r][t] = 0.0f;
    }

    for (int kv0 = 0; kv0 < kv_end; kv0 += 32) {
        __syncthreads();  // every warp is done with the previous slab
#pragma unroll 1
        for (int u0 = 0; u0 < KN; u0 += KB) {
            float kx[KB], vx[KB];
#pragma unroll
            for (int u = 0; u < KB; ++u) {
                const int i = threadIdx.x + (u0 + u) * NT, j = i / DP, c = i % DP;
                kx[u] = vx[u] = 0.0f;
                if (kv0 + j < kv_end && c < p.d) {
                    const long long off = kv_base + (long long)(kv0 + j) * p.d + c;
                    kx[u] = ld<T>(p.k, off);
                    vx[u] = ld<T>(p.v, off);
                }
            }
#pragma unroll
            for (int u = 0; u < KB; ++u) {
                const int i = threadIdx.x + (u0 + u) * NT, j = i / DP, c = i % DP;
                Ks[j * QS + c] = kx[u];
                Vs[j * DP + c] = vx[u];
            }
        }
        __syncthreads();
        if (n_rows <= 0 || (p.causal && kv0 > last_q)) continue;

        // the scores of this lane's key against the warp's R rows
        float s[R];
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = 0.0f;
        const float4* k4 = (const float4*)(Ks + lane * QS);
#pragma unroll 4
        for (int c4 = 0; c4 < DP / 4; ++c4) {
            const float4 kk = k4[c4];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float4 qq = ((const float4*)(Qs + (row0 + r) * QS))[c4];
                s[r] = fmaf(qq.x, kk.x, s[r]);
                s[r] = fmaf(qq.y, kk.y, s[r]);
                s[r] = fmaf(qq.z, kk.z, s[r]);
                s[r] = fmaf(qq.w, kk.w, s[r]);
            }
        }
        const int key = kv0 + lane;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            float x = s[r] * p.sm_scale;
            if (key >= kv_end) x = -INFINITY;  // past the loop's end: no key
            else if (p.causal && q0 + row0 + r < key) x = FA_NEG;
            const float m_new = fmaxf(m[r], warp_max(x));
            const float alpha = expf(m[r] - m_new);
            const float pe = expf(x - m_new);
            l[r] = l[r] * alpha + warp_sum(pe);
            m[r] = m_new;
#pragma unroll
            for (int t = 0; t < DPL; ++t) acc[r][t] *= alpha;
            Pw[r * 32 + lane] = pe;
        }
        __syncwarp();
        // acc += P @ V over the slab's 32 keys
#pragma unroll 2
        for (int j = 0; j < 32; j += 4) {
            float v0[DPL], v1[DPL], v2[DPL], v3[DPL];
#pragma unroll
            for (int t = 0; t < DPL; ++t) {
                v0[t] = Vs[(j + 0) * DP + lane + 32 * t];
                v1[t] = Vs[(j + 1) * DP + lane + 32 * t];
                v2[t] = Vs[(j + 2) * DP + lane + 32 * t];
                v3[t] = Vs[(j + 3) * DP + lane + 32 * t];
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float4 pp = *(const float4*)(Pw + r * 32 + j);
#pragma unroll
                for (int t = 0; t < DPL; ++t) {
                    acc[r][t] = fmaf(pp.x, v0[t], acc[r][t]);
                    acc[r][t] = fmaf(pp.y, v1[t], acc[r][t]);
                    acc[r][t] = fmaf(pp.z, v2[t], acc[r][t]);
                    acc[r][t] = fmaf(pp.w, v3[t], acc[r][t]);
                }
            }
        }
        __syncwarp();
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (r >= n_rows) break;
        const float lr = l[r] == 0.0f ? 1.0f : l[r];
        const long long row = q_base + (long long)(row0 + r) * p.d;
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
            const int c = lane + 32 * t;
            if (c < p.d) store_as(p.o, p.dt, row + c, acc[r][t] / lr);
        }
    }
}


// ============================================================ wgmma path
#define FW_BM 128        // q rows a CTA: two consumer warpgroups of 64
#define FW_BN 64         // keys a kv tile
#define FW_THREADS 288   // two consumer warpgroups, one producer warp
#define FW_STAGES 3      // kv ring

template <int D>
__host__ __device__ constexpr int fw_smem_bytes() {
    return (FW_BM + 2 * FW_STAGES * FW_BN) * D * 2 + (2 * FW_STAGES + 1) * 8 + 1024;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *(const unsigned*)&v;
}

// D: the head dim (64 or 128), in 64-wide boxes of 128 bytes
template <int D>
__global__ void __launch_bounds__(FW_THREADS, 1) flash_wgmma_kernel(
        const __grid_constant__ FaParams p, const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
    constexpr int NB = D / 64;           // boxes along the head dim
    constexpr int QBOX = FW_BM * 128;    // bytes of a Q box: 128 rows x 64 of D
    constexpr int KBOX = FW_BN * 128;    // ... of a K or V box: 64 keys x 64 of D
    extern __shared__ __align__(16) unsigned char fw_raw[];
    unsigned char* smem = fw_raw + ((1024 - (smem_u32(fw_raw) & 1023)) & 1023);
    unsigned char* sq = smem;                           // [box]
    unsigned char* sk = sq + NB * QBOX;                 // [stage][box]
    unsigned char* sv = sk + FW_STAGES * NB * KBOX;     // [stage][box]
    uint64_t* full = (uint64_t*)(sv + FW_STAGES * NB * KBOX);
    uint64_t* empty = full + FW_STAGES;
    uint64_t* qbar = empty + FW_STAGES;

    // grid x: every head's q tile of one row range, then the next range,
    // the longest causal tiles first
    const int n_qt = (p.sq + FW_BM - 1) / FW_BM;
    const int n_bh = (int)(gridDim.x / n_qt);
    const int bh = (int)(blockIdx.x % n_bh);
    const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_bh)) * FW_BM;
    const int kvh = (bh / p.hq) * p.hkv + (bh % p.hq) / p.group;
    const int last_q = min(q0 + FW_BM, p.sq) - 1;
    const int kv_end = p.causal ? min(p.sk, last_q + 1) : p.sk;
    const int n_kv = (kv_end + FW_BN - 1) / FW_BN;

    if (threadIdx.x == 0) {
        for (int s = 0; s < FW_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 2);
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= 256) {  // the producer warp: one lane issues the copies
        if (threadIdx.x == 256) {
            mbar_expect_tx(qbar, NB * QBOX);
            for (int c = 0; c < NB; ++c) tma_load3(&tq, sq + c * QBOX, qbar, c * 64, q0, bh);
            for (int j = 0; j < n_kv; ++j) {
                const int s = j % FW_STAGES;
                if (j >= FW_STAGES) mbar_wait(&empty[s], ((j / FW_STAGES) - 1) & 1);
                mbar_expect_tx(&full[s], 2 * NB * KBOX);
                for (int c = 0; c < NB; ++c) {
                    tma_load3(&tk, sk + (s * NB + c) * KBOX, &full[s], c * 64, j * FW_BN, kvh);
                    tma_load3(&tv, sv + (s * NB + c) * KBOX, &full[s], c * 64, j * FW_BN, kvh);
                }
            }
        }
        return;
    }

    const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
    const int r0 = q0 + wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);  // rows r0 and r0 + 8
    const float sl2 = p.sm_scale * 1.4426950408889634f;  // scores in log2 units: exp2
    float o[D / 2], m[2] = {FA_NEG, FA_NEG}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    mbar_wait(qbar, 0);
    for (int j = 0; j < n_kv; ++j) {
        const int s = j % FW_STAGES;
        mbar_wait(&full[s], (j / FW_STAGES) & 1);
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
        fence_regs<32>(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // 16 of D a step: box kk / 4, 32 bytes on
            const int c = kk >> 2, off = (kk & 3) * 32;
            Wgmma<__nv_bfloat16, 64>::template mma<0>(
                sc, sw128_desc(sq + c * QBOX + wg * 64 * 128 + off),
                sw128_desc(sk + (s * NB + c) * KBOX + off));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(sc);

        // scale, mask, and the online softmax over this tile's 64 keys
        const int kv0 = j * FW_BN;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1, key = kv0 + (i >> 2) * 8 + (t & 3) * 2 + (i & 1);
            float x = sc[i] * sl2;
            if (key >= p.sk) x = -INFINITY;  // past the keys: the TMA box's zero rows
            else if (p.causal && r0 + 8 * r < key) x = FA_NEG;
            sc[i] = x;
            mx[r] = fmaxf(mx[r], x);
        }
        float alpha[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            alpha[r] = exp2f(m[r] - mx[r]);
            m[r] = mx[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            sc[i] = exp2f(sc[i] - m[r]);
            ps[r] += sc[i];
        }
        // l is this thread's share of the row sum (its 16 keys of each
        // tile); the quad's four shares meet once, after the loop
        l[0] = l[0] * alpha[0] + ps[0];
        l[1] = l[1] * alpha[1] + ps[1];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

        // O += P V: P as bf16 register fragments, 16 keys a step
        unsigned a[FW_BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < FW_BN / 16; ++kk)
#pragma unroll
            for (int u = 0; u < 4; ++u)
                a[kk][u] = pack_bf16(sc[kk * 8 + 2 * u], sc[kk * 8 + 2 * u + 1]);
        fence_regs<D / 2>(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < FW_BN / 16; ++kk)
            Wgmma<__nv_bfloat16, D>::template mma_rs<1>(
                o, a[kk], sw128_mn_desc(sv + s * NB * KBOX + kk * 16 * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        if (t == 0) mbar_arrive(&empty[s]);  // this warpgroup is done with the slot
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = l[r] == 0.0f ? 1.0f : l[r];
    }
    __nv_bfloat16* out = (__nv_bfloat16*)p.o;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
        int row, col;
        frag_mn(i, t, row, col);
        const int q = q0 + wg * 64 + row, r = (i >> 1) & 1;
        if (q < p.sq)
            *(__nv_bfloat162*)(out + ((long long)bh * p.sq + q) * D + col) =
                __floats2bfloat162_rn(o[i] / l[r], o[i + 1] / l[r]);
    }
}

// The TMA map of q, k or v: (D, rows, heads), boxes of 64 of D by ``box``
// rows; rows past ``rows`` read zeros.
static int fw_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads, int box) {
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
    const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)d * 2 * rows};
    const cuuint32_t b[3] = {64, (cuuint32_t)box, 1};
    return tensor_map3(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims, strides, b);
}

template <int D>
static int launch_fw(const FaParams* p, int n_bh, cudaStream_t st) {
    alignas(64) CUtensorMap tq, tk, tv;
    int rc = fw_map(&tq, p->q, D, p->sq, n_bh, FW_BM);
    if (!rc) rc = fw_map(&tk, p->k, D, p->sk, n_bh / p->group, FW_BN);
    if (!rc) rc = fw_map(&tv, p->v, D, p->sk, n_bh / p->group, FW_BN);
    if (rc) return rc;
    constexpr int bytes = fw_smem_bytes<D>();
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    const unsigned grid = (unsigned)n_bh * (unsigned)((p->sq + FW_BM - 1) / FW_BM);
    flash_wgmma_kernel<D><<<grid, FW_THREADS, bytes, st>>>(*p, tq, tk, tv);
    return (int)cudaGetLastError();
}

// one (T, DPL, R) instantiation: dynamic shared memory above 48 KB is
// opted into per kernel before its launch
template <typename T, int DPL, int R>
static int launch_fa(const FaParams* p, int n_bh, cudaStream_t st) {
    constexpr int bytes = fa_smem_floats<DPL, R>() * (int)sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DPL, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    flash_fwd_kernel<T, DPL, R><<<(unsigned)p->n_q * (unsigned)n_bh, FA_WARPS * 32, bytes, st>>>(*p);
    return (int)cudaGetLastError();
}

template <typename T, int DPL>
static int fa_by_rows(const FaParams* p, int rows, int n_bh, cudaStream_t st) {
    switch (rows) {
        case 1: return launch_fa<T, DPL, 1>(p, n_bh, st);
        case 2: return launch_fa<T, DPL, 2>(p, n_bh, st);
        case 4: return launch_fa<T, DPL, 4>(p, n_bh, st);
        case 8: return launch_fa<T, DPL, 8>(p, n_bh, st);
        case 16:
            if constexpr (DPL <= 4) return launch_fa<T, DPL, 16>(p, n_bh, st);
            return -1;
        default: return -1;
    }
}

template <typename T>
static int fa_by_dpl(const FaParams* p, int dpl, int rows, int n_bh, cudaStream_t st) {
    switch (dpl) {
        case 1: return fa_by_rows<T, 1>(p, rows, n_bh, st);
        case 2: return fa_by_rows<T, 2>(p, rows, n_bh, st);
        case 4: return fa_by_rows<T, 4>(p, rows, n_bh, st);
        case 8: return fa_by_rows<T, 8>(p, rows, n_bh, st);
        default: return -1;
    }
}

template <int DPL>
static int smem_by_rows(int rows) {
    switch (rows) {
        case 1: return fa_smem_floats<DPL, 1>() * 4;
        case 2: return fa_smem_floats<DPL, 2>() * 4;
        case 4: return fa_smem_floats<DPL, 4>() * 4;
        case 8: return fa_smem_floats<DPL, 8>() * 4;
        case 16:
            if constexpr (DPL <= 4) return fa_smem_floats<DPL, 16>() * 4;
            return -1;
        default: return -1;
    }
}

extern "C" {

// Launches one flash-attention forward on ``stream``: ``dpl`` = the head
// dim rounded up to a multiple of 32, over 32 (1, 2, 4 or 8); ``rows`` =
// rows per warp R (1, 2, 4, 8, or 16 where dpl <= 4); ``n_bh`` = B * Hq;
// the element type is p->dt (f32 or bf16).  Returns
// cudaGetLastError(), or -1 for a combination not built.
int stripe_flash_attention_launch(const FaParams* p, int dpl, int rows, int n_bh, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    switch (p->dt) {
        case DT_F32: return fa_by_dpl<float>(p, dpl, rows, n_bh, st);
        case DT_BF16: return fa_by_dpl<__nv_bfloat16>(p, dpl, rows, n_bh, st);
        default: return -1;
    }
}

// Launches the wgmma kernel (bf16, head dim ``d`` 64 or 128) on
// ``stream``; returns cudaGetLastError(), an error code of hopper.cuh, or
// -1 for a head dim not built.
int stripe_flash_attention_wgmma(const FaParams* p, int d, int n_bh, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (p->dt != DT_BF16) return -1;
    switch (d) {
        case 64: return launch_fw<64>(p, n_bh, st);
        case 128: return launch_fw<128>(p, n_bh, st);
        default: return -1;
    }
}

// Shared memory of one CTA of (dpl, rows), in bytes (-1: not built).
int stripe_flash_attention_smem(int dpl, int rows) {
    switch (dpl) {
        case 1: return smem_by_rows<1>(rows);
        case 2: return smem_by_rows<2>(rows);
        case 4: return smem_by_rows<4>(rows);
        case 8: return smem_by_rows<8>(rows);
        default: return -1;
    }
}

// Layout of FaParams as this compiler laid it out, for the binding's check.
void stripe_flash_attention_layout(long long* out) {
    out[0] = (long long)sizeof(FaParams);
    out[1] = (long long)offsetof(FaParams, sq);
    out[2] = (long long)offsetof(FaParams, causal);
    out[3] = (long long)offsetof(FaParams, dt);
    out[4] = (long long)offsetof(FaParams, sm_scale);
}

}  // extern "C"
