// Flash attention forward, GQA, causal or full: three paths, two on the
// tensor cores (bf16; float32 in 3xTF32) and one on the CUDA cores for
// everything else.
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
// tf32x3 (float32, D 64 or 128): the wgmma kernel's structure in float32,
//   every product as three tf32 products, a_hi b_hi + a_hi b_lo + a_lo
//   b_hi (hi = x with its low 13 mantissa bits cleared, lo = x - hi), which
//   moves a product by at most 3 2^-20 |a| |b| where plain TF32 moves it
//   by 2^-10 (kernel.flash_tf32x3_bound carries that through the softmax).
//   wgmma reads 32-bit operands K-major only, so a prep kernel
//   (flash_split_kernel) writes K split, hi and lo (B*Hkv, Sk, D), and V
//   transposed and split, (B*Hkv, D, Sk rounded up to 8, zeros past Sk),
//   the keys of every 8 in the order 0 2 4 6 1 3 5 7: the score
//   accumulator's registers (keys 2t, 2t + 1 of each 8) are then P's A
//   operand (columns t, t + 4).  The main kernel (flash_tf32x3_kernel):
//   128 q rows a CTA, two consumer warpgroups and a producer warpgroup
//   (setmaxnreg moves its registers to the consumers), which loads Q once and keeps a ring of 32-key stages, K hi and lo and V^T
//   hi and lo (64 KiB a stage at D 128: two stages and the 64 KiB Q tile
//   fill 192 KiB, one CTA an SM; four at D 64).  Each consumer splits its
//   64 Q rows once: hi back into the swizzled box, lo into registers
//   (D / 2 of them), so S = Q K^T is Q_hi K_hi + Q_hi K_lo from shared
//   memory and Q_lo K_hi from registers, m64n32k8 a step; then the online
//   softmax as on the wgmma path (l sums the float32 P), P split in
//   registers, and O += P V as three m64nDk8 products a step.  Its bound
//   is operations at the TF32 rate, three times over.
// cuda_cores (float32 or bf16 at other head dims, or misaligned): 8
//   warps; warp w owns R consecutive rows of the q tile (R = block_q / 8
//   rounded up to a power of two, a template parameter, so each thread
//   keeps R rows of state in registers).  The Q tile lives in shared
//   memory as float32 for the whole kv loop.  K and V come through
//   shared memory 32 keys at a time, one key per lane: for its key a lane
//   forms the R scores (float4 reads, the Q rows broadcast), the warp
//   reduces max and sum with shuffles, and the probabilities go through a
//   per-warp shared buffer for P @ V, where each lane owns the head-dim
//   columns lane, lane + 32, ... (DPL of them).  A warp whose rows all lie
//   above a 32-key slab skips it.  Operands load as their type (f32 or
//   bf16: a template parameter) and convert to float32 once, on the way
//   into shared memory.  Its shared-memory traffic (one float4 read of K
//   plus R broadcast float4 reads of Q per 4R multiply-adds) caps the
//   score loop near 80% of the float32 rate at R = 16.

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
            else if (p.causal && r0 + 8 * r < key) x = FA_NEG;  // fault site: flash wgmma causal mask
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
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];  // fault site: flash wgmma rescale

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

// ============================================================ tf32x3 path
#define FT_BM 128       // q rows a CTA: two consumer warpgroups of 64
#define FT_BN 32        // keys a kv stage
#define FT_THREADS 384  // two consumer warpgroups, one producer warpgroup
// registers a thread: 168 at launch (384 threads on 64K registers); the
// producer gives back all but 40, which lets each consumer hold 232
#define FT_REGS_PRODUCER 40
#define FT_REGS_CONSUMER 232
static_assert(128 * FT_REGS_PRODUCER + 256 * FT_REGS_CONSUMER <= 168 * FT_THREADS,
              "the warpgroups' registers exceed the CTA's at launch");
#define FT_KBOX 4096    // bytes of a K box: 32 keys x 32 floats of D

__host__ __device__ constexpr int ft_stages(int d) { return d == 64 ? 4 : 2; }
// a stage: K hi and lo (D / 32 boxes each), V^T hi and lo (D rows of 32 keys)
__host__ __device__ constexpr int ft_stage_bytes(int d) { return 2 * (d / 32) * FT_KBOX + 2 * d * 128; }
// the Q tile (D / 32 boxes of 128 rows), the ring, the barriers; 1024 of
// slack for the swizzle's alignment
__host__ __device__ constexpr int ft_smem_bytes(int d) {
    return 1024 + (d / 32) * FT_BM * 128 + ft_stages(d) * ft_stage_bytes(d) +
           8 * (2 * ft_stages(d) + 1);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// k (B*Hkv, Sk, D) -> k hi and lo, the same layout; v (B*Hkv, Sk, D) ->
// v^T hi and lo (B*Hkv, D, Skp), Skp = Sk rounded up to 8, zeros past Sk,
// the keys of every 8 in the order 0 2 4 6 1 3 5 7.  One CTA per (b*Hkv,
// 32 keys); D a multiple of 4.
__global__ void __launch_bounds__(256) flash_split_kernel(const float* k, const float* v,
                                                          float* kh, float* kl, float* vh,
                                                          float* vl, int sk, int skp, int d) {
    __shared__ float tile[32][33];
    const int n_st = (skp + 31) / 32, s0 = (int)(blockIdx.x % n_st) * 32;
    const long long bh = blockIdx.x / n_st, base = (bh * sk + s0) * d;
    const float4* k4 = (const float4*)(k + base);
    for (int i = threadIdx.x; i < min(32, sk - s0) * d / 4; i += 256) {
        const float4 x = k4[i];
        const float4 h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
        ((float4*)(kh + base))[i] = h;
        ((float4*)(kl + base))[i] = make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
    }
    transpose_split32(v + bh * sk * d, vh + bh * d * skp, vl + bh * d * skp, sk, d, skp, s0, tile);
}

// D: the head dim (64 or 128), in boxes of 32 floats (128 bytes)
template <int D>
__global__ void __launch_bounds__(FT_THREADS, 1) flash_tf32x3_kernel(
        const __grid_constant__ FaParams p, const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tkh, const __grid_constant__ CUtensorMap tkl,
        const __grid_constant__ CUtensorMap tvh, const __grid_constant__ CUtensorMap tvl) {
    constexpr int NB = D / 32;          // boxes along the head dim
    constexpr int QBOX = FT_BM * 128;   // bytes of a Q box: 128 rows x 32 of D
    constexpr int VBOX = D * 128;       // ... of a V^T box: D rows x 32 keys
    constexpr int STAGES = ft_stages(D), STAGE = ft_stage_bytes(D);
    extern __shared__ __align__(16) unsigned char ft_raw[];
    unsigned char* smem = ft_raw + ((1024 - (smem_u32(ft_raw) & 1023)) & 1023);
    unsigned char* sq = smem;                // [box]
    unsigned char* ring = sq + NB * QBOX;    // [stage]: K hi boxes, K lo boxes, V^T hi, V^T lo
    uint64_t* full = (uint64_t*)(ring + STAGES * STAGE);
    uint64_t* empty = full + STAGES;
    uint64_t* qbar = empty + STAGES;

    // grid x: every head's q tile of one row range, then the next range,
    // the longest causal tiles first
    const int n_qt = (p.sq + FT_BM - 1) / FT_BM;
    const int n_bh = (int)(gridDim.x / n_qt);
    const int bh = (int)(blockIdx.x % n_bh);
    const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_bh)) * FT_BM;
    const int kvh = (bh / p.hq) * p.hkv + (bh % p.hq) / p.group;
    const int last_q = min(q0 + FT_BM, p.sq) - 1;
    const int kv_end = p.causal ? min(p.sk, last_q + 1) : p.sk;
    const int n_kv = (kv_end + FT_BN - 1) / FT_BN;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 2);
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= 256) {  // the producer warpgroup: one thread issues the copies
        reg_dealloc<FT_REGS_PRODUCER>();
        if (threadIdx.x == 256) {
            mbar_expect_tx(qbar, NB * QBOX);
            for (int c = 0; c < NB; ++c) tma_load3(&tq, sq + c * QBOX, qbar, c * 32, q0, bh);
            for (int j = 0; j < n_kv; ++j) {
                const int s = j % STAGES;
                unsigned char* st = ring + s * STAGE;
                if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
                mbar_expect_tx(&full[s], STAGE);
                for (int c = 0; c < NB; ++c) {
                    tma_load3(&tkh, st + c * FT_KBOX, &full[s], c * 32, j * FT_BN, kvh);
                    tma_load3(&tkl, st + (NB + c) * FT_KBOX, &full[s], c * 32, j * FT_BN, kvh);
                }
                tma_load3(&tvh, st + 2 * NB * FT_KBOX, &full[s], j * FT_BN, 0, kvh);
                tma_load3(&tvl, st + 2 * NB * FT_KBOX + VBOX, &full[s], j * FT_BN, 0, kvh);
            }
        }
        return;
    }

    reg_alloc<FT_REGS_CONSUMER>();  // o, Q's lo and P's split live across the products
    const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
    const int w16 = wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2), tc = t & 3;  // rows w16, w16 + 8
    const int r0 = q0 + w16;
    // Q, split once: hi back into its box (read by the first two products
    // from shared memory), lo into registers (the third's A operand)
    mbar_wait(qbar, 0);
    unsigned qlo[D / 8][4];
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float* at = sw_ptr(sq + (kk >> 2) * QBOX, w16 + 8 * (e & 1), (kk & 3) * 8 + tc + 4 * (e >> 1));
            const float x = *at, hi = tf32_hi(x);
            *at = hi;
            qlo[kk][e] = __float_as_uint(x - hi);
        }
    fence_async_smem();
    bar_sync(1 + wg, 128);  // this warpgroup's 64 rows are split

    const unsigned char* qa = sq + wg * 64 * 128;  // this warpgroup's rows of each box
    const float sl2 = p.sm_scale * 1.4426950408889634f;  // scores in log2 units: exp2
    float o[D / 2], m[2] = {FA_NEG, FA_NEG}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        const unsigned char* ks = ring + s * STAGE;
        const unsigned char* vs = ks + 2 * NB * FT_KBOX;
        mbar_wait(&full[s], (j / STAGES) & 1);
        float sc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) sc[i] = 0.0f;
        fence_regs<16>(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {  // 8 of D a step: box kk / 4, 32 bytes on
            const int c = kk >> 2, off = (kk & 3) * 32;
            const uint64_t qh = sw128_desc(qa + c * QBOX + off);
            const uint64_t kh = sw128_desc(ks + c * FT_KBOX + off);
            const uint64_t kl = sw128_desc(ks + (NB + c) * FT_KBOX + off);
            Wgmma<float, 32>::template mma<0>(sc, qh, kh);
            Wgmma<float, 32>::template mma<0>(sc, qh, kl);  // fault site: flash tf32x3 lo product
            Wgmma<float, 32>::template mma_rs<0>(sc, qlo[kk], kh);  // fault site: flash tf32x3 lo product
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<16>(sc);

        // scale, mask, and the online softmax over this stage's 32 keys
        const int kv0 = j * FT_BN;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int r = (i >> 1) & 1, key = kv0 + (i >> 2) * 8 + tc * 2 + (i & 1);
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
        for (int i = 0; i < 16; ++i) {
            const int r = (i >> 1) & 1;
            sc[i] = exp2f(sc[i] - m[r]);
            ps[r] += sc[i];
        }
        // l is this thread's share of the row sum; the quad's four shares
        // meet once, after the loop
        l[0] = l[0] * alpha[0] + ps[0];
        l[1] = l[1] * alpha[1] + ps[1];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

        // O += P V, 8 keys a step: P's k8 step kk is its registers 4 kk
        // (row g, key 2t), 4 kk + 2 (g + 8, 2t), 4 kk + 1 (g, 2t + 1),
        // 4 kk + 3 (g + 8, 2t + 1), which V^T's order of keys matches
        unsigned ph[FT_BN / 8][4], pl[FT_BN / 8][4];
#pragma unroll
        for (int kk = 0; kk < FT_BN / 8; ++kk) {
            const int i = 4 * kk;
            split(sc[i], ph[kk][0], pl[kk][0]);
            split(sc[i + 2], ph[kk][1], pl[kk][1]);
            split(sc[i + 1], ph[kk][2], pl[kk][2]);
            split(sc[i + 3], ph[kk][3], pl[kk][3]);
        }
        fence_regs<D / 2>(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < FT_BN / 8; ++kk) {
            const uint64_t vh = sw128_desc(vs + kk * 32), vl = sw128_desc(vs + VBOX + kk * 32);
            Wgmma<float, D>::template mma_rs<0>(o, ph[kk], vh);
            Wgmma<float, D>::template mma_rs<0>(o, ph[kk], vl);  // fault site: flash tf32x3 lo product
            Wgmma<float, D>::template mma_rs<0>(o, pl[kk], vh);  // fault site: flash tf32x3 lo product
        }
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
    float* out = (float*)p.o;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
        int row, col;
        frag_mn(i, t, row, col);
        const int q = q0 + wg * 64 + row, r = (i >> 1) & 1;
        if (q < p.sq)
            *(float2*)(out + ((long long)bh * p.sq + q) * D + col) =
                make_float2(o[i] / l[r], o[i + 1] / l[r]);
    }
}

template <int D>
static int launch_ft(const FaParams* p, float* kh, float* kl, float* vh, float* vl, int n_bh,
                     cudaStream_t st) {
    const int n_kvh = n_bh / p->group, skp = (p->sk + 7) & ~7;
    alignas(64) CUtensorMap tq, tkh, tkl, tvh, tvl;
    int rc = f32_map(&tq, p->q, D, p->sq, n_bh, FT_BM);
    if (!rc) rc = f32_map(&tkh, kh, D, p->sk, n_kvh, FT_BN);
    if (!rc) rc = f32_map(&tkl, kl, D, p->sk, n_kvh, FT_BN);
    if (!rc) rc = f32_map(&tvh, vh, skp, D, n_kvh, D);
    if (!rc) rc = f32_map(&tvl, vl, skp, D, n_kvh, D);
    if (rc) return rc;
    constexpr int bytes = ft_smem_bytes(D);
    cudaError_t e = cudaFuncSetAttribute(flash_tf32x3_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    flash_split_kernel<<<(unsigned)n_kvh * (unsigned)((skp + 31) / 32), 256, 0, st>>>(
        (const float*)p->k, (const float*)p->v, kh, kl, vh, vl, p->sk, skp, D);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const unsigned grid = (unsigned)n_bh * (unsigned)((p->sq + FT_BM - 1) / FT_BM);
    flash_tf32x3_kernel<D><<<grid, FT_THREADS, bytes, st>>>(*p, tq, tkh, tkl, tvh, tvl);
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

// Launches the tf32x3 path (float32, head dim p->d 64 or 128) on
// ``stream``: the split copies of k and v into the scratch ``k_hi``,
// ``k_lo`` (B*Hkv, Sk, D) and ``vt_hi``, ``vt_lo`` (B*Hkv, D, Sk rounded
// up to 8), then the main kernel.  Returns cudaGetLastError(), an error
// code of hopper.cuh, or -1 for inputs the path does not take.
int stripe_flash_attention_tf32x3(const FaParams* p, void* k_hi, void* k_lo, void* vt_hi,
                                  void* vt_lo, int n_bh, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (p->dt != DT_F32 || p->sq <= 0 || p->sk <= 0) return -1;
    float *kh = (float*)k_hi, *kl = (float*)k_lo, *vh = (float*)vt_hi, *vl = (float*)vt_lo;
    switch (p->d) {
        case 64: return launch_ft<64>(p, kh, kl, vh, vl, n_bh, st);
        case 128: return launch_ft<128>(p, kh, kl, vh, vl, n_bh, st);
        default: return -1;
    }
}

// Shared memory of one CTA of the tf32x3 kernel at head dim ``d``, in
// bytes (-1: not built).
int stripe_flash_attention_tf32x3_smem(int d) {
    return d == 64 ? ft_smem_bytes(64) : d == 128 ? ft_smem_bytes(128) : -1;
}

// Registers a thread of the tf32x3 kernel at head dim ``d`` holds at
// launch, which setmaxnreg redistributes (-1: not built, or the query
// failed).
int stripe_flash_attention_tf32x3_regs(int d) {
    cudaFuncAttributes a;
    const cudaError_t e = d == 64    ? cudaFuncGetAttributes(&a, flash_tf32x3_kernel<64>)
                          : d == 128 ? cudaFuncGetAttributes(&a, flash_tf32x3_kernel<128>)
                                     : cudaErrorInvalidValue;
    return e == cudaSuccess ? a.numRegs : -1;
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
