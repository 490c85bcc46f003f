// One Stripe fusion group as CUDA kernels on Hopper (sm_90a): prologue DAGs
// on the operand elements, the contraction, an optional scale, then the
// epilogue DAG (bias, activations, diamond joins, extra tensor inputs) and
// the store.
//
// Replaces: src/repro/core/lower_pallas.py::_emit_contraction (the
// pl.pallas_call of one fusion group on the TPU).
//
// One fixed source takes the group as data (struct Params): the output's
// index variables with their extents, the reduction variables, a pointer
// and an element stride per variable for every operand and every extra
// epilogue input (0 where the tensor lacks the variable), the clip of the
// output region, the scale, and the lhs / rhs / epilogue DAGs compiled to
// short postfix programs.  No per-group source, so one nvcc build serves
// every group of every program.
//
// Semantics are Stripe's: every variable that addresses the output is a
// parallel variable, including output variables that both operands share
// (batch dims: the GQA scores/values heads); every other variable is
// summed.  Sums run in float32, or in int32 for an integer output (the
// reference's _acc_dtype); the store rounds once to the output's type.
// Nothing uses atomics: where a sum is split (over threads, warps or
// CTAs) the partial sums meet in a fixed order, so every result is
// deterministic.
//
// The binding (kernels/contraction.py::gemm_view) reads a plan whose two
// sides are plain loads as one batched product C[b, m, n] = sum_k A[b, m,
// k] B[b, k, n]: batch = the output variables both operands read, M (N) =
// the one only A (B) reads, K = the reduction variable both read.  Such a
// plan takes one of three paths; every other plan (a prologue program,
// several M, N or K variables, a variable only one side reads, operand
// types no path takes) runs the general loop, with the reason on record.
//
// skinny (M <= 16: decode).  Bound by bytes: each weight (B) element is
//   used M times, so the card's 3.35 TB/s caps it.  A CTA owns a slab of
//   128 columns of N (32 where B is unit-stride along K) for all M rows.
//   The B tile streams through a 4-stage shared-memory ring of 16-byte
//   cp.async copies (zero-filled past the edges), so each weight byte is
//   read from HBM once and many copies are in flight; the CTA's slice of
//   A sits in shared memory as float32 (int32) for all its K, and every
//   weight element feeds all M rows from registers.  K is split over the
//   8 warps of the CTA, and over CTAs where N alone would leave the SMs
//   idle; the CTAs' partial sums go to a scratch buffer and a second pass
//   adds them in split order and applies the epilogue.
// tiled, float32 (or a float32 lhs and a bf16 rhs: prefill, stripe_matmul,
//   an unfused intermediate times bf16 weights).  Bound by operations on the CUDA cores (67 TFLOP/s;
//   no TF32, the reference's float32 semantics).  128 x 128 output tiles,
//   K in steps of 16 through a 3-stage ring filled by cp.async (16-byte
//   copies along a unit-stride M/N, 4-byte copies otherwise: that also
//   transposes a K-major operand into the [k][m] layout), and 8 x 8
//   outputs per thread: 16 shared-memory loads for 64 FMAs.  K is split
//   over CTAs as on the skinny path where the tiles alone fill too few SMs
//   (prefill at m = 128 has 8-112 of them).
// tiled, bf16 / f16 -> float32 and int8 -> int32.  Bound by operations on
//   the tensor cores (989 / 1979 TFLOP/s).  wgmma m64n128k16 (k32 for
//   int8): two consumer warpgroups of 64 rows each over a 128 x 128 tile,
//   one producer warp that keeps a 4-stage ring of 128-byte-wide K slabs
//   full with TMA (128-byte swizzle, as wgmma reads it; mbarriers for
//   full and empty slots); each consumer keeps one stage of products in
//   flight.  TMA reads an operand in place when it is K-major with rows
//   at 16-byte steps, and a 16-bit B also when it is N-major (a weight
//   W[k, n]: wgmma reads it transposed).  Any other operand (an MN-major
//   A, an MN-major int8 B: wgmma reads 8-bit types K-major only; rows not
//   at 16-byte steps; batch dims) is first copied K-major into scratch by
//   a transposing pack pass, one read and one write of it.  No split of K.
//
// The three paths share the epilogue (scale, then the postfix epilogue
// program at the element's output coordinates, extra inputs included),
// the store masks of the ragged edges and the clip, and the one rounding
// to the output's type (emit / finish below).

#include <type_traits>

#include "dag.cuh"
#include "hopper.cuh"

#define MAXV 8     // output variables, and reduction variables
#define MAXS 6     // operand slots (distinct leaf loads)
#define MAXE 6     // extra epilogue inputs
#define MAXD 8     // output rank

// Params.path; must match repro_torch/kernels/contraction.py
#define PATH_GENERAL 0
#define PATH_SKINNY 1
#define PATH_FFMA 2
#define PATH_WGMMA 3

struct Params {
    void* out;
    const void* slot[MAXS];
    const void* eslot[MAXE];
    long long slot_base[MAXS];
    long long slot_ostride[MAXS][MAXV];
    long long slot_rstride[MAXS][MAXV];
    long long eslot_base[MAXE];
    long long eslot_ostride[MAXE][MAXV];
    long long out_ostride[MAXV];
    double scale;
    double consts[MAXC];
    int slot_dt[MAXS];
    int eslot_dt[MAXE];
    int out_dt;
    int acc_int;  // accumulate in int32 (integer output), else float32
    int out_ext[MAXV];
    int out_dim[MAXV];
    int out_coef[MAXV];
    int out_clip[MAXD];
    int red_ext[MAXV];
    int out_rank;
    int n_out;
    int n_red;
    int n_slot;
    int n_eslot;
    int block_x;  // general: blockDim.x, outputs per block
    int block_k;  // general: blockDim.y, threads splitting one output's reduction
    int fast;     // lhs is exactly "load slot 0" and rhs "load slot 1"
    Prog lhs;
    Prog rhs;
    Prog epi;
    // ---- the GEMM view (path != PATH_GENERAL); index [0] is A, [1] is B
    void* work;                    // scratch: split partials, packed operands
    long long work_part;           // byte offsets into work (-1: none)
    long long work_pack[2];
    long long g_base[2];           // element offset of A, B
    long long g_smn[2];            // A's stride along M, B's along N
    long long g_sk[2];             // their strides along K
    long long g_bstr[MAXV][2];     // per batch variable: A's, B's stride
    long long g_bout[MAXV];        //   the output's
    long long g_bepi[MAXV][MAXE];  //   each epilogue input's
    long long g_omn[2];            // the output's stride along M, N
    long long g_emn[MAXE][2];      // each epilogue input's along M, N
    long long g_nbatch;
    int g_bext[MAXV];              // batch extents, and their output coordinate
    int g_bdim[MAXV];
    int g_bcoef[MAXV];
    int g_mdim[2];                 // output dim of M, N (-1: absent)
    int g_mcoef[2];
    int g_M, g_N, g_K;
    int g_nb;
    int g_a;                       // the slot of A; B is slot 1 - g_a
    int path;
    int splits;                    // K split over CTAs
    int k_split;                   // K per split
    int vec[2];                    // 16-byte cp.async copies of A, B
    int tma_direct[2];             // wgmma: TMA reads the operand in place, K-major
                                   // (1) or, B only, MN-major (2); 0: packed
    int kp[2];                     // wgmma: packed row length (elements)
    int mt;                        // skinny: row tile
    int kv;                        // skinny: B is unit-stride along K
    int defer;                     // sums to scratch, the epilogue in the second pass
};

__device__ __forceinline__ float mac(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ int mac(int a, int b, int acc) { return a * b + acc; }

// ============================================================ general path
// One output element per threadIdx.x, and blockDim.y threads that split
// its reduction (each takes every blockDim.y-th step of reduction variable
// 0; the partial sums meet in shared memory in a fixed order).
// threadIdx.x walks a chunk of the output variable with the smallest
// output stride; blockIdx.x enumerates the other output variables first
// and the chunk index last.  T: accumulator type; FAST: both sides are
// plain loads of types SA, SB (otherwise the prologue programs run).
template <typename T, typename SA, typename SB, bool FAST>
__global__ void contraction_kernel(const __grid_constant__ Params p) {
    __shared__ T part[1024];
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tk = blockDim.y;
    int ov[MAXV];
    long long bid = blockIdx.x;
    for (int i = 1; i < p.n_out; ++i) {
        ov[i] = (int)(bid % p.out_ext[i]);
        bid /= p.out_ext[i];
    }
    const long long v0 = bid * p.block_x + tx;
    bool valid = v0 < (p.n_out > 0 ? p.out_ext[0] : 1);
    ov[0] = valid ? (int)v0 : 0;

    // store only inside the clip
    int coord[MAXD];
    for (int d = 0; d < p.out_rank; ++d) coord[d] = 0;
    for (int i = 0; i < p.n_out; ++i) coord[p.out_dim[i]] += p.out_coef[i] * ov[i];
    for (int d = 0; d < p.out_rank; ++d)
        if (coord[d] >= p.out_clip[d]) valid = false;

    T acc = (T)0;
    if (valid) {
        long long so[MAXS];
        for (int s = 0; s < p.n_slot; ++s) {
            long long o = p.slot_base[s];
            for (int i = 0; i < p.n_out; ++i) o += p.slot_ostride[s][i] * ov[i];
            so[s] = o;
        }
        // reduction variable 0 is the inner loop (split over threadIdx.y);
        // the others step an odometer
        const int inner = p.n_red > 0 ? p.red_ext[0] : 1;
        long long n_outer = 1;
        for (int j = 1; j < p.n_red; ++j) n_outer *= p.red_ext[j];
        int cnt[MAXV];
        for (int j = 0; j < MAXV; ++j) cnt[j] = 0;

        for (long long it = 0; it < n_outer; ++it) {
            if (FAST) {
                const long long sa = p.n_red > 0 ? p.slot_rstride[0][0] : 0;
                const long long sb = p.n_red > 0 ? p.slot_rstride[1][0] : 0;
                const SA* a = (const SA*)p.slot[0] + so[0] + ty * sa;
                const SB* b = (const SB*)p.slot[1] + so[1] + ty * sb;
                for (int k = ty; k < inner; k += tk) {
                    acc = mac(as_t<T>(__ldg(a)), as_t<T>(__ldg(b)), acc);
                    a += sa * tk;
                    b += sb * tk;
                }
            } else {
                long long o[MAXS];
                for (int s = 0; s < p.n_slot; ++s)
                    o[s] = so[s] + (p.n_red > 0 ? ty * p.slot_rstride[s][0] : 0);
                for (int k = ty; k < inner; k += tk) {
                    const T l = eval_prog<T>(p.lhs, p.slot, p.slot_dt, o, ~0u, (T)0, p.consts);
                    const T r = eval_prog<T>(p.rhs, p.slot, p.slot_dt, o, ~0u, (T)0, p.consts);
                    acc = mac(l, r, acc);
                    if (p.n_red > 0)
                        for (int s = 0; s < p.n_slot; ++s) o[s] += p.slot_rstride[s][0] * tk;
                }
            }
            for (int j = 1; j < p.n_red; ++j) {
                ++cnt[j];
                for (int s = 0; s < p.n_slot; ++s) so[s] += p.slot_rstride[s][j];
                if (cnt[j] < p.red_ext[j]) break;
                cnt[j] = 0;
                for (int s = 0; s < p.n_slot; ++s) so[s] -= p.slot_rstride[s][j] * p.red_ext[j];
            }
        }
    }
    if (tk > 1) {
        part[ty * blockDim.x + tx] = acc;
        __syncthreads();
        if (ty != 0) return;
        for (int j = 1; j < tk; ++j) acc += part[j * blockDim.x + tx];
    }
    if (!valid) return;

    T val = p.scale != 1.0 ? acc * (T)p.scale : acc;
    if (p.epi.n > 0) {
        long long eo[MAXE];
        for (int s = 0; s < p.n_eslot; ++s) {
            long long o = p.eslot_base[s];
            for (int i = 0; i < p.n_out; ++i) o += p.eslot_ostride[s][i] * ov[i];
            eo[s] = o;
        }
        val = eval_prog<T>(p.epi, p.eslot, p.eslot_dt, eo, ~0u, val, p.consts);
    }
    long long oo = 0;
    for (int i = 0; i < p.n_out; ++i) oo += p.out_ostride[i] * ov[i];
    store_as(p.out, p.out_dt, oo, val);
}

// ============================================= what the GEMM paths share
// The offsets of one batch entry, and how many of its M rows and N columns
// lie inside the clip.
struct Ctx {
    long long off[2];   // A, B
    long long oo;       // output
    long long eo[MAXE]; // epilogue inputs
    int lim[2];
};

__device__ __forceinline__ Ctx batch_ctx(const Params& p, long long bi) {
    Ctx c;
    c.off[0] = p.g_base[0];
    c.off[1] = p.g_base[1];
    c.oo = 0;
    for (int s = 0; s < p.n_eslot; ++s) c.eo[s] = p.eslot_base[s];
    int coord[MAXD];
    for (int d = 0; d < p.out_rank; ++d) coord[d] = 0;
    for (int i = 0; i < p.g_nb; ++i) {
        const int v = (int)(bi % p.g_bext[i]);
        bi /= p.g_bext[i];
        c.off[0] += p.g_bstr[i][0] * v;
        c.off[1] += p.g_bstr[i][1] * v;
        c.oo += p.g_bout[i] * v;
        for (int s = 0; s < p.n_eslot; ++s) c.eo[s] += p.g_bepi[i][s] * v;
        coord[p.g_bdim[i]] += p.g_bcoef[i] * v;
    }
    bool live = true;
    for (int d = 0; d < p.out_rank; ++d)
        if (d != p.g_mdim[0] && d != p.g_mdim[1] && coord[d] >= p.out_clip[d]) live = false;
    for (int j = 0; j < 2; ++j) {
        int lim = j == 0 ? p.g_M : p.g_N;
        if (p.g_mdim[j] >= 0) {
            const int room = p.out_clip[p.g_mdim[j]] - coord[p.g_mdim[j]];
            lim = min(lim, room <= 0 ? 0 : (room + p.g_mcoef[j] - 1) / p.g_mcoef[j]);
        }
        c.lim[j] = live ? lim : 0;
    }
    return c;
}

// The scale, the epilogue program at (m, n) and the one rounding store.
// Out of line: the tiled paths reach it from 64 unrolled accumulators, and
// an inlined postfix evaluator at each of them multiplies the build time.
template <typename T>
__device__ __noinline__ void finish(const Params& p, const Ctx& c, int m, int n, T acc) {
    T val = p.scale != 1.0 ? acc * (T)p.scale : acc;
    if (p.epi.n > 0) {
        long long eo[MAXE];
        for (int s = 0; s < p.n_eslot; ++s)
            eo[s] = c.eo[s] + p.g_emn[s][0] * m + p.g_emn[s][1] * n;
        val = eval_prog<T>(p.epi, p.eslot, p.eslot_dt, eo, ~0u, val, p.consts);
    }
    store_as(p.out, p.out_dt, c.oo + p.g_omn[0] * m + p.g_omn[1] * n, val);
}

// One finished sum of output (bi, m, n) from K split ``split``: stored
// through the epilogue, or kept as a partial for the finishing pass (a
// split K, or a tiled plan with an epilogue program: there each thread
// would evaluate the program for 64 outputs in a row, one dependent load
// after another, while the finishing pass gives each output a thread).
template <typename T>
__device__ __forceinline__ void emit(const Params& p, const Ctx& c, long long bi, int split,
                                     int m, int n, T acc) {
    if (m >= c.lim[0] || n >= c.lim[1]) return;
    if (p.splits > 1 || p.defer) {
        T* part = (T*)((char*)p.work + p.work_part);
        part[(((long long)split * p.g_nbatch + bi) * p.g_M + m) * p.g_N + n] = acc;
    } else if (p.epi.n == 0) {  // no program: the scale and the store, inline
        store_as(p.out, p.out_dt, c.oo + p.g_omn[0] * m + p.g_omn[1] * n,
                 p.scale != 1.0 ? acc * (T)p.scale : acc);
    } else {
        finish(p, c, m, n, acc);
    }
}

// The second pass of a split K: the partials of each output added in split
// order, then the epilogue.
template <typename T>
__global__ void __launch_bounds__(256) finish_kernel(const __grid_constant__ Params p) {
    const long long plane = p.g_nbatch * p.g_M * p.g_N;
    const T* part = (const T*)((const char*)p.work + p.work_part);
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < plane;
         i += (long long)gridDim.x * blockDim.x) {
        const int n = (int)(i % p.g_N);
        const long long r = i / p.g_N;
        const int m = (int)(r % p.g_M);
        const Ctx c = batch_ctx(p, r / p.g_M);
        if (m >= c.lim[0] || n >= c.lim[1]) continue;
        T acc = part[i];
        for (int s = 1; s < p.splits; ++s) acc += part[s * plane + i];
        finish(p, c, m, n, acc);
    }
}

template <int BYTES> struct Raw;
template <> struct Raw<1> { typedef uint8_t t; typedef unsigned v4; };
template <> struct Raw<2> { typedef uint16_t t; typedef uint2 v4; };
template <> struct Raw<4> { typedef uint32_t t; typedef uint4 v4; };

// four consecutive elements of type S from shared memory, as T
template <typename T, typename S>
__device__ __forceinline__ void ld4(const unsigned char* src, T* o) {
    const typename Raw<sizeof(S)>::v4 v = *(const typename Raw<sizeof(S)>::v4*)src;
    const S* e = (const S*)&v;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = as_t<T>(e[i]);
}

// ============================================================ skinny path
#define SK_THREADS 256
#define SK_STAGES 4

template <typename S, bool KV>
struct SkinnyShape {
    static constexpr int BN = KV ? 32 : 128;  // columns of N per CTA
    static constexpr int BK = KV ? 64 : 32;   // K per stage
    // bytes of one shared-memory row: a K row of the tile (BN columns), or
    // with KV an N row (BK elements, padded by 16 bytes against conflicts)
    static constexpr int ROW = KV ? BK * (int)sizeof(S) + 16 : BN * (int)sizeof(S);
    static constexpr int TILE = (KV ? BN : BK) * ROW;
};

// T: accumulator; S: both operands' type; MT: row tile (>= M); KV: B is
// unit-stride along K (lanes own N rows of the tile; otherwise lanes own 4
// neighbouring N columns and the warps take every 8th K row)
template <typename T, typename S, int MT, bool KV>
__global__ void __launch_bounds__(SK_THREADS) skinny_kernel(const __grid_constant__ Params p) {
    typedef SkinnyShape<S, KV> Sh;
    typedef typename Raw<sizeof(S)>::t R;
    constexpr int ROWS = KV ? Sh::BN : Sh::BK;    // shared rows of a stage
    constexpr int COLS = KV ? Sh::BK : Sh::BN;    // elements per row
    constexpr int VEC = 16 / (int)sizeof(S);      // elements per 16-byte copy
    constexpr int NPT = KV ? 1 : 4;               // N columns per thread
    extern __shared__ __align__(16) unsigned char smem[];
    T* xs = (T*)(smem + SK_STAGES * Sh::TILE);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int n_tiles = (p.g_N + Sh::BN - 1) / Sh::BN;
    long long bid = blockIdx.x;
    const int nt = (int)(bid % n_tiles);
    bid /= n_tiles;
    const int split = (int)(bid % p.splits);
    const long long bi = bid / p.splits;
    const Ctx c = batch_ctx(p, bi);
    const int n0 = nt * Sh::BN;
    const int k0 = split * p.k_split;
    const int kend = min(p.g_K, k0 + p.k_split);
    const int klen = max(kend - k0, 0);
    const int nk = (klen + Sh::BK - 1) / Sh::BK;
    const int kpad = nk * Sh::BK;
    const S* A = (const S*)p.slot[p.g_a] + c.off[0];
    const S* B = (const S*)p.slot[1 - p.g_a] + c.off[1];
    const long long sam = p.g_smn[0], sak = p.g_sk[0], sbn = p.g_smn[1], sbk = p.g_sk[1];
    const bool vec = p.vec[1];

    // stage t of this split's B tile into ring slot t % SK_STAGES
    auto load = [&](int t) {
        unsigned char* dst = smem + (t % SK_STAGES) * Sh::TILE;
        const int kt = k0 + t * Sh::BK;
        if (vec) {
            constexpr int CPR = COLS / VEC;
            for (int ch = tid; ch < ROWS * CPR; ch += SK_THREADS) {
                const int r = ch / CPR, q = ch % CPR;
                const int k = KV ? kt + q * VEC : kt + r;
                const int n = KV ? n0 + r : n0 + q * VEC;
                const int left = KV ? (n < p.g_N ? kend - k : 0) : (k < kend ? p.g_N - n : 0);
                const int bytes = left <= 0 ? 0 : min(left, VEC) * (int)sizeof(S);
                const S* src = bytes ? B + (long long)k * sbk + (long long)n * sbn : B;
                cp_async16(dst + r * Sh::ROW + q * 16, src, bytes);
            }
        } else {
            for (int e = tid; e < ROWS * COLS; e += SK_THREADS) {
                const int r = e / COLS, q = e % COLS;
                const int k = KV ? kt + q : kt + r;
                const int n = KV ? n0 + r : n0 + q;
                R v = 0;
                if (k < kend && n < p.g_N) v = ((const R*)B)[(long long)k * sbk + (long long)n * sbn];
                ((R*)(dst + r * Sh::ROW))[q] = v;
            }
        }
        cp_commit();
    };

    for (int t = 0; t < SK_STAGES - 1; ++t) {
        if (t < nk) load(t);
        else cp_commit();
    }
    // this split's A rows, as T, while the first B stages are in flight
    for (int e = tid; e < MT * kpad; e += SK_THREADS) {
        const int m = e / kpad, kk = e % kpad;
        T v = (T)0;
        if (m < p.g_M && kk < klen) v = as_t<T>(A[(long long)m * sam + (long long)(k0 + kk) * sak]);
        xs[e] = v;
    }

    T acc[MT][NPT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NPT; ++j) acc[m][j] = (T)0;

    for (int t = 0; t < nk; ++t) {
        cp_wait<SK_STAGES - 2>();
        __syncthreads();
        if (t + SK_STAGES - 1 < nk) load(t + SK_STAGES - 1);
        else cp_commit();
        const unsigned char* tile = smem + (t % SK_STAGES) * Sh::TILE;
        const T* x = xs + t * Sh::BK;
        if constexpr (KV) {
            T w[8];
            const unsigned char* row = tile + lane * Sh::ROW + warp * 8 * (int)sizeof(S);
            ld4<T, S>(row, w);
            ld4<T, S>(row + 4 * sizeof(S), w + 4);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[m][0] = mac(x[m * kpad + warp * 8 + j], w[j], acc[m][0]);
        } else {
#pragma unroll
            for (int i = 0; i < Sh::BK / 8; ++i) {
                const int r = warp + 8 * i;
                T w[4];
                ld4<T, S>(tile + r * Sh::ROW + lane * 4 * (int)sizeof(S), w);
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    const T xv = x[m * kpad + r];
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[m][j] = mac(xv, w[j], acc[m][j]);
                }
            }
        }
    }

    // the 8 warps' sums of each output meet in warp order
    cp_wait<0>();
    __syncthreads();
    T* red = (T*)smem;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NPT; ++j) red[(warp * MT + m) * Sh::BN + lane * NPT + j] = acc[m][j];
    __syncthreads();
    for (int e = tid; e < MT * Sh::BN; e += SK_THREADS) {
        const int m = e / Sh::BN, nl = e % Sh::BN;
        T s = red[e];
        for (int w = 1; w < 8; ++w) s += red[w * MT * Sh::BN + e];
        if (m < p.g_M) emit(p, c, bi, split, m, n0 + nl, s);
    }
}

// ================================================ tiled path, CUDA cores
#define FF_BM 128
#define FF_BK 16
#define FF_LD (FF_BM + 4)  // floats per shared row: [k][m], padded
#define FF_STAGES 3

// One operand's tile (rows [mn0, mn0 + 128) of M or N, K [kt, kt + 16))
// into dst[k][mn] as float32: 16-byte cp.async copies where the operand is
// unit-stride along M/N (``vec``), 4-byte ones otherwise (consecutive
// threads walk K where it is the unit stride); a 16-bit operand by loads
// and converting stores.
template <typename S>
__device__ __forceinline__ void ff_load(float* dst, const S* src, long long s_mn, long long s_k,
                                        int mn0, int ext, int kt, int kend, bool vec, int tid) {
    if constexpr (std::is_same<S, float>::value) {
        if (vec) {
            for (int ch = tid; ch < FF_BK * (FF_BM / 4); ch += 256) {
                const int r = ch / (FF_BM / 4), q = ch % (FF_BM / 4);
                const int k = kt + r, mn = mn0 + q * 4;
                const int left = k < kend ? ext - mn : 0;
                const int bytes = left <= 0 ? 0 : min(left, 4) * 4;
                cp_async16(dst + r * FF_LD + q * 4, bytes ? src + (long long)k * s_k + mn : src, bytes);
            }
            return;
        }
    }
    const bool kfast = s_k == 1;
    for (int e = tid; e < FF_BK * FF_BM; e += 256) {
        const int r = kfast ? e % FF_BK : e / FF_BM;
        const int i = kfast ? e / FF_BK : e % FF_BM;
        const int k = kt + r, mn = mn0 + i;
        const bool ok = k < kend && mn < ext;
        const S* at = src + (long long)k * s_k + (long long)mn * s_mn;
        if constexpr (std::is_same<S, float>::value)
            cp_async4(dst + r * FF_LD + i, ok ? at : src, ok ? 4 : 0);
        else
            dst[r * FF_LD + i] = ok ? as_t<float>(*at) : 0.0f;
    }
}

// A is float32; SB: B's type (float32 or bf16)
template <typename SB>
__global__ void __launch_bounds__(256) ffma_kernel(const __grid_constant__ Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* As = (float*)smem;
    float* Bs = As + FF_STAGES * FF_BK * FF_LD;
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int n_tiles = (p.g_N + FF_BM - 1) / FF_BM, m_tiles = (p.g_M + FF_BM - 1) / FF_BM;
    long long bid = blockIdx.x;
    const int nt = (int)(bid % n_tiles);
    bid /= n_tiles;
    const int mt = (int)(bid % m_tiles);
    bid /= m_tiles;
    const int split = (int)(bid % p.splits);
    const long long bi = bid / p.splits;
    const int m0 = mt * FF_BM, n0 = nt * FF_BM;
    const int k0 = split * p.k_split, kend = min(p.g_K, k0 + p.k_split);
    const int nk = (max(kend - k0, 0) + FF_BK - 1) / FF_BK;
    const float* A;
    const SB* B;
    {
        const Ctx c = batch_ctx(p, bi);
        A = (const float*)p.slot[p.g_a] + c.off[0];
        B = (const SB*)p.slot[1 - p.g_a] + c.off[1];
    }
    auto load = [&](int t) {
        const int s = t % FF_STAGES, kt = k0 + t * FF_BK;
        ff_load<float>(As + s * FF_BK * FF_LD, A, p.g_smn[0], p.g_sk[0], m0, p.g_M, kt, kend, p.vec[0], tid);
        ff_load<SB>(Bs + s * FF_BK * FF_LD, B, p.g_smn[1], p.g_sk[1], n0, p.g_N, kt, kend, p.vec[1], tid);
        cp_commit();
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int t = 0; t < FF_STAGES - 1; ++t) {
        if (t < nk) load(t);
        else cp_commit();
    }
    for (int t = 0; t < nk; ++t) {
        cp_wait<FF_STAGES - 2>();
        __syncthreads();
        if (t + FF_STAGES - 1 < nk) load(t + FF_STAGES - 1);
        else cp_commit();
        const float* a = As + (t % FF_STAGES) * FF_BK * FF_LD;
        const float* b = Bs + (t % FF_STAGES) * FF_BK * FF_LD;
#pragma unroll
        for (int k = 0; k < FF_BK; ++k) {
            const float4 a0 = *(const float4*)(a + k * FF_LD + ty * 4);
            const float4 a1 = *(const float4*)(a + k * FF_LD + 64 + ty * 4);
            const float4 b0 = *(const float4*)(b + k * FF_LD + tx * 4);
            const float4 b1 = *(const float4*)(b + k * FF_LD + 64 + tx * 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
    cp_wait<0>();
    const Ctx c = batch_ctx(p, bi);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            emit(p, c, bi, split, m, n0 + (j >> 2) * 64 + tx * 4 + (j & 3), acc[i][j]);
    }
}

// ============================================== tiled path, tensor cores
#define WG_BM 128
#define WG_BN 128
#define WG_STAGES 4
#define WG_ROW 128                  // bytes of K per stage (the swizzle span)
#define WG_TILE (128 * WG_ROW)      // bytes of one operand's stage
#define WG_THREADS 288              // two consumer warpgroups, one producer warp

// S: both operands' type; T: accumulator (float, or int for int8); BMN: B
// arrives MN-major (two 64-wide TMA boxes of N a stage), else K-major
template <typename S, typename T, bool BMN>
__global__ void __launch_bounds__(WG_THREADS) wgmma_kernel(
        const __grid_constant__ Params p, const __grid_constant__ CUtensorMap ta,
        const __grid_constant__ CUtensorMap tb) {
    constexpr int BK = WG_ROW / (int)sizeof(S);  // K elements per stage
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char* sa = smem;
    unsigned char* sb = smem + WG_STAGES * WG_TILE;
    uint64_t* full = (uint64_t*)(smem + 2 * WG_STAGES * WG_TILE);
    uint64_t* empty = full + WG_STAGES;

    const int n_tiles = (p.g_N + WG_BN - 1) / WG_BN, m_tiles = (p.g_M + WG_BM - 1) / WG_BM;
    long long bid = blockIdx.x;
    const int nt = (int)(bid % n_tiles);
    bid /= n_tiles;
    const int mt = (int)(bid % m_tiles);
    const long long bi = bid / m_tiles;
    const int m0 = mt * WG_BM, n0 = nt * WG_BN;
    const int nk = (p.g_K + BK - 1) / BK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < WG_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 2);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= 256) {  // the producer warp: one lane issues the copies
        if (threadIdx.x == 256) {
            for (int kt = 0; kt < nk; ++kt) {
                const int s = kt % WG_STAGES;
                if (kt >= WG_STAGES) mbar_wait(&empty[s], ((kt / WG_STAGES) - 1) & 1);
                mbar_expect_tx(&full[s], 2 * WG_TILE);
                tma_load3(&ta, sa + s * WG_TILE, &full[s], kt * BK, m0, (int)bi);
                if (BMN) {
                    tma_load3(&tb, sb + s * WG_TILE, &full[s], n0, kt * BK, (int)bi);
                    tma_load3(&tb, sb + s * WG_TILE + WG_TILE / 2, &full[s], n0 + 64, kt * BK,
                              (int)bi);
                } else {
                    tma_load3(&tb, sb + s * WG_TILE, &full[s], kt * BK, n0, (int)bi);
                }
            }
        }
        return;
    }
    const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
    T d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = (T)0;
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        mbar_wait(&full[s], (kt / WG_STAGES) & 1);
        const unsigned char* a = sa + s * WG_TILE + wg * 64 * WG_ROW;
        const unsigned char* b = sb + s * WG_TILE;
        fence_regs(d);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < WG_ROW / 32; ++kk)  // 32 bytes of K: 16 rows of an MN-major B
            Wgmma<S>::template mma<BMN>(d, sw128_desc(a + kk * 32),
                                        BMN ? sw128_mn_desc(b + kk * 16 * WG_ROW)
                                            : sw128_desc(b + kk * 32));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // this stage's products stay in flight; the previous stage's are
        // done, and its slot goes back to the producer
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(d);
        if (kt > 0 && t == 0) mbar_arrive(&empty[(kt - 1) % WG_STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(d);
    const Ctx c = batch_ctx(p, bi);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        int row, col;
        frag_mn(i, t, row, col);
        emit(p, c, bi, 0, m0 + wg * 64 + row, n0 + col, d[i]);
    }
}

// The pack pass: operand j (0: A, 1: B) copied K-major into scratch,
// [batch][rows][kp] with zeros past K, through 32 x 32 shared tiles (reads
// walk the operand's unit-stride dim, writes walk K).  R: its raw type.
template <typename R>
__global__ void __launch_bounds__(256) pack_kernel(const __grid_constant__ Params p, int j) {
    __shared__ R tile[32][33];  // [k][row]
    const int rows = j == 0 ? p.g_M : p.g_N, kp = p.kp[j];
    const int kt_n = (kp + 31) / 32, rt_n = (rows + 31) / 32;
    long long bid = blockIdx.x;
    const int kt = (int)(bid % kt_n);
    bid /= kt_n;
    const int rt = (int)(bid % rt_n);
    long long bi = bid / rt_n;
    const long long b_flat = bi;
    long long base = p.g_base[j];
    for (int i = 0; i < p.g_nb; ++i) {
        base += p.g_bstr[i][j] * (bi % p.g_bext[i]);
        bi /= p.g_bext[i];
    }
    const R* src = (const R*)p.slot[j == 0 ? p.g_a : 1 - p.g_a] + base;
    R* dst = (R*)((char*)p.work + p.work_pack[j]) + b_flat * rows * (long long)kp;
    const long long smn = p.g_smn[j], sk = p.g_sk[j];
    const bool rows_fast = sk != 1;
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    for (int i = ty; i < 32; i += 8) {
        const int r = rt * 32 + (rows_fast ? tx : i), k = kt * 32 + (rows_fast ? i : tx);
        R v = 0;
        if (r < rows && k < p.g_K) v = src[(long long)r * smn + (long long)k * sk];
        if (rows_fast) tile[i][tx] = v;
        else tile[tx][i] = v;
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
        const int r = rt * 32 + i, k = kt * 32 + tx;
        if (r < rows && k < kp) dst[(long long)r * kp + k] = tile[tx][i];
    }
}

// ================================================================ host
template <typename T, typename SA, typename SB, bool FAST>
static void launch_general(const Params& p, long long n_blocks, cudaStream_t st) {
    const dim3 block(p.block_x, p.block_k);
    contraction_kernel<T, SA, SB, FAST><<<(unsigned int)n_blocks, block, 0, st>>>(p);
}

static void general(const Params& p, long long n_blocks, cudaStream_t st) {
    const int a = p.slot_dt[0], b = p.slot_dt[1];
    if (p.fast && !p.acc_int && a == DT_F32 && b == DT_F32)
        launch_general<float, float, float, true>(p, n_blocks, st);
    else if (p.fast && !p.acc_int && a == DT_BF16 && b == DT_BF16)
        launch_general<float, __nv_bfloat16, __nv_bfloat16, true>(p, n_blocks, st);
    else if (p.fast && !p.acc_int && a == DT_F16 && b == DT_F16)
        launch_general<float, __half, __half, true>(p, n_blocks, st);
    else if (p.fast && !p.acc_int && a == DT_F32 && b == DT_BF16)
        launch_general<float, float, __nv_bfloat16, true>(p, n_blocks, st);
    else if (p.fast && !p.acc_int && a == DT_BF16 && b == DT_F32)
        launch_general<float, __nv_bfloat16, float, true>(p, n_blocks, st);
    else if (p.fast && p.acc_int && a == DT_I8 && b == DT_I8)
        launch_general<int, int8_t, int8_t, true>(p, n_blocks, st);
    else if (p.acc_int)
        launch_general<int, int, int, false>(p, n_blocks, st);
    else
        launch_general<float, float, float, false>(p, n_blocks, st);
}

template <typename T, typename S, int MT, bool KV>
static void launch_skinny(const Params& p, long long n_blocks, cudaStream_t st) {
    typedef SkinnyShape<S, KV> Sh;
    const size_t ring = SK_STAGES * Sh::TILE + (size_t)MT * p.k_split * sizeof(T);
    const size_t red = (size_t)8 * MT * Sh::BN * sizeof(T);
    const size_t bytes = ring > red ? ring : red;
    smem_limit(skinny_kernel<T, S, MT, KV>, bytes);
    skinny_kernel<T, S, MT, KV><<<(unsigned int)n_blocks, SK_THREADS, bytes, st>>>(p);
}

template <typename T, typename S, int MT>
static void skinny_layout(const Params& p, long long n_blocks, cudaStream_t st) {
    if (p.kv) launch_skinny<T, S, MT, true>(p, n_blocks, st);
    else launch_skinny<T, S, MT, false>(p, n_blocks, st);
}

template <typename T, typename S>
static void skinny_rows(const Params& p, long long n_blocks, cudaStream_t st) {
    if (p.mt <= 4) skinny_layout<T, S, 4>(p, n_blocks, st);
    else skinny_layout<T, S, 16>(p, n_blocks, st);
}

static int skinny(const Params& p, long long n_blocks, cudaStream_t st) {
    switch (p.slot_dt[p.g_a]) {
        case DT_F32: skinny_rows<float, float>(p, n_blocks, st); return 0;
        case DT_BF16: skinny_rows<float, __nv_bfloat16>(p, n_blocks, st); return 0;
        case DT_F16: skinny_rows<float, __half>(p, n_blocks, st); return 0;
        case DT_I8: skinny_rows<int, int8_t>(p, n_blocks, st); return 0;
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename SB>
static void launch_ffma(const Params& p, long long n_blocks, cudaStream_t st) {
    const size_t bytes = (size_t)2 * FF_STAGES * FF_BK * FF_LD * sizeof(float);
    smem_limit(ffma_kernel<SB>, bytes);
    ffma_kernel<SB><<<(unsigned int)n_blocks, 256, bytes, st>>>(p);
}

static int ffma(const Params& p, long long n_blocks, cudaStream_t st) {
    const int a = p.slot_dt[p.g_a], b = p.slot_dt[1 - p.g_a];
    if (a == DT_F32 && b == DT_F32) launch_ffma<float>(p, n_blocks, st);
    else if (a == DT_F32 && b == DT_BF16) launch_ffma<__nv_bfloat16>(p, n_blocks, st);
    else return (int)cudaErrorInvalidValue;
    return 0;
}

// The TMA map of operand j: a K-major tile of 128 rows by 128 bytes of K,
// coordinates (k, row, batch); or (tma_direct 2) an MN-major box of 64 K
// rows by 128 bytes of N, coordinates (n, k, batch).  128-byte swizzle,
// zeros outside.
static int tensor_map(CUtensorMap* map, const Params& p, int j) {
    const EncodeTiled enc = encoder();
    if (!enc) return ERR_NO_ENCODER;
    const int dt = p.slot_dt[j == 0 ? p.g_a : 1 - p.g_a];
    const int size = dt == DT_I8 ? 1 : 2;
    const uint64_t rows = j == 0 ? p.g_M : p.g_N;
    void* ptr;
    uint64_t k_ext, row_bytes, nbatch;
    if (p.tma_direct[j]) {
        ptr = (char*)p.slot[j == 0 ? p.g_a : 1 - p.g_a] + p.g_base[j] * size;
        k_ext = p.g_K;
        row_bytes = p.g_smn[j] * size;
        nbatch = 1;
    } else {
        ptr = (char*)p.work + p.work_pack[j];
        k_ext = p.kp[j];
        row_bytes = (uint64_t)p.kp[j] * size;
        nbatch = p.g_nbatch;
    }
    cuuint64_t dims[3] = {k_ext, rows, nbatch};
    cuuint64_t strides[2] = {row_bytes, row_bytes * rows};
    cuuint32_t box[3] = {(cuuint32_t)(WG_ROW / size), 128, 1};
    if (p.tma_direct[j] == 2) {
        dims[0] = rows;
        dims[1] = p.g_K;
        strides[0] = p.g_sk[j] * size;
        strides[1] = strides[0] * p.g_K;
        box[1] = WG_ROW / size;
    }
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUtensorMapDataType type = dt == DT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : dt == DT_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_UINT8;
    const CUresult r = enc(map, type, 3, ptr, dims, strides, box, elem,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <typename R>
static void pack(const Params& p, int j, cudaStream_t st) {
    const long long rows = j == 0 ? p.g_M : p.g_N;
    const long long blocks = ((p.kp[j] + 31) / 32) * ((rows + 31) / 32) * p.g_nbatch;
    pack_kernel<R><<<(unsigned int)blocks, 256, 0, st>>>(p, j);
}

template <typename S, typename T, bool BMN>
static int launch_wgmma(const Params& p, long long n_blocks, cudaStream_t st) {
    typedef typename Raw<sizeof(S)>::t R;
    for (int j = 0; j < 2; ++j)
        if (!p.tma_direct[j]) pack<R>(p, j, st);
    alignas(64) CUtensorMap ta, tb;
    int rc = tensor_map(&ta, p, 0);
    if (!rc) rc = tensor_map(&tb, p, 1);
    if (rc) return rc;
    const size_t bytes = 2 * WG_STAGES * WG_TILE + 2 * WG_STAGES * sizeof(uint64_t) + 1024;
    smem_limit(wgmma_kernel<S, T, BMN>, bytes);
    wgmma_kernel<S, T, BMN><<<(unsigned int)n_blocks, WG_THREADS, bytes, st>>>(p, ta, tb);
    return 0;
}

static int wgmma(const Params& p, long long n_blocks, cudaStream_t st) {
    const bool bmn = p.tma_direct[1] == 2;
    switch (p.slot_dt[p.g_a]) {
        case DT_BF16:
            return bmn ? launch_wgmma<__nv_bfloat16, float, true>(p, n_blocks, st)
                       : launch_wgmma<__nv_bfloat16, float, false>(p, n_blocks, st);
        case DT_F16:
            return bmn ? launch_wgmma<__half, float, true>(p, n_blocks, st)
                       : launch_wgmma<__half, float, false>(p, n_blocks, st);
        case DT_I8: return launch_wgmma<int8_t, int, false>(p, n_blocks, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" {

// Launches one fusion group on ``stream`` (its pack passes, the kernel of
// its path and, for a split K or a deferred epilogue, the finishing pass);
// returns 0, or
// cudaGetLastError() / one of the codes above.
int stripe_contraction_launch(const Params* pp, long long n_blocks, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const Params& p = *pp;
    int rc = 0;
    switch (p.path) {
        case PATH_SKINNY: rc = skinny(p, n_blocks, st); break;
        case PATH_FFMA: rc = ffma(p, n_blocks, st); break;
        case PATH_WGMMA: rc = wgmma(p, n_blocks, st); break;
        default: general(p, n_blocks, st);
    }
    if (rc) return rc;
    rc = (int)cudaGetLastError();
    if (rc || p.path == PATH_GENERAL || (p.splits <= 1 && !p.defer)) return rc;
    const long long plane = p.g_nbatch * p.g_M * p.g_N;
    long long blocks = (plane + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    if (p.acc_int) finish_kernel<int><<<(unsigned int)blocks, 256, 0, st>>>(p);
    else finish_kernel<float><<<(unsigned int)blocks, 256, 0, st>>>(p);
    return (int)cudaGetLastError();
}

// Layout of Params as this compiler laid it out, for the binding's check:
// out[0] = sizeof, then the offsets of fields spread over the struct.
void stripe_contraction_layout(long long* out) {
    out[0] = (long long)sizeof(Params);
    out[1] = (long long)offsetof(Params, slot_base);
    out[2] = (long long)offsetof(Params, out_ext);
    out[3] = (long long)offsetof(Params, scale);
    out[4] = (long long)offsetof(Params, lhs);
    out[5] = (long long)offsetof(Params, epi);
    out[6] = (long long)offsetof(Params, work);
    out[7] = (long long)offsetof(Params, g_bepi);
    out[8] = (long long)offsetof(Params, g_nbatch);
    out[9] = (long long)offsetof(Params, g_M);
    out[10] = (long long)offsetof(Params, kv);
    out[11] = (long long)offsetof(Params, defer);
}

}  // extern "C"
