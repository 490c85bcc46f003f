// One Stripe windowed unit as CUDA kernels: a convolution over a halo, a
// boundary remainder whose tail the block's constraints mask, or any
// constraint-carrying block, summed over its window and reduction
// variables and stored.
//
// Replaces: src/repro/core/lower_pallas.py::_emit_windowed (with
// _halo_spec, _tile_slice, _contract_sides and step_mask: the
// pl.pallas_call that gathers halo operands on the host, unrolls every
// window position, contracts the two sides, masks constraint-dead points
// and accumulates across the reduction grid steps).
//
// Semantics are Stripe's, as in contraction.cu: every variable of the
// block nest that addresses the output is parallel, every other one (the
// window taps i, j, the contracted channel c, the reduction grid axes) is
// summed.  A term counts where every constraint of the block holds; a read
// whose coordinate lies outside its input reads 0 (the reference's zero
// padding); the accumulator's type is the reference's (float32, or int32
// for an integer output, so the int8 convolution is bit-exact) and the
// store rounds once to the output's type.  No atomics: every sum runs in a
// fixed order, so results are deterministic.
//
// No halo gather.  Every address is affine in the nest's variables, so the
// unit comes in as data (struct WinParams): a table of tracked affine
// quantities, each a constant plus a coefficient per output variable and
// per reduction variable.  They are the element offset of each input, each
// input coordinate that can leave its dimension (x + i - 1 at x = 0), and
// each constraint (live where it is >= 0).  The TPU kernel's host-side pad
// and strided take (halo rows materialised once per block, duplicated by
// the margin) have no counterpart: the card reads the halo from L2.
//
// What bounds it: a convolution of real size (ResNet-50's 3x3 layers:
// 0.92 G multiply-adds over 6.4 MB in bf16) is far above the ridge, so
// operations on the tensor cores bound it, or on the CUDA cores in
// float32.  Two paths (WinParams.path, chosen by the binding's conv view
// before the launch):
//
// igemm.  A plan that multiplies two plain loads is one implicit GEMM,
//   C[m, n] = sum_k A[m, k] B[k, n]: M the output variables only the input
//   reads (batch, x, y), N the one only the filter reads (the output
//   channels), K the inner reduction variable (the input channels c,
//   unit-stride in the input) times the taps (i, j), k = c + kc * tap.
//   128 x 64 output tiles; K in stages of 128 bytes a row (one tap's 64
//   bf16 channels at ResNet's conv2_x, two taps' int8 ones).  Each row of
//   an A stage is gathered by two threads with 16-byte cp.async copies,
//   into the 128-byte swizzle wgmma reads, at addresses from tables the
//   binding computes once per plan (a row's input offset and the bitmask
//   of the taps where its guards hold; each tap's offset).  Where a
//   checked coordinate leaves its dimension or a constraint is dead at
//   that (row, tap) the copy's src-size is 0 and it zero-fills: for a
//   product of two loads that is exactly the masked term (a zero times a
//   finite filter value is 0, and adding 0 changes no sum: bit-exact for
//   int8, exact for finite floats).  The filter is a plain [K, N] matrix
//   (a remainder's columns past the filter's end read zeros: TMA's
//   out-of-bounds fill, a zero-filling copy, or the pack pass's zeros):
//   TMA reads it in place when K is one stride (a 16-bit B N-major,
//   transposed by wgmma as contraction.cu reads W[k, n]; or K-major), else
//   a pack pass copies it K-major first (int8 always: 8-bit wgmma reads
//   K-major only; the filter is 36 KB).  bf16 / f16 run wgmma m64n64k16
//   and int8 m64n64k32 into int32: two warpgroups of 64 rows, a 4-stage
//   ring, every thread gathering A and one thread keeping B's TMA loads
//   ahead by an mbarrier a stage.  Float32 runs the same tiles on the CUDA
//   cores (no TF32: the reference's float32 semantics hold): a 3-stage
//   cp.async ring and 8 x 4 outputs a thread, register-blocked outer
//   products from shared memory (12 16-byte shared loads per 128 FMAs).
//   The epilogue scales, rounds once and stores inside the clip.
//   A CTA's time is mostly latency (its stages run one after another), so
//   where the tiles alone would leave most SMs idle (the boundary strips
//   and corners of a tiled conv) K splits over CTAs and a second pass
//   adds the partials in split order: no atomics, deterministic.  The
//   kernels take a launch record of a few scalars (IgParams), not the
//   plan's 3.4 KB of tables: a launch's fixed cost is most of a small
//   unit's time.
// general.  Every other plan (a side that is not a plain load, a batch
//   variable, an input row not on 16-byte steps, ...): one output point
//   per thread, grid-stride.  A thread sets the tracked quantities from its
//   output point and steps them with an odometer over the reduction
//   variables, one add per quantity per step; reduction variable 0 is the
//   inner loop (the binding picks the largest one that moves no checked
//   coordinate and no constraint), a specialised dot product where the
//   unit multiplies two plain loads.  No shared-memory tiles, no register
//   blocking, no tensor cores.

#include "dag.cuh"
#include "hopper.cuh"

#define MAXV 8    // output variables, and reduction variables
#define MAXS 6    // inputs
#define MAXQ 16   // tracked affine quantities
#define MAXD 8    // output rank

#define IG_BM 128       // output rows (M) of a tile
#define IG_BN 64        // output columns (N) of a tile
#define IG_ROW 128      // bytes of K a row per stage (the swizzle span)
#define IG_THREADS 256
#define IG_MAXT 64      // taps (K / kc): bits of a row's mask
#define IG_STAGES 4     // wgmma ring
#define IG_FSTAGES 3    // float32 ring
#define IG_FLD (IG_ROW / 4 + 4)  // floats of a float32 A row in shared memory, padded
#define IG_FLDB (IG_BN + 4)      // floats of a float32 B row

struct WinParams {
    void* out;
    const void* slot[MAXS];
    // quantity q = q0 + sum_i qo[q][i] * out_var_i + sum_j qr[q][j] * red_var_j:
    //   q in [0, n_slot): the element offset of input q;
    //   then n_chk input coordinates, each valid in [0, chk_hi) for input chk_slot;
    //   then n_cons constraints, each live where q >= 0.
    long long q0[MAXQ];
    long long qo[MAXQ][MAXV];
    long long qr[MAXQ][MAXV];
    long long out_stride[MAXV];
    long long n_points;
    double scale;
    double consts[MAXC];
    int slot_dt[MAXS];
    int chk_slot[MAXQ];
    int chk_hi[MAXQ];
    int out_dt;
    int is_int;   // accumulate in int32 (integer output), else float32
    int n_sides;  // 2: lhs * rhs; 1: lhs alone (one side, or an assign DAG)
    int out_ext[MAXV];
    int out_dim[MAXV];
    int out_coef[MAXV];
    int out_clip[MAXD];
    int red_ext[MAXV];
    int out_rank;
    int n_out;
    int n_red;
    int n_slot;
    int n_chk;
    int n_cons;
    int fast;     // lhs is "load 0", rhs "load 1", and variable 0 moves no check
    Prog lhs;
    Prog rhs;
};

__device__ __forceinline__ float mac(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ int mac(int a, int b, int acc) { return a * b + acc; }

// Adds the quantities' coefficients of reduction variable j, ``times``
// times, to q (a loop the compiler unrolls over MAXQ, so q stays in
// registers).
__device__ __forceinline__ void step(long long* q, const WinParams& p, int n_q, int j,
                                     long long times) {
#pragma unroll
    for (int k = 0; k < MAXQ; ++k)
        if (k < n_q) q[k] += p.qr[k][j] * times;
}

// Whether every constraint holds at q, and which inputs read in range.
__device__ __forceinline__ bool live_at(const long long* q, const WinParams& p, int n_q,
                                        unsigned* valid) {
    bool live = true;
    unsigned v = (1u << p.n_slot) - 1u;
#pragma unroll
    for (int k = 0; k < MAXQ; ++k) {
        if (k >= p.n_slot && k < p.n_slot + p.n_chk) {
            const int c = k - p.n_slot;
            if (q[k] < 0 || q[k] >= p.chk_hi[c]) v &= ~(1u << p.chk_slot[c]);
        } else if (k >= p.n_slot + p.n_chk && k < n_q && q[k] < 0) {
            live = false;
        }
    }
    *valid = v;
    return live;
}

// T: accumulator type.  FAST: the unit multiplies two plain loads, of
// types SA and SB, and reduction variable 0 moves no checked coordinate
// and no constraint: the inner loop over it is then a plain dot product
// whose validity is decided once per step of the other variables.
template <typename T, typename SA, typename SB, bool FAST>
__global__ void windowed_kernel(const __grid_constant__ WinParams p) {
    const int n_q = p.n_slot + p.n_chk + p.n_cons;
    const int inner = p.n_red > 0 ? p.red_ext[0] : 1;
    long long n_outer = 1;
    for (int j = 1; j < p.n_red; ++j) n_outer *= p.red_ext[j];
    const long long step_pts = (long long)gridDim.x * blockDim.x;
    for (long long pt = (long long)blockIdx.x * blockDim.x + threadIdx.x; pt < p.n_points;
         pt += step_pts) {
        int ov[MAXV];
        long long rest = pt;
        for (int i = 0; i < p.n_out; ++i) {
            ov[i] = (int)(rest % p.out_ext[i]);
            rest /= p.out_ext[i];
        }
        int coord[MAXD];
        for (int d = 0; d < p.out_rank; ++d) coord[d] = 0;
        long long oo = 0;
        for (int i = 0; i < p.n_out; ++i) {
            coord[p.out_dim[i]] += p.out_coef[i] * ov[i];
            oo += p.out_stride[i] * ov[i];
        }
        bool inside = true;
        for (int d = 0; d < p.out_rank; ++d)
            if (coord[d] >= p.out_clip[d]) inside = false;
        if (!inside) continue;

        long long q[MAXQ];
#pragma unroll
        for (int k = 0; k < MAXQ; ++k) {
            long long v = 0;
            if (k < n_q) {
                v = p.q0[k];
                for (int i = 0; i < p.n_out; ++i) v += p.qo[k][i] * ov[i];
            }
            q[k] = v;
        }
        int cnt[MAXV];
        for (int j = 0; j < MAXV; ++j) cnt[j] = 0;
        T acc = (T)0;
        for (long long it = 0; it < n_outer; ++it) {
            if constexpr (FAST) {
                unsigned valid;
                if (live_at(q, p, n_q, &valid) && valid == 3u) {
                    const SA* a = (const SA*)p.slot[0] + q[0];
                    const SB* b = (const SB*)p.slot[1] + q[1];
                    const long long sa = p.n_red > 0 ? p.qr[0][0] : 0;
                    const long long sb = p.n_red > 0 ? p.qr[1][0] : 0;
#pragma unroll 4
                    for (int k = 0; k < inner; ++k) {
                        acc = mac(as_t<T>(__ldg(a)), as_t<T>(__ldg(b)), acc);
                        a += sa;
                        b += sb;
                    }
                }
            } else {
                for (int k = 0; k < inner; ++k) {
                    unsigned valid;
                    if (live_at(q, p, n_q, &valid)) {
                        T v = eval_prog<T>(p.lhs, p.slot, p.slot_dt, q, valid, (T)0, p.consts);
                        if (p.n_sides == 2)
                            v = v * eval_prog<T>(p.rhs, p.slot, p.slot_dt, q, valid, (T)0,
                                                 p.consts);
                        acc += v;
                    }
                    if (p.n_red > 0) step(q, p, n_q, 0, 1);
                }
                if (p.n_red > 0) step(q, p, n_q, 0, -inner);
            }
            // odometer over reduction variables 1.., variable 1 fastest
            for (int j = 1; j < p.n_red; ++j) {
                ++cnt[j];
                step(q, p, n_q, j, 1);
                if (cnt[j] < p.red_ext[j]) break;
                cnt[j] = 0;
                step(q, p, n_q, j, -p.red_ext[j]);
            }
        }
        const T val = p.scale != 1.0 ? acc * (T)p.scale : acc;
        store_as(p.out, p.out_dt, oo, val);
    }
}

template <typename T, typename SA, typename SB, bool FAST>
static void launch(const WinParams* p, int n_blocks, int block, cudaStream_t st) {
    windowed_kernel<T, SA, SB, FAST><<<n_blocks, block, 0, st>>>(*p);
}


// ============================================================ igemm path
// The binding computes once per plan and clip (kernels/windowed.py::
// igemm_tables) what the gather reads: a row table, [3][M]: each row's
// input offset at (tap 0, c 0), its output offset at column 0 (-1 outside
// the clip) and the bitmask of the taps where every checked coordinate lies
// inside its input and every constraint is live; a tap table, each tap's
// input offset; and the filter's offset at (k, n = 0) for the pack pass.
// The kernels then take a launch record of a few scalars (IgParams), not
// the plan: a CTA loads its rows' entries and the tap table once, and a K
// chunk costs one division (its tap), one mask test, one shared load and
// one copy.
struct IgParams {
    void* out;
    const void* a;            // the input side's tensor
    const void* b;            // the filter as the kernel reads it: at B[0][0] in place, or packed
    const void* b_src;        // the filter's tensor (the pack pass reads it)
    void* work;               // scratch: the packed filter, then a split K's partials
    const long long* rows;    // [3][M]
    const long long* taps;    // [K / kc]
    const long long* b_rows;  // [K]: the filter's offset at (k, n = 0)
    long long parts;          // byte offset of the partials in work
    long long bsk, bsn;       // B's strides along K and N (elements), as the kernel reads it
    long long b_src_sn;       // the filter tensor's stride along N
    long long out_sn;         // the output's stride along N
    double scale;
    int M, N;
    int nb;                   // columns of B it reads: past them (a remainder) B reads 0
    int K, kc;                // k = c + kc * tap
    int kp;                   // K rounded up to whole stages (a packed K-major row)
    int nlim;                 // columns of N inside the clip
    int splits, ksplit;       // K split over CTAs (ksplit elements each, whole stages)
    int out_dt, dt, is_int;   // output and operand types; accumulate in int32
    int bkmaj, bpack;         // B read K-major (else N-major); B packed into work first
    int mma;                  // wgmma (bf16 / f16 / int8), else float32 on the CUDA cores
};

// One row of an A tile as the two threads that gather it keep it.
struct IgRow {
    long long off;
    unsigned long long live_taps;  // 0 for a row past M: every copy zero-fills
};

// A CTA's prologue: the tap table into shared memory, and row m's gather
// state (and, where oo is given, its output offset) from the row table.
__device__ __forceinline__ IgRow ig_row(const IgParams& p, long long* taps, int n_taps, int m,
                                        long long* oo) {
    for (int t = threadIdx.x; t < n_taps; t += blockDim.x) taps[t] = p.taps[t];
    IgRow r = {0, 0ull};
    if (m < p.M) {
        r.off = p.rows[m];
        r.live_taps = (unsigned long long)p.rows[2 * (long long)p.M + m];
    }
    if (oo) *oo = m < p.M ? p.rows[p.M + m] : -1;
    return r;
}

// The gather of K elements [kf, kf + 16 bytes) of row r: the bytes to copy
// and (through ``src``) the element offset in the input; 0 bytes (a zero
// fill) where K has ended or a guard fails at the chunk's tap.  The 16
// bytes never straddle a tap (the binding takes kc in whole copies).
__device__ __forceinline__ int ig_src(const IgRow& r, const long long* taps, int kf, int K,
                                      int kc, long long& src) {
    if (kf >= K) return 0;
    const int t = kf / kc;
    if (!((r.live_taps >> t) & 1ull)) return 0;
    src = r.off + taps[t] + (kf - t * kc);
    return 16;
}

// A CTA's tile: its first row and column, and the stages of K it sums
// (its split's).
struct IgTile {
    int m0, n0, kt0, nk, split;
};

__device__ __forceinline__ IgTile ig_tile(const IgParams& p, int bk) {
    const int n_tiles = (p.N + IG_BN - 1) / IG_BN;
    int bid = blockIdx.x;
    IgTile t;
    t.split = bid % p.splits;
    bid /= p.splits;
    t.n0 = (bid % n_tiles) * IG_BN;
    t.m0 = (bid / n_tiles) * IG_BM;
    const int k0 = t.split * p.ksplit, k1 = min(p.K, k0 + p.ksplit);
    t.kt0 = k0 / bk;
    t.nk = k1 > k0 ? (k1 - k0 + bk - 1) / bk : 0;
    return t;
}

// The scale and the one rounding store of output (row at oo, column n),
// inside the clip.
template <typename T>
__device__ __forceinline__ void ig_store(const IgParams& p, long long oo, int n, T acc) {
    if (oo < 0 || n >= p.nlim) return;
    store_as(p.out, p.out_dt, oo + p.out_sn * n, p.scale != 1.0 ? acc * (T)p.scale : acc);
}

// One finished sum of tile row r, column n: stored, or (K split over CTAs)
// kept as the split's partial for the finishing pass.
template <typename T>
__device__ __forceinline__ void ig_emit(const IgParams& p, const IgTile& tl, long long oo, int r,
                                        int n, T acc) {
    if (p.splits == 1) {
        ig_store(p, oo, n, acc);
        return;
    }
    const int m = tl.m0 + r;
    if (m >= p.M || n >= p.N) return;
    T* part = (T*)((char*)p.work + p.parts);
    part[((long long)tl.split * p.M + m) * p.N + n] = acc;
}

// The second pass of a split K: each output's partials added in split
// order, then the scale and the store.
template <typename T>
__global__ void __launch_bounds__(256) igemm_finish_kernel(const __grid_constant__ IgParams p) {
    const long long plane = (long long)p.M * p.N;
    const T* part = (const T*)((const char*)p.work + p.parts);
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < plane;
         e += (long long)gridDim.x * blockDim.x) {
        const int m = (int)(e / p.N), n = (int)(e % p.N);
        T acc = part[e];
        for (int s = 1; s < p.splits; ++s) acc += part[s * plane + e];
        ig_store(p, p.rows[p.M + m], n, acc);
    }
}

// S: both operands' type; T: accumulator (float, or int for int8); BMN: B
// arrives N-major (read transposed by wgmma), else K-major.
template <typename S, typename T, bool BMN>
__global__ void __launch_bounds__(IG_THREADS) igemm_wgmma_kernel(
        const __grid_constant__ IgParams p, const __grid_constant__ CUtensorMap tb) {
    constexpr int BK = IG_ROW / (int)sizeof(S);  // K elements a stage
    constexpr int VEC = 16 / (int)sizeof(S);     // elements a copy
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char* sa = smem;                                  // [stage][BM rows][128 B]
    unsigned char* sb = sa + IG_STAGES * IG_BM * IG_ROW;       // [stage][64 rows][128 B]
    long long* row_oo = (long long*)(sb + IG_STAGES * IG_BN * IG_ROW);
    long long* taps = row_oo + IG_BM;
    uint64_t* full = (uint64_t*)(taps + IG_MAXT);

    const int tid = threadIdx.x;
    const int K = p.K, kc = p.kc;
    const IgTile tl = ig_tile(p, BK);
    const int n0 = tl.n0, kt0 = tl.kt0, nk = tl.nk;
    // two threads a row, four 16-byte copies each a stage
    const int rl = tid >> 1, half = tid & 1;
    const IgRow row = ig_row(p, taps, K / kc, tl.m0 + rl, half == 0 ? &row_oo[rl] : nullptr);
    if (tid == 0) {
        for (int s = 0; s < IG_STAGES; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const S* A = (const S*)p.a;

    auto load = [&](int kt) {
        const int s = kt % IG_STAGES;
        unsigned char* dst = sa + (s * IG_BM + rl) * IG_ROW;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int ch = half * 4 + q;
            long long off = 0;
            const int bytes = ig_src(row, taps, (kt0 + kt) * BK + ch * VEC, K, kc, off);
            cp_async16(dst + ((ch ^ (rl & 7)) << 4), bytes ? A + off : A, bytes);
        }
        cp_commit();
        if (tid == 0) {
            unsigned char* bd = sb + s * IG_BN * IG_ROW;
            mbar_expect_tx(&full[s], IG_BN * IG_ROW);
            if (BMN) tma_load3(&tb, bd, &full[s], n0, (kt0 + kt) * BK, 0);
            else tma_load3(&tb, bd, &full[s], (kt0 + kt) * BK, n0, 0);
        }
    };
    for (int s = 0; s < IG_STAGES - 1; ++s) {
        if (s < nk) load(s);
        else cp_commit();
    }

    const int wg = tid >> 7, t = tid & 127;
    T d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = (T)0;
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % IG_STAGES;
        cp_wait<IG_STAGES - 2>();
        fence_async_smem();
        mbar_wait(&full[s], (kt / IG_STAGES) & 1);
        // every thread's copies of stage kt have landed, and every
        // warpgroup is done with the slot the next load refills
        __syncthreads();
        if (kt + IG_STAGES - 1 < nk) load(kt + IG_STAGES - 1);
        else cp_commit();
        const unsigned char* a = sa + (s * IG_BM + wg * 64) * IG_ROW;
        const unsigned char* b = sb + s * IG_BN * IG_ROW;
        fence_regs<32>(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < IG_ROW / 32; ++kk)  // 32 bytes of K: 16 rows of an N-major B
            Wgmma<S, 64>::template mma<BMN>(d, sw128_desc(a + kk * 32),
                                            BMN ? sw128_mn_desc(b + kk * 16 * IG_ROW)
                                                : sw128_desc(b + kk * 32));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(d);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        int r, c;
        frag_mn(i, t, r, c);
        ig_emit(p, tl, row_oo[wg * 64 + r], wg * 64 + r, n0 + c, d[i]);
    }
}

// Float32 on the CUDA cores: the same 128 x 64 tiles, K in stages of 32
// (A [row][k] and B [k][n] in shared memory, both filled by 16-byte
// cp.async copies), each thread 8 rows (16 apart) x 4 neighbouring columns.
__global__ void __launch_bounds__(IG_THREADS) igemm_ffma_kernel(const __grid_constant__ IgParams p) {
    constexpr int BK = IG_ROW / 4;
    extern __shared__ float4 ig_smem4[];
    float* As = (float*)ig_smem4;                      // [stage][BM][IG_FLD]
    float* Bs = As + IG_FSTAGES * IG_BM * IG_FLD;      // [stage][BK][IG_FLDB]
    long long* row_oo = (long long*)(Bs + IG_FSTAGES * BK * IG_FLDB);
    long long* taps = row_oo + IG_BM;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int K = p.K, kc = p.kc, nb = p.nb;
    const long long bsk = p.bsk;
    const IgTile tl = ig_tile(p, BK);
    const int n0 = tl.n0, kt0 = tl.kt0, nk = tl.nk;
    const int rl = tid >> 1, half = tid & 1;
    const IgRow row = ig_row(p, taps, K / kc, tl.m0 + rl, half == 0 ? &row_oo[rl] : nullptr);
    __syncthreads();
    const float* A = (const float*)p.a;
    const float* B = (const float*)p.b;

    auto load = [&](int kt) {
        const int s = kt % IG_FSTAGES;
        float* dst = As + (s * IG_BM + rl) * IG_FLD;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int ch = half * 4 + q;
            long long off = 0;
            const int bytes = ig_src(row, taps, (kt0 + kt) * BK + ch * 4, K, kc, off);
            cp_async16(dst + ch * 4, bytes ? A + off : A, bytes);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int e = tid + u * IG_THREADS, kr = e >> 4, c4 = e & 15;
            const int kf = (kt0 + kt) * BK + kr, n = n0 + c4 * 4;
            const int left = kf < K ? nb - n : 0;
            const int bytes = left <= 0 ? 0 : min(left, 4) * 4;
            cp_async16(Bs + (s * BK + kr) * IG_FLDB + c4 * 4, bytes ? B + kf * bsk + n : B, bytes);
        }
        cp_commit();
    };
    for (int s = 0; s < IG_FSTAGES - 1; ++s) {
        if (s < nk) load(s);
        else cp_commit();
    }
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
        cp_wait<IG_FSTAGES - 2>();
        __syncthreads();
        if (kt + IG_FSTAGES - 1 < nk) load(kt + IG_FSTAGES - 1);
        else cp_commit();
        const float* a = As + (kt % IG_FSTAGES) * IG_BM * IG_FLD;
        const float* b = Bs + (kt % IG_FSTAGES) * BK * IG_FLDB;
#pragma unroll
        for (int k4 = 0; k4 < BK / 4; ++k4) {
            float4 av[8], bv[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) av[i] = *(const float4*)(a + (i * 16 + ty) * IG_FLD + k4 * 4);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) bv[kk] = *(const float4*)(b + (k4 * 4 + kk) * IG_FLDB + tx * 4);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float ak[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    acc[i][0] = fmaf(ak[kk], bv[kk].x, acc[i][0]);
                    acc[i][1] = fmaf(ak[kk], bv[kk].y, acc[i][1]);
                    acc[i][2] = fmaf(ak[kk], bv[kk].z, acc[i][2]);
                    acc[i][3] = fmaf(ak[kk], bv[kk].w, acc[i][3]);
                }
            }
        }
    }
    cp_wait<0>();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const long long oo = row_oo[i * 16 + ty];
#pragma unroll
        for (int j = 0; j < 4; ++j) ig_emit(p, tl, oo, i * 16 + ty, n0 + tx * 4 + j, acc[i][j]);
    }
}

// The pack pass: the filter B[k][n] copied into work, K-major [N][bsn]
// (for wgmma) or N-major [K][bsk] (float32), zeros past K and past its nb
// columns.  R: its raw type.
template <typename R>
__global__ void __launch_bounds__(256) igemm_pack_kernel(const __grid_constant__ IgParams p) {
    const R* src = (const R*)p.b_src;
    R* dst = (R*)p.work;
    const long long cols = p.bkmaj ? p.bsn : p.bsk;
    const long long total = (p.bkmaj ? p.N : p.K) * cols;
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
        const int r = (int)(e / cols), q = (int)(e % cols);
        const int n = p.bkmaj ? r : q, kf = p.bkmaj ? q : r;
        dst[e] = n < p.nb && kf < p.K ? src[p.b_rows[kf] + p.b_src_sn * n] : (R)0;
    }
}

template <typename R>
static void ig_pack(const IgParams& p, cudaStream_t st) {
    const long long total = p.bkmaj ? (long long)p.N * p.bsn : (long long)p.K * p.bsk;
    long long blocks = (total + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    igemm_pack_kernel<R><<<(unsigned int)blocks, 256, 0, st>>>(p);
}

// B's TMA map: a box of 128 bytes of K by 64 rows of N (K-major), or of 64
// columns of N by 128 bytes' worth of K rows (N-major).
static int ig_map(CUtensorMap* map, const IgParams& p, int size) {
    const CUtensorMapDataType type = p.dt == DT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : p.dt == DT_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                      : CU_TENSOR_MAP_DATA_TYPE_UINT8;
    cuuint64_t dims[3], strides[2];
    cuuint32_t box[3] = {(cuuint32_t)(IG_ROW / size), IG_BN, 1};
    if (p.bkmaj) {
        dims[0] = p.bpack ? p.kp : p.K;
        dims[1] = p.bpack ? p.N : p.nb;
        strides[0] = p.bsn * size;
    } else {
        dims[0] = p.nb;
        dims[1] = p.K;
        strides[0] = p.bsk * size;
        box[0] = IG_BN;
        box[1] = IG_ROW / size;
    }
    dims[2] = 1;
    strides[1] = strides[0] * dims[1];
    return tensor_map3(map, type, p.b, dims, strides, box);
}

template <typename S, typename T, bool BMN>
static int ig_wgmma(const IgParams& p, int n_blocks, cudaStream_t st) {
    alignas(64) CUtensorMap tb;
    const int rc = ig_map(&tb, p, (int)sizeof(S));
    if (rc) return rc;
    const size_t bytes = IG_STAGES * (IG_BM + IG_BN) * IG_ROW +
                         (IG_BM + IG_MAXT) * sizeof(long long) + IG_STAGES * sizeof(uint64_t) + 1024;
    smem_limit(igemm_wgmma_kernel<S, T, BMN>, bytes);
    igemm_wgmma_kernel<S, T, BMN><<<n_blocks, IG_THREADS, bytes, st>>>(p, tb);
    return 0;
}

static int igemm(const IgParams& p, int n_blocks, cudaStream_t st) {
    if (p.bpack) {
        if (p.dt == DT_F32) ig_pack<uint32_t>(p, st);
        else if (p.dt == DT_I8) ig_pack<uint8_t>(p, st);
        else ig_pack<uint16_t>(p, st);
    }
    if (!p.mma) {
        if (p.dt != DT_F32) return (int)cudaErrorInvalidValue;
        const size_t bytes = (size_t)IG_FSTAGES * (IG_BM * IG_FLD + (IG_ROW / 4) * IG_FLDB) * 4 +
                             (IG_BM + IG_MAXT) * sizeof(long long);
        smem_limit(igemm_ffma_kernel, bytes);
        igemm_ffma_kernel<<<n_blocks, IG_THREADS, bytes, st>>>(p);
        return 0;
    }
    switch (p.dt) {
        case DT_BF16:
            return p.bkmaj ? ig_wgmma<__nv_bfloat16, float, false>(p, n_blocks, st)
                           : ig_wgmma<__nv_bfloat16, float, true>(p, n_blocks, st);
        case DT_F16:
            return p.bkmaj ? ig_wgmma<__half, float, false>(p, n_blocks, st)
                           : ig_wgmma<__half, float, true>(p, n_blocks, st);
        case DT_I8:
            return p.bkmaj ? ig_wgmma<int8_t, int, false>(p, n_blocks, st)
                           : (int)cudaErrorInvalidValue;
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" {

// Launches one windowed unit on ``stream`` through the general loop,
// ``block`` threads a block; returns cudaGetLastError().
int stripe_windowed_launch(const WinParams* p, int n_blocks, int block, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int a = p->slot_dt[0], b = p->slot_dt[1];
    if (p->fast && !p->is_int && a == DT_F32 && b == DT_F32)
        launch<float, float, float, true>(p, n_blocks, block, st);
    else if (p->fast && !p->is_int && a == DT_BF16 && b == DT_BF16)
        launch<float, __nv_bfloat16, __nv_bfloat16, true>(p, n_blocks, block, st);
    else if (p->fast && !p->is_int && a == DT_F16 && b == DT_F16)
        launch<float, __half, __half, true>(p, n_blocks, block, st);
    else if (p->fast && p->is_int && a == DT_I8 && b == DT_I8)
        launch<int, int8_t, int8_t, true>(p, n_blocks, block, st);
    else if (p->is_int)
        launch<int, int, int, false>(p, n_blocks, block, st);
    else
        launch<float, float, float, false>(p, n_blocks, block, st);
    return (int)cudaGetLastError();
}

// Launches one windowed unit on ``stream`` through the igemm path: the
// filter's pack pass where it has one, the kernel, and for a split K the
// finishing pass.  Returns 0, cudaGetLastError() or an error code of
// hopper.cuh.
int stripe_windowed_igemm(const IgParams* p, int n_blocks, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    int rc = igemm(*p, n_blocks, st);
    if (!rc) rc = (int)cudaGetLastError();
    if (rc || p->splits == 1) return rc;
    long long blocks = ((long long)p->M * p->N + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    if (p->is_int) igemm_finish_kernel<int><<<(unsigned int)blocks, 256, 0, st>>>(*p);
    else igemm_finish_kernel<float><<<(unsigned int)blocks, 256, 0, st>>>(*p);
    return (int)cudaGetLastError();
}

// Layout of IgParams as this compiler laid it out, for the binding's check.
void stripe_windowed_ig_layout(long long* out) {
    out[0] = (long long)sizeof(IgParams);
    out[1] = (long long)offsetof(IgParams, parts);
    out[2] = (long long)offsetof(IgParams, scale);
    out[3] = (long long)offsetof(IgParams, M);
    out[4] = (long long)offsetof(IgParams, out_dt);
    out[5] = (long long)offsetof(IgParams, mma);
}

// Layout of WinParams as this compiler laid it out, for the binding's check.
void stripe_windowed_layout(long long* out) {
    out[0] = (long long)sizeof(WinParams);
    out[1] = (long long)offsetof(WinParams, qr);
    out[2] = (long long)offsetof(WinParams, scale);
    out[3] = (long long)offsetof(WinParams, chk_hi);
    out[4] = (long long)offsetof(WinParams, out_rank);
    out[5] = (long long)offsetof(WinParams, rhs);
}

}  // extern "C"
