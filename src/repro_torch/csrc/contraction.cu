// One Stripe fusion group as one CUDA kernel: prologue DAGs on the operand
// elements, a float32 contraction, an optional scale, then the epilogue DAG
// (bias, activations, diamond joins, extra tensor inputs) and the store.
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
// summed.  The sequential ("arbitrary") reduction grid axes of the TPU
// kernel, its tile-level reduction and its leaf reduction are all one loop
// inside the thread: CUDA blocks run in no fixed order and share no
// scratch.  The accumulator is a float32 register; the epilogue runs once,
// after the whole reduction; the store writes only inside the clip.
//
// Launch: one output element per threadIdx.x, and blockDim.y threads that
// split its reduction (each takes every blockDim.y-th step of reduction
// variable 0; the partial sums meet in shared memory in a fixed order, so
// results are deterministic).  The split keeps enough loads in flight when
// there are few outputs and long reductions (decode).  threadIdx.x walks a
// chunk of the output variable with the smallest output stride (coalesced
// stores, and coalesced weight loads for a projection); blockIdx.x
// enumerates the other output variables first (the ones the largest
// operand does not depend on lead, so blocks that read the same weight
// columns run side by side and share them through L2) and the chunk index
// last.  The binding merges variables that a tile split apart (an outer
// and an inner variable whose strides compose in every tensor) before the
// launch, so the plan's tile never narrows the thread layout.
//
// What bounds it: at decode (m = 8 rows) every weight is read once per
// step, 4-byte float32 each: one llama3-8b decode step reads ~218 M weight
// elements per layer (872 MB, 27.9 GB over 32 layers), ~8.3 ms at the
// H100 SXM data sheet's 3.35 TB/s.  The kernel is memory-bound there.
//
// What this simple design leaves on the table: no shared-memory staging of
// the operand tiles (a row block of the weights is re-read by each output
// row from L2, and from HBM when the rows run far apart, as in prefill);
// no register tiling (one output per thread, two loads per multiply-add);
// no tensor cores (wgmma) and no TMA; float32 weights (the serving path
// hands bf16 weights over as float32).  Those are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define MAXV 8     // output variables, and reduction variables
#define MAXS 6     // operand slots (distinct leaf loads)
#define MAXE 6     // extra epilogue inputs
#define MAXP 32    // postfix program length
#define MAXC 8     // constants
#define MAXD 8     // output rank
#define MAXSTACK 8 // evaluation stack depth

// op-codes; must match repro_torch/kernels/contraction.py
#define OP_LOAD 0
#define OP_CONST 1
#define OP_ACC 2
#define OP_UNARY 16   // + index into the unary table
#define OP_BINARY 48  // + index into the binary table

struct Prog {
    int n;
    int code[MAXP];
    int arg[MAXP];
};

struct Params {
    float* out;
    const float* slot[MAXS];
    const float* eslot[MAXE];
    long long slot_base[MAXS];
    long long slot_ostride[MAXS][MAXV];
    long long slot_rstride[MAXS][MAXV];
    long long eslot_base[MAXE];
    long long eslot_ostride[MAXE][MAXV];
    long long out_ostride[MAXV];
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
    int block_x;  // blockDim.x: outputs per block
    int block_k;  // blockDim.y: threads splitting one output's reduction
    int fast;     // lhs is exactly "load slot 0" and rhs "load slot 1"
    float scale;
    float consts[MAXC];
    Prog lhs;
    Prog rhs;
    Prog epi;
};

__device__ __forceinline__ float unary_op(int k, float x) {
    switch (k) {
        case 0: return -x;                                        // neg
        case 1: return expf(x);                                   // exp
        case 2: return logf(x);                                   // log
        case 3: return tanhf(x);                                  // tanh
        case 4: return sqrtf(x);                                  // sqrt
        case 5: return rsqrtf(x);                                 // rsqrt
        case 6: return 1.0f / (1.0f + expf(-x));                  // sigmoid
        case 7: return x > 0.0f ? x : 0.0f;                       // relu
        case 8: return fabsf(x);                                  // abs
        case 9: return x * x;                                     // square
        case 10: return erff(x);                                  // erf
        case 11: return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));  // gelu (exact)
        case 12: return x / (1.0f + expf(-x));                    // silu
        case 13: return (float)((x > 0.0f) - (x < 0.0f));         // sign
        case 14: return floorf(x);                                // floor
        default: return x;                                        // cast
    }
}

__device__ __forceinline__ float binary_op(int k, float a, float b) {
    switch (k) {
        case 0: return a + b;          // add
        case 1: return a - b;          // sub
        case 2: return a * b;          // mul
        case 3: return a / b;          // div
        case 4: return fmaxf(a, b);    // max
        case 5: return fminf(a, b);    // min
        default: return powf(a, b);    // pow
    }
}

__device__ float eval_prog(const Prog& pg, const float* const* ptr,
                           const long long* off, float acc,
                           const float* consts) {
    float st[MAXSTACK];
    int sp = 0;
    for (int i = 0; i < pg.n; ++i) {
        const int c = pg.code[i];
        const int a = pg.arg[i];
        if (c == OP_LOAD) {
            st[sp++] = ptr[a][off[a]];
        } else if (c == OP_CONST) {
            st[sp++] = consts[a];
        } else if (c == OP_ACC) {
            st[sp++] = acc;
        } else if (c < OP_BINARY) {
            st[sp - 1] = unary_op(c - OP_UNARY, st[sp - 1]);
        } else {
            const float b = st[--sp];
            st[sp - 1] = binary_op(c - OP_BINARY, st[sp - 1], b);
        }
    }
    return st[sp - 1];
}

template <bool FAST>
__global__ void contraction_kernel(const __grid_constant__ Params p) {
    __shared__ float part[1024];
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

    float acc = 0.0f;
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
                const float* a = p.slot[0] + so[0] + ty * sa;
                const float* b = p.slot[1] + so[1] + ty * sb;
                for (int k = ty; k < inner; k += tk) {
                    acc = fmaf(__ldg(a), __ldg(b), acc);
                    a += sa * tk;
                    b += sb * tk;
                }
            } else {
                long long o[MAXS];
                for (int s = 0; s < p.n_slot; ++s)
                    o[s] = so[s] + (p.n_red > 0 ? ty * p.slot_rstride[s][0] : 0);
                for (int k = ty; k < inner; k += tk) {
                    const float l = eval_prog(p.lhs, p.slot, o, 0.0f, p.consts);
                    const float r = eval_prog(p.rhs, p.slot, o, 0.0f, p.consts);
                    acc = fmaf(l, r, acc);
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

    float val = acc * p.scale;
    if (p.epi.n > 0) {
        long long eo[MAXE];
        for (int s = 0; s < p.n_eslot; ++s) {
            long long o = p.eslot_base[s];
            for (int i = 0; i < p.n_out; ++i) o += p.eslot_ostride[s][i] * ov[i];
            eo[s] = o;
        }
        val = eval_prog(p.epi, p.eslot, eo, val, p.consts);
    }
    long long oo = 0;
    for (int i = 0; i < p.n_out; ++i) oo += p.out_ostride[i] * ov[i];
    p.out[oo] = val;
}

extern "C" {

// Launches one fusion group on ``stream``; returns cudaGetLastError().
int stripe_contraction_launch(const Params* p, long long n_blocks, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const dim3 block(p->block_x, p->block_k);
    if (p->fast)
        contraction_kernel<true><<<(unsigned int)n_blocks, block, 0, st>>>(*p);
    else
        contraction_kernel<false><<<(unsigned int)n_blocks, block, 0, st>>>(*p);
    return (int)cudaGetLastError();
}

// Layout of Params as this compiler laid it out, for the binding's check:
// out[0] = sizeof, then the offsets of a few fields spread over the struct.
void stripe_contraction_layout(long long* out) {
    out[0] = (long long)sizeof(Params);
    out[1] = (long long)offsetof(Params, slot_base);
    out[2] = (long long)offsetof(Params, out_ext);
    out[3] = (long long)offsetof(Params, scale);
    out[4] = (long long)offsetof(Params, lhs);
    out[5] = (long long)offsetof(Params, epi);
}

}  // extern "C"
