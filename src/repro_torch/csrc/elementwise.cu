// One Stripe elementwise unit as one CUDA kernel: the unit's DAG (an
// activation, a bias add, a gate, a join of several tensors) evaluated at
// every point of the output region and stored.
//
// Replaces: src/repro/core/lower_pallas.py::_emit_elementwise (the
// pl.pallas_call of one elementwise block on the TPU: the DAG on the input
// tiles, broadcast to the output block).
//
// The unit comes in as data: the output's index variables with their
// extents and the output dimension each addresses, an element stride per
// variable for every input (0 where the input lacks the variable: that is
// how an input of lower rank broadcasts), the clip of the output region,
// and the DAG as a postfix program.  Evaluation type: float32 for a float
// output, int32 for an integer one, rounded once at the store (dag.cuh
// says how that relates to the reference's _eval_tnode, which evaluates in
// the output's type).
//
// What bounds it: bytes.  A map reads each input element once and writes
// each output element once, a handful of operations per element: at the
// H100 SXM data sheet's 3.35 TB/s and 67 TFLOP/s float32 it sits far below
// the ridge.  Two paths (kernels/elementwise.py::vec_view picks one):
//
// * vec (elementwise_vec_kernel).  Variable 0 is unit-stride in the output
//   and unit-stride or broadcast in every input, its extent a multiple of
//   8, every other stride and base of an input read as vectors (one not
//   broadcast) a multiple of 8 and the input 16-byte aligned, the clip
//   cutting no vector and the program at most 4 deep.
//   A thread-step owns one vector, 8 consecutive points of one row: one
//   magic-number divmod per variable and one set of offsets per vector,
//   every load issued before any arithmetic as whole 16-byte vectors (8
//   bytes for int8; a broadcast input one scalar), the type switch once
//   per input per vector.  The postfix program runs once per vector: each
//   instruction is one word naming its stack slots (the binding simulates
//   the stack, whose depth after each instruction does not depend on the
//   data), the slots are T r[4][8] reached only through a warp-uniform
//   switch on the slot number, so every index is a constant and the stack
//   lives in registers; the op's switch runs once per vector.  The store
//   rounds once to the output type, one 16-byte vector for bf16 / f16,
//   two for float32 / int32, 8 bytes for int8; the clip test runs once
//   per vector, and not at all when the clip is the whole region.  One
//   vector a thread (~64 bytes of loads in flight, 256-thread blocks, two
//   an SM at these register counts) already keeps ~32 KB an SM in flight.
// * general (elementwise_kernel), any other plan: one thread per output
//   point in a grid-stride loop, the odometer's divmod per variable per
//   point, and the DAG by dag.cuh's eval_prog, whose stack is indexed at
//   run time.  Variable 0 is the output variable with the smallest output
//   stride, so neighbouring threads store to neighbouring addresses; the
//   binding merges the variables a tile split apart first.

#include "dag.cuh"

#define MAXV 8   // output variables
#define MAXE 6   // inputs
#define MAXD 8   // output rank

struct EwParams {
    void* out;
    const void* in[MAXE];
    long long in_base[MAXE];
    long long in_stride[MAXE][MAXV];
    long long out_stride[MAXV];
    long long n_points;
    double consts[MAXC];
    int in_dt[MAXE];
    int out_dt;
    int is_int;  // evaluate in int32 (integer output), else float32
    int ext[MAXV];
    int out_dim[MAXV];
    int out_coef[MAXV];
    int out_clip[MAXD];
    int out_rank;
    int n_var;
    int n_in;
    Prog prog;
};

// T: evaluation type; I: the type of the point index (32-bit division
// where the region has fewer than 2**32 points: the odometer divides once
// per variable per point)
template <typename T, typename I>
__global__ void elementwise_kernel(const __grid_constant__ EwParams p) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long pt = (long long)blockIdx.x * blockDim.x + threadIdx.x; pt < p.n_points;
         pt += step) {
        I rest = (I)pt;
        int coord[MAXD];
        for (int d = 0; d < p.out_rank; ++d) coord[d] = 0;
        long long off[MAXE];
        for (int s = 0; s < p.n_in; ++s) off[s] = p.in_base[s];
        long long oo = 0;
        for (int i = 0; i < p.n_var; ++i) {
            const I e = (I)p.ext[i];
            const int v = (int)(rest % e);
            rest /= e;
            coord[p.out_dim[i]] += p.out_coef[i] * v;
            oo += p.out_stride[i] * v;
            for (int s = 0; s < p.n_in; ++s) off[s] += p.in_stride[s][i] * v;
        }
        bool inside = true;
        for (int d = 0; d < p.out_rank; ++d)
            if (coord[d] >= p.out_clip[d]) inside = false;
        if (!inside) continue;
        const T val = eval_prog<T>(p.prog, p.in, p.in_dt, off, ~0u, (T)0, p.consts);
        store_as(p.out, p.out_dt, oo, val);
    }
}

// ------------------------------------------------------------ the vec path
#define VW 8           // points of a vector
#define VSLOT 4        // stack slots, in registers
#define VEC_BLOCK 256  // threads a block

// A postfix instruction as one word: op-code, argument, and the stack
// slots it writes (dst) and reads (a, b; 7 for none).
#define INS_CODE(w) ((w) & 0xff)
#define INS_ARG(w) (((w) >> 8) & 0xff)
#define INS_DST(w) (((w) >> 16) & 0x7)
#define INS_A(w) (((w) >> 20) & 0x7)
#define INS_B(w) (((w) >> 24) & 0x7)

struct VecParams {
    void* out;
    const void* in[MAXE];
    long long in_base[MAXE];
    long long n_vec;                // vectors: points / 8, below 2**31
    double consts[MAXC];
    int in_stride[MAXE][MAXV];      // elements; variable 0: 1 or 0
    int out_stride[MAXV];           // variable 0: 1
    unsigned div_mul[MAXV];  // n / div[i] == (n * div_mul[i]) >> div_shr[i], n < 2**31
    int div_shr[MAXV];
    int div[MAXV];           // variable 0: its extent / 8 (vectors a row); then extents
    int clip_coef[MAXD][MAXV];  // coefficient of variable i in output dimension d
    int out_clip[MAXD];
    int in_dt[MAXE];
    int in_bcast[MAXE];      // stride 0 along variable 0: one scalar a vector
    int out_dt;
    int n_in;
    int n_var;
    int out_rank;
    int clipped;             // 0: every point of the region lies inside the clip
    int n;                   // program length
    int ins[MAXP];           // the program, one word an instruction (INS_*)
};

__device__ __forceinline__ unsigned fast_div(unsigned n, unsigned mul, int shr) {
    return (unsigned)(((unsigned long long)n * mul) >> shr);
}

// The VW raw 32-bit words of one input's vector: 8 float32 / int32 in two
// 16-byte loads, 8 bf16 / f16 in one, 8 int8 in 8 bytes; a broadcast input
// reads its one element into w[0].
__device__ __forceinline__ void vec_load(const void* base, int dt, int bcast, long long off,
                                         uint32_t (&w)[VW]) {
    if (bcast) {
        switch (dt) {
            case DT_BF16:
            case DT_F16: w[0] = __ldg((const unsigned short*)base + off); break;
            case DT_I8: w[0] = (uint32_t)(uint8_t)__ldg((const signed char*)base + off); break;
            default: w[0] = __ldg((const unsigned*)base + off);
        }
        return;
    }
    switch (dt) {
        case DT_BF16:
        case DT_F16: {
            const uint4 x = __ldg((const uint4*)((const unsigned short*)base + off));
            w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
            break;
        }
        case DT_I8: {
            const uint2 x = __ldg((const uint2*)((const signed char*)base + off));
            w[0] = x.x; w[1] = x.y;
            break;
        }
        default: {
            const uint4* ptr = (const uint4*)((const unsigned*)base + off);
            const uint4 x = __ldg(ptr), y = __ldg(ptr + 1);
            w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
            w[4] = y.x; w[5] = y.y; w[6] = y.z; w[7] = y.w;
        }
    }
}

// element j of a vector of type DT held in raw words, as T
template <typename T, int DT>
__device__ __forceinline__ T vec_elem(const uint32_t (&w)[VW], int j) {
    if constexpr (DT == DT_BF16) {
        __nv_bfloat16_raw r;
        r.x = (unsigned short)(w[j >> 1] >> (16 * (j & 1)));
        return as_t<T>(__nv_bfloat16(r));
    } else if constexpr (DT == DT_F16) {
        __half_raw r;
        r.x = (unsigned short)(w[j >> 1] >> (16 * (j & 1)));
        return as_t<T>(__half(r));
    } else if constexpr (DT == DT_I8) {
        return as_t<T>((int8_t)(w[j >> 2] >> (8 * (j & 3))));
    } else if constexpr (DT == DT_I32) {
        return as_t<T>((int)w[j]);
    } else {
        return as_t<T>(__uint_as_float(w[j]));
    }
}

template <typename T, int DT>
__device__ __forceinline__ void vec_convert(const uint32_t (&w)[VW], int bcast, T (&x)[VW]) {
    if (bcast) {
        const T v = vec_elem<T, DT>(w, 0);
#pragma unroll
        for (int j = 0; j < VW; ++j) x[j] = v;
    } else {
#pragma unroll
        for (int j = 0; j < VW; ++j) x[j] = vec_elem<T, DT>(w, j);
    }
}

// one input's vector as T: the type switch once per vector
template <typename T>
__device__ __forceinline__ void vec_as(const uint32_t (&w)[VW], int dt, int bcast, T (&x)[VW]) {
    switch (dt) {
        case DT_BF16: vec_convert<T, DT_BF16>(w, bcast, x); break;
        case DT_F16: vec_convert<T, DT_F16>(w, bcast, x); break;
        case DT_I8: vec_convert<T, DT_I8>(w, bcast, x); break;
        case DT_I32: vec_convert<T, DT_I32>(w, bcast, x); break;
        default: vec_convert<T, DT_F32>(w, bcast, x);
    }
}

// slot k of the register stack, with k warp-uniform: a switch, so every
// index into r is a constant
template <typename T>
__device__ __forceinline__ void copy_lanes(T (&dst)[VW], const T (&src)[VW]) {
#pragma unroll
    for (int j = 0; j < VW; ++j) dst[j] = src[j];
}

template <typename T>
__device__ __forceinline__ void slot_get(const T (&r)[VSLOT][VW], int k, T (&x)[VW]) {
    switch (k) {
        case 0: copy_lanes(x, r[0]); break;
        case 1: copy_lanes(x, r[1]); break;
        case 2: copy_lanes(x, r[2]); break;
        default: copy_lanes(x, r[3]);
    }
}

template <typename T>
__device__ __forceinline__ void slot_put(T (&r)[VSLOT][VW], int k, const T (&x)[VW]) {
    switch (k) {
        case 0: copy_lanes(r[0], x); break;
        case 1: copy_lanes(r[1], x); break;
        case 2: copy_lanes(r[2], x); break;
        default: copy_lanes(r[3], x);
    }
}

// dag.cuh's op tables over a vector: the op's switch once, its k a
// constant in each case
template <int K, typename T>
__device__ __forceinline__ void vec_unary_k(T (&x)[VW]) {
#pragma unroll
    for (int j = 0; j < VW; ++j) x[j] = unary_op(K, x[j]);
}

template <int K, typename T>
__device__ __forceinline__ void vec_binary_k(T (&x)[VW], const T (&y)[VW]) {
#pragma unroll
    for (int j = 0; j < VW; ++j) x[j] = binary_op(K, x[j], y[j]);
}

template <typename T>
__device__ __forceinline__ void vec_unary(int k, T (&x)[VW]) {
    switch (k) {
        case 0: vec_unary_k<0>(x); break;
        case 1: vec_unary_k<1>(x); break;
        case 2: vec_unary_k<2>(x); break;
        case 3: vec_unary_k<3>(x); break;
        case 4: vec_unary_k<4>(x); break;
        case 5: vec_unary_k<5>(x); break;
        case 6: vec_unary_k<6>(x); break;
        case 7: vec_unary_k<7>(x); break;
        case 8: vec_unary_k<8>(x); break;
        case 9: vec_unary_k<9>(x); break;
        case 10: vec_unary_k<10>(x); break;
        case 11: vec_unary_k<11>(x); break;
        case 12: vec_unary_k<12>(x); break;
        case 13: vec_unary_k<13>(x); break;
        case 14: vec_unary_k<14>(x); break;
        default: vec_unary_k<15>(x);
    }
}

template <typename T>
__device__ __forceinline__ void vec_binary(int k, T (&x)[VW], const T (&y)[VW]) {
    switch (k) {
        case 0: vec_binary_k<0>(x, y); break;
        case 1: vec_binary_k<1>(x, y); break;
        case 2: vec_binary_k<2>(x, y); break;
        case 3: vec_binary_k<3>(x, y); break;
        case 4: vec_binary_k<4>(x, y); break;
        case 5: vec_binary_k<5>(x, y); break;
        default: vec_binary_k<6>(x, y);
    }
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(int v) { return (float)v; }
__device__ __forceinline__ int as_int(float v) { return (int)v; }
__device__ __forceinline__ int as_int(int v) { return v; }

// two values rounded to nearest even in one cvt, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 values rounded once to the output type (store_as's rules) and stored
// as whole vectors at element ``off``
template <typename T>
__device__ __forceinline__ void vec_store(void* out, int dt, long long off, const T (&x)[VW]) {
    switch (dt) {
        case DT_BF16:
        case DT_F16: {
            uint4 v;
            uint32_t* w = (uint32_t*)&v;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                w[j] = dt == DT_BF16 ? pack_bf16(as_float(x[2 * j]), as_float(x[2 * j + 1]))
                                     : pack_f16(as_float(x[2 * j]), as_float(x[2 * j + 1]));
            *(uint4*)((unsigned short*)out + off) = v;
            break;
        }
        case DT_I8: {
            uint2 v;
            uint32_t* w = (uint32_t*)&v;
#pragma unroll
            for (int j = 0; j < 2; ++j)
                w[j] = ((uint32_t)(uint8_t)(int8_t)as_int(x[4 * j]))
                       | ((uint32_t)(uint8_t)(int8_t)as_int(x[4 * j + 1]) << 8)
                       | ((uint32_t)(uint8_t)(int8_t)as_int(x[4 * j + 2]) << 16)
                       | ((uint32_t)(uint8_t)(int8_t)as_int(x[4 * j + 3]) << 24);
            *(uint2*)((int8_t*)out + off) = v;
            break;
        }
        case DT_I32: {
            int4* p = (int4*)((int*)out + off);
            p[0] = make_int4(as_int(x[0]), as_int(x[1]), as_int(x[2]), as_int(x[3]));
            p[1] = make_int4(as_int(x[4]), as_int(x[5]), as_int(x[6]), as_int(x[7]));
            break;
        }
        default: {
            float4* p = (float4*)((float*)out + off);
            p[0] = make_float4(as_float(x[0]), as_float(x[1]), as_float(x[2]), as_float(x[3]));
            p[1] = make_float4(as_float(x[4]), as_float(x[5]), as_float(x[6]), as_float(x[7]));
        }
    }
}

// Vector q's row: its variables (one magic-number divmod each; variable 0
// counts vectors), its output offset and each input's, and whether it lies
// inside the clip (all of its points do, or none: the view's condition).
template <int NIN>
__device__ __forceinline__ bool vec_row(const VecParams& p, unsigned q, long long& oo,
                                        long long (&off)[NIN]) {
    int v[MAXV];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) v[i] = 0;
    oo = 0;
#pragma unroll
    for (int s = 0; s < NIN; ++s) off[s] = p.in_base[s];
    unsigned rest = q;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
        if (i >= p.n_var) break;
        const unsigned next = fast_div(rest, p.div_mul[i], p.div_shr[i]);
        v[i] = (int)(rest - next * (unsigned)p.div[i]) * (i == 0 ? VW : 1);
        rest = next;
        oo += (long long)p.out_stride[i] * v[i];
#pragma unroll
        for (int s = 0; s < NIN; ++s) off[s] += (long long)p.in_stride[s][i] * v[i];
    }
    if (!p.clipped) return true;
    bool inside = true;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
        if (d >= p.out_rank) break;
        int c = 0;
#pragma unroll
        for (int i = 0; i < MAXV; ++i) c += p.clip_coef[d][i] * v[i];
        if (c >= p.out_clip[d]) inside = false;
    }
    return inside;
}

// T: evaluation type; NIN: inputs.  A thread-step owns one vector: its
// loads are all issued before any arithmetic, then the program runs over
// its 8 points with the stack in registers, then one store.
template <typename T, int NIN>
__global__ void __launch_bounds__(VEC_BLOCK, 1) elementwise_vec_kernel(const __grid_constant__ VecParams p) {
    const long long threads = (long long)gridDim.x * blockDim.x;
    for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < p.n_vec;
         q += threads) {
        long long oo, off[NIN];
        if (!vec_row<NIN>(p, (unsigned)q, oo, off)) continue;
        uint32_t raw[NIN][VW];
#pragma unroll
        for (int s = 0; s < NIN; ++s) vec_load(p.in[s], p.in_dt[s], p.in_bcast[s], off[s], raw[s]);
        T r[VSLOT][VW];  // every slot is written before it is read
#pragma unroll 1
        for (int i = 0; i < p.n; ++i) {
            const int w = p.ins[i];
            const int c = INS_CODE(w);
            const int arg = INS_ARG(w);
            T x[VW];
            if (c == OP_LOAD) {
#pragma unroll
                for (int s = 0; s < NIN; ++s)
                    if (s == arg) vec_as<T>(raw[s], p.in_dt[s], p.in_bcast[s], x);
            } else if (c == OP_CONST || c == OP_ACC) {
                const T k = c == OP_CONST ? (T)p.consts[arg] : (T)0;
#pragma unroll
                for (int j = 0; j < VW; ++j) x[j] = k;
            } else if (c < OP_BINARY) {
                slot_get(r, INS_A(w), x);
                vec_unary(c - OP_UNARY, x);
            } else {
                T y[VW];
                slot_get(r, INS_A(w), x);
                slot_get(r, INS_B(w), y);
                vec_binary(c - OP_BINARY, x, y);
            }
            slot_put(r, INS_DST(w), x);
        }
        vec_store(p.out, p.out_dt, oo, r[0]);
    }
}

// An empty kernel: the floor of a launch's event time on this card.
__global__ void elementwise_empty_kernel() {}

template <typename T, int NIN>
static int vec_launch(const VecParams* p, int n_blocks, cudaStream_t st) {
    elementwise_vec_kernel<T, NIN><<<n_blocks, VEC_BLOCK, 0, st>>>(*p);
    return (int)cudaGetLastError();
}

template <typename T>
static int vec_launch_t(const VecParams* p, int n_blocks, cudaStream_t st) {
    switch (p->n_in) {
        case 1: return vec_launch<T, 1>(p, n_blocks, st);
        case 2: return vec_launch<T, 2>(p, n_blocks, st);
        case 3: return vec_launch<T, 3>(p, n_blocks, st);
        case 4: return vec_launch<T, 4>(p, n_blocks, st);
        case 5: return vec_launch<T, 5>(p, n_blocks, st);
        case 6: return vec_launch<T, 6>(p, n_blocks, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" {

// Launches one elementwise unit on ``stream``; returns cudaGetLastError().
int stripe_elementwise_launch(const EwParams* p, int n_blocks, int block, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const bool small = p->n_points < (1ll << 32);
    if (p->is_int && small)
        elementwise_kernel<int, unsigned><<<n_blocks, block, 0, st>>>(*p);
    else if (p->is_int)
        elementwise_kernel<int, long long><<<n_blocks, block, 0, st>>>(*p);
    else if (small)
        elementwise_kernel<float, unsigned><<<n_blocks, block, 0, st>>>(*p);
    else
        elementwise_kernel<float, long long><<<n_blocks, block, 0, st>>>(*p);
    return (int)cudaGetLastError();
}

// Layout of EwParams as this compiler laid it out, for the binding's check.
void stripe_elementwise_layout(long long* out) {
    out[0] = (long long)sizeof(EwParams);
    out[1] = (long long)offsetof(EwParams, in_stride);
    out[2] = (long long)offsetof(EwParams, consts);
    out[3] = (long long)offsetof(EwParams, ext);
    out[4] = (long long)offsetof(EwParams, out_rank);
    out[5] = (long long)offsetof(EwParams, prog);
}

// Launches the vec path (VecParams.n_in inputs, VEC_BLOCK threads a
// block) on ``stream``; returns cudaGetLastError().
int stripe_elementwise_vec_launch(const VecParams* p, int is_int, int n_blocks, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    return is_int ? vec_launch_t<int>(p, n_blocks, st) : vec_launch_t<float>(p, n_blocks, st);
}

// One launch of an empty kernel on ``stream``; returns cudaGetLastError().
int stripe_elementwise_empty(void* stream) {
    elementwise_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// Layout of VecParams as this compiler laid it out, for the binding's check.
void stripe_elementwise_vec_layout(long long* out) {
    out[0] = (long long)sizeof(VecParams);
    out[1] = (long long)offsetof(VecParams, consts);
    out[2] = (long long)offsetof(VecParams, in_stride);
    out[3] = (long long)offsetof(VecParams, div_mul);
    out[4] = (long long)offsetof(VecParams, clip_coef);
    out[5] = (long long)offsetof(VecParams, out_dt);
    out[6] = (long long)offsetof(VecParams, ins);
}

}  // extern "C"
