// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (contraction.cu, windowed.cu, flash_attention.cu, gla.cu): 16-byte
// cp.async copies, mbarriers, 3-D TMA loads and the host's tensor-map
// encoder, wgmma's shared-memory descriptors in the 128-byte swizzle, the
// wgmma products themselves (bf16, f16, int8, and tf32 with the split of a
// float32 into two tf32 values for 3xTF32), the address of a float32 in a
// swizzled box, 3xTF32's transposed split copy, and the map from an
// accumulator register to its (row, column) in the warpgroup's tile.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes from cudaGetDriverEntryPoint
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ------------------------------------------------------------ cp.async
__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of ``bytes`` (0..16) bytes, the rest of the 16 zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// Shared memory written by this thread through the generic proxy (stores,
// cp.async) becomes visible to the async proxy that wgmma and TMA read
// through; a barrier after it publishes every thread's writes.
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
    unsigned done = 0;
    while (!done) {
        asm volatile("{\n.reg .pred P1;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, P1;\n}\n"
                     : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void tma_load3(const CUtensorMap* map, void* dst, uint64_t* bar,
                                          int c0, int c1, int c2) {
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%3, %4, %5}], [%2];\n"
                 :: "r"(smem_u32(dst)), "l"((unsigned long long)map), "r"(smem_u32(bar)),
                    "r"(c0), "r"(c1), "r"(c2)
                 : "memory");
}

// ------------------------------------------------------- wgmma descriptors
// wgmma's descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), the leading offset unused
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    const uint64_t a = smem_u32(p);
    return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// ... of an MN-major tile in the 128-byte swizzle: a K row holds 64
// elements of N in 128 bytes, 8-row groups of K lie 1024 bytes apart (SBO),
// and the next 64 of N (the second TMA box) 8192 bytes on (LBO)
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p) {
    const uint64_t a = smem_u32(p);
    return ((a & 0x3FFFF) >> 4) | (512ull << 16) | (64ull << 32) | (1ull << 62);
}

// ------------------------------------------------------------ wgmma
#define WG_REGS                                                                              \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_REGS32                                                                            \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_8(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), \
                   c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define WG_32(c) WG_8(c, 0), WG_8(c, 8), WG_8(c, 16), WG_8(c, 24)
#define WG_64(c) WG_32(c), WG_8(c, 32), WG_8(c, 40), WG_8(c, 48), WG_8(c, 56)

// d (+)= A (64 x K-step) * B (N x K-step), one K step of 32 bytes: k16 for
// 16-bit types, k32 for int8, k8 for tf32 (float, below).  ``mma``: A and B
// in shared memory (not for tf32); ``mma_rs`` (16-bit types and tf32): A in
// registers, for 16-bit types four 32-bit registers of two elements in the
// accumulator's own layout (frag_mn), which is how one product's output
// feeds the next.  TB: B is MN-major (the transposed read wgmma offers for
// 16-bit types only).  ``acc`` 0 overwrites d instead of adding.  N is 64
// or 128; d holds N / 2 registers.
template <typename S, int N = 128> struct Wgmma;

template <> struct Wgmma<__nv_bfloat16, 128> {
    template <int TB>
    static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int acc = 1) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
                     ", %64, %65, p, 1, 1, 0, %67;\n}\n"
                     : WG_64("+f") : "l"(da), "l"(db), "r"(acc), "n"(TB));
    }
    template <int TB>
    static __device__ __forceinline__ void mma_rs(float* d, const unsigned* a, uint64_t db,
                                                  int acc = 1) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
                     ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
                     : WG_64("+f")
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
    }
};
template <> struct Wgmma<__nv_bfloat16, 64> {
    template <int TB>
    static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int acc = 1) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
                     ", %32, %33, p, 1, 1, 0, %35;\n}\n"
                     : WG_32("+f") : "l"(da), "l"(db), "r"(acc), "n"(TB));
    }
    template <int TB>
    static __device__ __forceinline__ void mma_rs(float* d, const unsigned* a, uint64_t db,
                                                  int acc = 1) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
                     ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
                     : WG_32("+f")
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
    }
};
template <> struct Wgmma<__half, 128> {
    template <int TB>
    static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int acc = 1) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " WG_REGS
                     ", %64, %65, p, 1, 1, 0, %67;\n}\n"
                     : WG_64("+f") : "l"(da), "l"(db), "r"(acc), "n"(TB));
    }
};
template <> struct Wgmma<__half, 64> {
    template <int TB>
    static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int acc = 1) {
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WG_REGS32
                     ", %32, %33, p, 1, 1, 0, %35;\n}\n"
                     : WG_32("+f") : "l"(da), "l"(db), "r"(acc), "n"(TB));
    }
};
template <> struct Wgmma<int8_t, 128> {
    template <int TB>
    static __device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db, int acc = 1) {
        static_assert(TB == 0, "wgmma reads 8-bit operands K-major only");
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_REGS
                     ", %64, %65, p;\n}\n"
                     : WG_64("+r") : "l"(da), "l"(db), "r"(acc));
    }
};
template <> struct Wgmma<int8_t, 64> {
    template <int TB>
    static __device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db, int acc = 1) {
        static_assert(TB == 0, "wgmma reads 8-bit operands K-major only");
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WG_REGS32
                     ", %32, %33, p;\n}\n"
                     : WG_32("+r") : "l"(da), "l"(db), "r"(acc));
    }
};

// tf32: float32 operands of which the tensor cores read the sign, the
// exponent and the top 10 mantissa bits; one K step of 32 bytes is k8.
// Both operands K-major only: wgmma's transposed read (TB) exists for
// 16-bit types alone, so a float32 operand that lies MN-major in memory
// is transposed before it reaches shared memory, or gathered by the
// threads into the register A operand.  ``mma_rs``: A in four 32-bit
// registers per thread, of rows g and g + 8 of the warp's 16 (g = lane /
// 4) at columns t and t + 4 of the k8 step (t = lane % 4), in the order
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).  ``mma`` (N 32 only,
// flash attention's scores): A in shared memory too.
#define WG_REGS16 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_16(c) WG_8(c, 0), WG_8(c, 8)
template <> struct Wgmma<float, 32> {
    template <int TB>
    static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int acc = 1) {
        static_assert(TB == 0, "wgmma reads 32-bit operands K-major only");
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_REGS16
                     ", %16, %17, p, 1, 1;\n}\n"
                     : WG_16("+f") : "l"(da), "l"(db), "r"(acc));
    }
    template <int TB>
    static __device__ __forceinline__ void mma_rs(float* d, const unsigned* a, uint64_t db,
                                                  int acc = 1) {
        static_assert(TB == 0, "wgmma reads 32-bit operands K-major only");
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_REGS16
                     ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                     : WG_16("+f")
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
    }
};
template <> struct Wgmma<float, 128> {
    template <int TB>
    static __device__ __forceinline__ void mma_rs(float* d, const unsigned* a, uint64_t db,
                                                  int acc = 1) {
        static_assert(TB == 0, "wgmma reads 32-bit operands K-major only");
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_REGS
                     ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                     : WG_64("+f")
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
    }
};
template <> struct Wgmma<float, 64> {
    template <int TB>
    static __device__ __forceinline__ void mma_rs(float* d, const unsigned* a, uint64_t db,
                                                  int acc = 1) {
        static_assert(TB == 0, "wgmma reads 32-bit operands K-major only");
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                     "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_REGS32
                     ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                     : WG_32("+f")
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
    }
};

// 3xTF32: a float32 x is hi + lo exactly, hi = x with its low 13 mantissa
// bits cleared (a tf32 value, whatever the tensor cores do with the bits
// they drop) and lo = x - hi (|lo| < 2^-10 |x|), of which the tensor
// cores read the top bits in turn.  a b is then a_hi b_hi + a_hi b_lo +
// a_lo b_hi, off by at most about 3 2^-20 |a| |b|.
#define TF32_MASK 0xffffe000u
__device__ __forceinline__ float tf32_hi(float x) {
    return __uint_as_float(__float_as_uint(x) & TF32_MASK);
}

__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
    const float h = tf32_hi(x);
    hi = __float_as_uint(h);
    lo = __float_as_uint(x - h);
}

// Element (row, col) of a 128-byte-swizzled box of float32 rows of 32, as
// TMA writes it (the box 1024-byte aligned).
__device__ __forceinline__ float* sw_ptr(unsigned char* box, int row, int col) {
    return (float*)(box + row * 128 + ((((col >> 2) ^ (row & 7))) << 4) + (col & 3) * 4);
}
__device__ __forceinline__ float sw_at(const unsigned char* box, int row, int col) {
    return *sw_ptr(const_cast<unsigned char*>(box), row, col);
}

// 3xTF32's transposed operand: rows s0 .. s0 + 31 of a row-major (rows,
// width) float32 tensor x, written as x^T (width, ld) split into hi and
// lo, the rows of every 8 in the order 0 2 4 6 1 3 5 7 (a score
// accumulator's registers, columns 2t and 2t + 1 of each 8, are then the
// A operand of the product with it, columns t and t + 4).  Rows past
// ``rows`` read as zeros; columns past ``ld`` are not written.  All 256
// threads of the CTA take part, through ``tile`` in shared memory.
__device__ __forceinline__ void transpose_split32(const float* x, float* hi, float* lo, int rows,
                                                  int width, int ld, int s0, float (*tile)[33]) {
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int j = tx & 7, from = (tx & ~7) + (j < 4 ? 2 * j : 2 * j - 7);
    for (int p0 = 0; p0 < width; p0 += 32) {
        __syncthreads();
        for (int r = ty; r < 32; r += 8)
            tile[r][tx] = s0 + r < rows && p0 + tx < width
                              ? x[(long long)(s0 + r) * width + p0 + tx] : 0.0f;
        __syncthreads();
        if (s0 + tx < ld)
            for (int r = ty; r < 32 && p0 + r < width; r += 8) {
                const float v = tile[from][r], h = tf32_hi(v);
                const long long o = (long long)(p0 + r) * ld + s0 + tx;
                hi[o] = h;
                lo[o] = v - h;
            }
    }
}

// Warp-specialised register budgets: a warpgroup (all its threads) gives
// registers back to the CTA's pool, or takes them from it, waiting until
// the pool holds them.  The kernel's register count at launch (set by its
// launch bounds) must cover what the warpgroups hold after both.
template <int N>
__device__ __forceinline__ void reg_dealloc() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N)); }
template <int N>
__device__ __forceinline__ void reg_alloc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N)); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory"); }

// keep the accumulators in place across the asynchronous products
template <int R = 64>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int R = 64>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Accumulator i of thread t of a warpgroup (m64nN, 32-bit accumulators):
// its row in the warpgroup's 64 and its column.  The epilogue's loads and
// the store both go through this one mapping.
__device__ __forceinline__ void frag_mn(int i, int t, int& row, int& col) {
    row = (t >> 5) * 16 + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
    col = (i >> 2) * 8 + (t & 3) * 2 + (i & 1);
}

// ------------------------------------------------------------ host
template <typename K>
static void smem_limit(K kernel, size_t bytes) {
    if (bytes > 48 * 1024)
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                               cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                      cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)f;
    }
    return fn;
}

// Error codes of a launch beyond CUDA's own
#define ERR_NO_ENCODER 9001  // the CUDA driver offers no cuTensorMapEncodeTiled
#define ERR_ENCODE 9100      // + CUresult: the CUDA driver refused a tensor map

// A 3-D tensor map (dims innermost first, strides in bytes of dims 1 and
// 2) in the 128-byte swizzle, zeros outside the tensor; 0 or an error code.
static int tensor_map3(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
    const EncodeTiled enc = encoder();
    if (!enc) return ERR_NO_ENCODER;
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = enc(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// The TMA map of a (heads, rows, width) float32 tensor: boxes of 32 of the
// width (128 bytes) by ``box_rows``; zeros past ``width`` and ``rows``.
static inline int f32_map(CUtensorMap* map, const void* ptr, int width, int rows, long long heads,
                          int box_rows) {
    const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)heads};
    const cuuint64_t strides[2] = {(cuuint64_t)width * 4, (cuuint64_t)width * 4 * rows};
    const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
    return tensor_map3(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, dims, strides, box);
}
