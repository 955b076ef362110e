// The int8 ring hop's per-128-value codec for Hopper, fused with the
// reduce-scatter's f32 accumulate.
//
// Replaces no Pallas kernel. It replaces, in
// src/repro/kernels/quant_bucket/quant_bucket.py:
//   wire_encode (:114)  values -> int8 codes + one f32 scale per 128-value
//                       bucket (scale = max(absmax, 1e-12) / 127, a true
//                       division; code = round-half-even(v / scale) clamped
//                       to +-127)
//   wire_decode (:137)  codes x scale, trimmed to n
// and, in src/repro/core/collectives.py's ring_reduce_scatter, the hop's
// dequantize-accumulate-requantize (local + wire_decode(received), then
// wire_encode of that sum for the next hop). The reference writes the codec
// in plain jnp on purpose: XLA fuses it into each ring hop on the TPU, so
// a hop adds no launch. Eager PyTorch has no such fusion (a dozen passes
// over the chunk a hop), so these kernels do that fusion by hand.
//
// Entry points (layout: rows of n values; each row padded on its own to
// nb = ceil(n / 128) buckets; codes (rows, nb * 128) int8, scales
// (rows, nb) f32, both contiguous; the values' rows are contiguous and
// evenly strided, f32 or bf16):
//   wire_encode_cuda             values -> codes, scales
//   wire_decode_cuda             codes, scales -> (rows, n) f32 values
//   wire_decode_add_encode_cuda  received codes, scales + the local chunk
//                                -> the next hop's codes, scales (the f32
//                                sum stays in registers); with a null
//                                out_codes, the (rows, n) f32 sum instead
//                                (a reduce-scatter's last step)
//
// What bounds it: HBM bytes. Per value, encode reads 4 B (f32) and writes
// 1 + 4/128 B; decode reads 1 + 4/128 B and writes 4 B; the fused hop reads
// 4 + 1 + 4/128 B and writes 1 + 4/128 B (~6.06 B); the last step reads the
// same and writes 4 B (~9.03 B). A value costs two IEEE divisions at most
// (the scale's per bucket is amortised), far below the card's
// compute-to-bandwidth ratio.
//
// Design (route (b): nvcc into a shared library with a plain C interface,
// loaded through ctypes by kernels/cuda_build.py): one warp per 128-value
// bucket; lane l takes values l, l + 32, l + 64, l + 96, so every load and
// store of the warp covers consecutive addresses; the bucket's absmax is a
// warp-shuffle max (a max does not depend on its order, so it is exact);
// WARPS buckets a CTA, the grid over rows x buckets; the ragged last bucket
// of a row reads zeros past n, as the reference's zero padding gives it.
//
// Exactness: bit for bit with the eager codec (and so with the reference's
// op-by-op form): the scale is __fdiv_rn(fmaxf(absmax, 1e-12f), 127.0f), a
// true division, never a multiplication by f32(1/127) (the streaming
// quantize_wire's compiled form); a code is rintf(__fdiv_rn(v, scale))
// (round half to even, as torch.round and jnp.round) clamped to +-127; a
// decoded value is __fmul_rn(code, scale) and the sum __fadd_rn(local,
// decoded). The _rn intrinsics keep nvcc from contracting code x scale +
// local into one FMA, a rounding neither torch's two ops nor the reference
// has. bf16 values widen exactly. Denormals are kept: never build with
// --use_fast_math. The contract is finite inputs: a NaN drops out of the
// bucket's absmax (fmaxf) and its code clamps to -127; an Inf makes the
// scale Inf, its own code -127 (Inf / Inf is NaN) and the others' 0; the
// plain version gives NaN scales and undefined codes there.
//
// Every entry point returns the cudaError_t of cudaGetLastError() right
// after its launch, as an int; cuda_error_string() names it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIRE_BLOCK = 128;           // values per scale
constexpr int LANES = 32;
constexpr int PER_LANE = WIRE_BLOCK / LANES;
constexpr int WARPS = 8;                  // buckets per CTA
constexpr int THREADS = WARPS * LANES;

static_assert(PER_LANE * LANES == WIRE_BLOCK, "a warp covers one bucket");

// what a launch computes from its operands
enum class Mode {
  kEncode,   // values -> codes, scales
  kDecode,   // codes, scales -> values
  kHop,      // codes, scales + local -> codes, scales of the sum
  kLast,     // codes, scales + local -> the f32 sum
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, Mode M>
__global__ void __launch_bounds__(THREADS)
wire_hop(const T* __restrict__ x, long long x_stride,
         const int8_t* __restrict__ in_codes, const float* __restrict__ in_scales,
         int8_t* __restrict__ out_codes, float* __restrict__ out_scales,
         float* __restrict__ out_values, long long n, long long nb,
         long long ctas_per_row) {
  const long long row = blockIdx.x / ctas_per_row;
  const long long bucket =
      (blockIdx.x - row * ctas_per_row) * WARPS + (threadIdx.x / LANES);
  // encode and hop: nb == ceil(n / 128); decode may trim to fewer buckets
  if (bucket * WIRE_BLOCK >= n) return;
  const int lane = threadIdx.x % LANES;
  const long long first = bucket * WIRE_BLOCK + lane;   // this lane's first value
  const long long crow = row * nb * WIRE_BLOCK;          // the row's codes
  const T* xrow = x + row * x_stride;

  if constexpr (M == Mode::kDecode) {
    const float s = in_scales[row * nb + bucket];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const long long i = first + j * LANES;
      if (i < n)
        out_values[row * n + i] = __fmul_rn(static_cast<float>(in_codes[crow + i]), s);
    }
    return;
  } else {
    // this lane's 4 values (zeros past n): the input, or local + decoded
    float v[PER_LANE];
    if constexpr (M == Mode::kEncode) {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const long long i = first + j * LANES;
        v[j] = i < n ? widen(xrow[i]) : 0.0f;
      }
    } else {
      const float s = in_scales[row * nb + bucket];
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const long long i = first + j * LANES;
        const float d = __fmul_rn(static_cast<float>(in_codes[crow + i]), s);
        v[j] = i < n ? __fadd_rn(widen(xrow[i]), d) : 0.0f;
      }
    }
    if constexpr (M == Mode::kLast) {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const long long i = first + j * LANES;
        if (i < n) out_values[row * n + i] = v[j];
      }
      return;
    } else {
      float m = fabsf(v[0]);
#pragma unroll
      for (int j = 1; j < PER_LANE; ++j) m = fmaxf(m, fabsf(v[j]));
#pragma unroll
      for (int o = LANES / 2; o > 0; o /= 2)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float scale = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(v[j], scale)), -127.0f), 127.0f);
        out_codes[crow + first + j * LANES] = static_cast<int8_t>(__float2int_rn(q));
      }
      if (lane == 0) out_scales[row * nb + bucket] = scale;
    }
  }
}

template <typename T, Mode M>
cudaError_t launch(const void* x, long long x_stride, const void* in_codes,
                   const void* in_scales, void* out_codes, void* out_scales,
                   void* out_values, long long rows, long long n, long long nb,
                   void* stream) {
  const long long buckets = (n + WIRE_BLOCK - 1) / WIRE_BLOCK;
  const long long ctas_per_row = (buckets + WARPS - 1) / WARPS;
  const long long grid = rows * ctas_per_row;
  if (grid == 0) return cudaSuccess;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  wire_hop<T, M><<<static_cast<unsigned>(grid), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), x_stride, static_cast<const int8_t*>(in_codes),
      static_cast<const float*>(in_scales), static_cast<int8_t*>(out_codes),
      static_cast<float*>(out_scales), static_cast<float*>(out_values), n, nb,
      ctas_per_row);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// (rows, n) values (f32, or bf16 with x_bf16; row r at x + r * x_stride)
// -> codes (rows, nb * 128) int8 and scales (rows, nb) f32, nb = ceil(n / 128)
int wire_encode_cuda(const void* x, long long x_stride, int x_bf16, void* codes,
                     void* scales, long long rows, long long n, void* stream) {
  const long long nb = (n + WIRE_BLOCK - 1) / WIRE_BLOCK;
  cudaError_t err = x_bf16
      ? launch<__nv_bfloat16, Mode::kEncode>(x, x_stride, nullptr, nullptr, codes,
                                             scales, nullptr, rows, n, nb, stream)
      : launch<float, Mode::kEncode>(x, x_stride, nullptr, nullptr, codes, scales,
                                     nullptr, rows, n, nb, stream);
  return static_cast<int>(err);
}

// codes (rows, nb * 128) int8 and scales (rows, nb) f32 -> (rows, n) f32
// values, n <= nb * 128
int wire_decode_cuda(const void* codes, const void* scales, void* out,
                     long long rows, long long n, long long nb, void* stream) {
  return static_cast<int>(launch<float, Mode::kDecode>(
      nullptr, 0, codes, scales, nullptr, nullptr, out, rows, n, nb, stream));
}

// received codes (rows, nb * 128) and scales (rows, nb), plus the local
// (rows, n) chunk (f32, or bf16 with local_bf16; row r at local + r *
// local_stride): their f32 sum re-encoded into out_codes / out_scales, or,
// with a null out_codes, the (rows, n) f32 sum written to out_sum
int wire_decode_add_encode_cuda(const void* codes, const void* scales,
                                const void* local, long long local_stride,
                                int local_bf16, void* out_codes, void* out_scales,
                                void* out_sum, long long rows, long long n,
                                void* stream) {
  const long long nb = (n + WIRE_BLOCK - 1) / WIRE_BLOCK;
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (out_codes == nullptr) {
    err = local_bf16
        ? launch<bf, Mode::kLast>(local, local_stride, codes, scales, nullptr,
                                  nullptr, out_sum, rows, n, nb, stream)
        : launch<float, Mode::kLast>(local, local_stride, codes, scales, nullptr,
                                     nullptr, out_sum, rows, n, nb, stream);
  } else {
    err = local_bf16
        ? launch<bf, Mode::kHop>(local, local_stride, codes, scales, out_codes,
                                 out_scales, nullptr, rows, n, nb, stream)
        : launch<float, Mode::kHop>(local, local_stride, codes, scales, out_codes,
                                    out_scales, nullptr, rows, n, nb, stream);
  }
  return static_cast<int>(err);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
