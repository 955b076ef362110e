// One side of the elastic exchange (paper eqs. (2) and (3)) for Hopper.
//
// Replaces, in src/repro/kernels/fused_elastic/fused_elastic.py:
//   elastic_client_flat (:83)  eq. (3): w' = w - a (w - w~), new w in w's dtype
//   elastic_server_flat (:97)  eq. (2): w~' = w~ + a (w - w~), new w~ in w~'s dtype
// (their bodies _elastic_client_kernel / _elastic_server_kernel, launched
// through _flat_call's pallas_call at :47).
//
// What bounds it: HBM bytes. Each element reads w and w~ once and writes
// one output, 12 B at f32, for 3 flops: at the full-width packed buffer
// (n = 494,147,584) 5.93 GB, 1.770 ms at 3.35 TB/s.
//
// Design (route (b): nvcc into a shared library with a plain C
// interface, loaded through ctypes by kernels/cuda_build.py):
//   - one CTA per TILE elements; one elected thread copies the CTA's
//     tiles of w and w~ into shared memory with two 1-D bulk async copies
//     (cp.async.bulk, the TMA's non-tensor form) that complete one
//     mbarrier by their byte count, so no thread spends registers or
//     instructions on the loads;
//   - THREADS threads wait on the barrier, each computes 4 elements in
//     f32 registers and stores them with one vector store;
//   - 2 CTAs fit an SM (by threads), so 64 KB of each SM's loads are in
//     flight while its other CTA computes and stores, and CTAs finish
//     and start in no fixed order;
//   - the ragged last tile (n mod TILE elements) takes ordinary loads and
//     stores; offsets are 64-bit; a is read once per CTA from the f32
//     device scalar, with no host read.
// TILE and THREADS come from a sweep on the H100 (kernels/fused_elastic/
// sweep.py; its numbers in PERF.md): a persistent grid that walks tiles
// through a ring of bulk copies ran 3-5 % slower at every ring depth, and
// bulk stores of the output tile ran no faster than these register stores.
// Rounding as the reference's compiled code: d = w - w~ rounded, then ONE
// fused multiply-add, fma(a, d, w~) / fma(-a, d, w); bf16 operands are
// widened exactly and outputs rounded to nearest even. Never build with
// --use_fast_math.
//
// Every entry point returns the cudaError_t of cudaGetLastError() right
// after its launch, as an int; cuda_error_string() names it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 4096;      // elements per CTA (16 KB of f32 per operand)
constexpr int THREADS = 1024;   // 4 elements each: one vector load and store

static_assert(TILE == 4 * THREADS, "each thread takes one 4-element vector");
static_assert(TILE * 8 <= 48 * 1024, "both f32 tiles fit static shared memory");

// -- element access: 4 values at a time, widened to f32 --------------------

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 x;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint2*>(p) = x;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// eq. (2) (SERVER) or eq. (3): the difference rounded, then one FMA
template <bool SERVER>
__device__ __forceinline__ float one_side(float a, float w, float c) {
  const float d = __fsub_rn(w, c);
  return SERVER ? __fmaf_rn(a, d, c) : __fmaf_rn(-a, d, w);
}

// -- the bulk-copy and mbarrier primitives (PTX) ---------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// -- the kernel --------------------------------------------------------------

template <typename TW, typename TC, bool SERVER>
__global__ void __launch_bounds__(THREADS, 2048 / THREADS)   // registers for a full SM
one_side_tile(const float* __restrict__ alpha, const TW* __restrict__ w,
              const TC* __restrict__ c,
              typename std::conditional<SERVER, TC, TW>::type* __restrict__ out,
              long long n) {
  constexpr uint32_t W_BYTES = TILE * sizeof(TW);
  constexpr uint32_t C_BYTES = TILE * sizeof(TC);
  __shared__ __align__(128) TW wt[TILE];
  __shared__ __align__(128) TC ct[TILE];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float a_shared;

  const long long off = blockIdx.x * static_cast<long long>(TILE);
  if (off + TILE > n) {   // the ragged last tile: ordinary loads and stores
    const float a = *alpha;
    for (long long i = off + threadIdx.x; i < n; i += THREADS)
      narrow(out + i, one_side<SERVER>(a, widen(w[i]), widen(c[i])));
    return;
  }
  const uint32_t b = smem_addr(&bar);
  if (threadIdx.x == 0) {
    a_shared = *alpha;
    mbar_init(b);
    mbar_expect_tx(b, W_BYTES + C_BYTES);
    bulk_load(smem_addr(wt), w + off, W_BYTES, b);
    bulk_load(smem_addr(ct), c + off, C_BYTES, b);
  }
  __syncthreads();        // the barrier is initialised before anyone waits
  const float a = a_shared;
  mbar_wait(b, 0);

  const int i = threadIdx.x * 4;
  float wv[4], cv[4], ov[4];
  load4(wt + i, wv);
  load4(ct + i, cv);
#pragma unroll
  for (int j = 0; j < 4; ++j) ov[j] = one_side<SERVER>(a, wv[j], cv[j]);
  store4(out + off + i, ov);
}

// -- host side ---------------------------------------------------------------

template <typename TW, typename TC, bool SERVER>
cudaError_t launch_typed(const float* alpha, const void* w, const void* c, void* out,
                         long long n, cudaStream_t stream) {
  using TO = typename std::conditional<SERVER, TC, TW>::type;
  const long long grid = (n + TILE - 1) / TILE;
  one_side_tile<TW, TC, SERVER><<<static_cast<unsigned>(grid), THREADS, 0, stream>>>(
      alpha, static_cast<const TW*>(w), static_cast<const TC*>(c),
      static_cast<TO*>(out), n);
  return cudaGetLastError();
}

// dispatch on (w bf16?, w~ bf16?) for one side
template <bool SERVER>
int launch(const void* alpha, const void* w, const void* c, void* out, long long n,
           int w_bf16, int c_bf16, void* stream) {
  using bf = __nv_bfloat16;
  const float* a = static_cast<const float*>(alpha);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!w_bf16 && !c_bf16) err = launch_typed<float, float, SERVER>(a, w, c, out, n, s);
  else if (!w_bf16) err = launch_typed<float, bf, SERVER>(a, w, c, out, n, s);
  else if (!c_bf16) err = launch_typed<bf, float, SERVER>(a, w, c, out, n, s);
  else err = launch_typed<bf, bf, SERVER>(a, w, c, out, n, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// eq. (3): out = w - a (w - w~) in w's dtype
int elastic_client_flat_cuda(const void* alpha, const void* w, const void* c, void* out,
                             long long n, int w_bf16, int c_bf16, void* stream) {
  return launch<false>(alpha, w, c, out, n, w_bf16, c_bf16, stream);
}

// eq. (2): out = w~ + a (w - w~) in w~'s dtype
int elastic_server_flat_cuda(const void* alpha, const void* w, const void* c, void* out,
                             long long n, int w_bf16, int c_bf16, void* stream) {
  return launch<true>(alpha, w, c, out, n, w_bf16, c_bf16, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
