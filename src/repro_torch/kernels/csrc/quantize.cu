// The int8 wire codec for Hopper (sm_90a): three kernels bound through a plain
// C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py:
//   quantize_absmax     <- _absmax_kernel     (quantize_int8_pallas, max|x|)
//   quantize_int8       <- _quantize_kernel   (int8(clip(rint(x / s), +-127)))
//   dequantize_int8     <- _dequantize_kernel (dequantize_int8_pallas, q * s)
// Same contract as the reference's eager jnp codec
// (src/repro/dist/compression.py quantize_int8 / dequantize_int8): the same q,
// the same fp32 scale bit for bit, the same dequantized values.
//
// What bounds them on the H100: each moves its bytes once and does a handful
// of operations per element, so all three are bound by device memory (absmax
// reads 4 B per fp32 element; quantize reads 4 B and writes 1 B; dequantize
// reads 1 B and writes 4 B). The design answers that with 16-byte accesses
// on the wide side (loads of x, stores of q * s), several of them in flight per
// thread, a grid-stride loop sized to the SM count, and no copy of the
// input: the TPU version zero-pads the tensor
// into (rows, 128) tiles first, these read the flat tensor in place and
// finish the ragged tail one element at a time.
//
// How the TPU's sequential grid translates. The Pallas absmax revisits one
// (1, 1) output block over a grid that runs in order; here blocks run in
// parallel, so each block reduces its share in registers and warp shuffles
// and then does one atomicMax on the fp32 bits of a device scalar. |x| >= 0
// and non-negative floats order like their bit patterns as unsigned ints, so
// the integer max is the float max, and a NaN (bits above +inf after fabsf)
// wins as it does in jnp.max. Several absmax launches may accumulate into one
// scalar: that is how the port gives all the layers of one stacked reference
// leaf one shared scale. The quantize kernel reads that scalar and computes
// s = absmax / 127 itself (no host round trip), with an IEEE divide
// (__fdiv_rn), round-half-to-even (rintf) and a true divide x / s rather than
// a multiply by 1/s: the two differ at half-ulp boundaries. Built without
// --use_fast_math, so nothing is turned into an approximation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // 16-byte loads in flight per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Unpack 16 bytes of T into 16 / sizeof(T) floats.
__device__ __forceinline__ void unpack(const uint4& raw, float* f, float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ unsigned int abs_bits(float x) {
  return __float_as_uint(fabsf(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, long long n, long long n_vec,
              unsigned int* __restrict__ out) {
  constexpr int kEpv = 16 / sizeof(T);
  const long long tid = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  unsigned int m = 0u;
  for (long long v0 = tid; v0 < n_vec; v0 += stride * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < n_vec) raw[u] = __ldg(xv + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v0 + u * stride < n_vec) {
        float f[kEpv];
        unpack(raw[u], f, T());
#pragma unroll
        for (int i = 0; i < kEpv; ++i) m = max(m, abs_bits(f[i]));
      }
    }
  }
  for (long long i = n_vec * kEpv + tid; i < n; i += stride) {
    m = max(m, abs_bits(to_float(x[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ unsigned int warp_max[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warp_max[lane] : 0u;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if (lane == 0) atomicMax(out, m);
  }
}

__device__ __forceinline__ int8_t quantize_one(float x, float safe) {
  float r = rintf(__fdiv_rn(x, safe));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, long long n, long long n_vec,
                const unsigned int* __restrict__ absmax_bits,
                float* __restrict__ scale_out, int8_t* __restrict__ q) {
  constexpr int kEpv = 16 / sizeof(T);
  const float s = __fdiv_rn(__uint_as_float(*absmax_bits), 127.0f);
  const float safe = s > 0.0f ? s : 1.0f;
  const long long tid = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if (tid == 0) *scale_out = s;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (long long v0 = tid; v0 < n_vec; v0 += stride * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < n_vec) raw[u] = __ldg(xv + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < n_vec) {
        float f[kEpv];
        unpack(raw[u], f, T());
        int8_t b[kEpv];
#pragma unroll
        for (int i = 0; i < kEpv; ++i) b[i] = quantize_one(f[i], safe);
        if constexpr (kEpv == 4) {
          *reinterpret_cast<char4*>(q + v * kEpv) = make_char4(b[0], b[1], b[2], b[3]);
        } else {
          char4 lo = make_char4(b[0], b[1], b[2], b[3]);
          char4 hi = make_char4(b[4], b[5], b[6], b[7]);
          uint2 w;
          w.x = *reinterpret_cast<unsigned int*>(&lo);
          w.y = *reinterpret_cast<unsigned int*>(&hi);
          *reinterpret_cast<uint2*>(q + v * kEpv) = w;
        }
      }
    }
  }
  for (long long i = n_vec * kEpv + tid; i < n; i += stride) {
    q[i] = quantize_one(to_float(x[i]), safe);
  }
}

// Four int8 per thread and step: a 4-byte load and one 16-byte store, so a
// warp's stores cover 512 contiguous bytes. (A 16-byte load per thread would
// make each of its four float4 stores stride 64 bytes across the warp, half
// a sector each: that version ran at 2.8x the bytes bound.)
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, long long n, long long n_vec,
                  const float* __restrict__ scale, float* __restrict__ out) {
  constexpr int kEpv = 4;       // int8 values per 4-byte load
  constexpr int kSteps = 2 * kUnroll;
  const float s = *scale;
  const long long tid = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const char4* qv = reinterpret_cast<const char4*>(q);
  float4* ov = reinterpret_cast<float4*>(out);
  for (long long v0 = tid; v0 < n_vec; v0 += stride * kSteps) {
    char4 raw[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const long long v = v0 + u * stride;
      if (v < n_vec) raw[u] = __ldg(qv + v);
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const long long v = v0 + u * stride;
      if (v < n_vec) {
        ov[v] = make_float4(__fmul_rn(static_cast<float>(raw[u].x), s),
                            __fmul_rn(static_cast<float>(raw[u].y), s),
                            __fmul_rn(static_cast<float>(raw[u].z), s),
                            __fmul_rn(static_cast<float>(raw[u].w), s));
      }
    }
  }
  for (long long i = n_vec * kEpv + tid; i < n; i += stride) {
    out[i] = __fmul_rn(static_cast<float>(q[i]), s);
  }
}

// Blocks for a grid-stride loop over `units` items: enough to give every
// thread kUnroll of them, at most 16 blocks per SM.
int grid_for(long long units, int sm_count) {
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  long long blocks = (units + per_block - 1) / per_block;
  const long long cap = 16LL * (sm_count > 0 ? sm_count : 1);
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// 16-byte vectors over the tensor when it starts 16-byte aligned (the
// wrapper checks every pointer); otherwise all elements go by the tail loop.
long long vectors(long long n, int elems_per_vec, int aligned) {
  return aligned ? n / elems_per_vec : 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launch.
extern "C" int quantize_absmax(const void* x, long long n, int dtype, int aligned,
                               void* absmax, int sm_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* out = static_cast<unsigned int*>(absmax);
  if (dtype == 0) {
    const long long nv = vectors(n, 4, aligned);
    absmax_kernel<float><<<grid_for(nv > 0 ? nv : n, sm_count), kThreads, 0, s>>>(
        static_cast<const float*>(x), n, nv, out);
  } else if (dtype == 1) {
    const long long nv = vectors(n, 8, aligned);
    absmax_kernel<__nv_bfloat16><<<grid_for(nv > 0 ? nv : n, sm_count), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, nv, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quantize_int8(const void* x, long long n, int dtype, int aligned,
                             const void* absmax, void* scale, void* q,
                             int sm_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int* bits = static_cast<const unsigned int*>(absmax);
  float* scale_out = static_cast<float*>(scale);
  int8_t* qo = static_cast<int8_t*>(q);
  if (dtype == 0) {
    const long long nv = vectors(n, 4, aligned);
    quantize_kernel<float><<<grid_for(nv > 0 ? nv : n, sm_count), kThreads, 0, s>>>(
        static_cast<const float*>(x), n, nv, bits, scale_out, qo);
  } else if (dtype == 1) {
    const long long nv = vectors(n, 8, aligned);
    quantize_kernel<__nv_bfloat16><<<grid_for(nv > 0 ? nv : n, sm_count), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, nv, bits, scale_out, qo);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_int8(const void* q, long long n, int aligned,
                               const void* scale, void* out, int sm_count,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nv = vectors(n, 4, aligned);
  dequantize_kernel<<<grid_for(nv > 0 ? nv : n, sm_count), kThreads, 0, s>>>(
      static_cast<const int8_t*>(q), n, nv, static_cast<const float*>(scale),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
