// Flash attention forward for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_kernel` of
// src/repro/kernels/flash_attention.py. Same function: GQA attention
// softmax(scale * q k^T -> optional tanh softcap -> position mask) v, with an
// online softmax whose running max, running sum and accumulator stay in fp32.
// Masks come from int32 position vectors: kv_pos >= 2^30 is always masked,
// causal keeps kv_pos <= q_pos, a window keeps kv_pos > q_pos - window.
// Masked scores take the finite NEG_INF and the running max starts at -inf, as
// in the reference, so a wholly masked row yields mean(v) like attend_naive.
//
// What bounds it on the H100: at the serving shapes (decode, q [4,1,16,128]
// against a bf16 ring cache of 64 slots) the work is reading K and V from
// device memory, about 0.26 MB, which is well under a microsecond at 3.35 TB/s;
// the call is bound by its launch. With longer caches it becomes bound by the
// bytes of K and V. The design answers that only in part: the inner loop over
// KV tiles streams each tile through shared memory once per block, with
// 16-byte loads of which each thread keeps several in flight (one element per
// load left each tile waiting on one memory latency per element); GQA maps a
// q head onto its kv head by index arithmetic (no repeated K/V), q/k/v are
// read in place through strides (no transpose copies), and the ragged edge is
// masked by bounds (no padding copies). The q heads of one kv head still read
// K/V in separate blocks (served from L2), products run on the CUDA cores in
// fp32, and a decode call keeps only B*Hq blocks busy; mma/wgmma, TMA and
// split-KV decode are left for later work.
//
// Layout: q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd], out [B,Sq,Hq,hd], each with unit
// stride in hd and any other strides that keep rows 16-byte aligned. Types: fp32 or bf16 for q (and out) and,
// independently, for k/v. hd is a multiple of 8 up to 256.
//
// Grid: x = b*Hq + hq, y = q tile of kBlockQ rows. A loop inside the block
// walks the KV tiles of kBlockKV rows; 128 threads per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 16;
constexpr int kBlockKV = 64;
constexpr int kUnroll = 8;      // 16-byte loads in flight per thread
constexpr float kNegInf = -2.3819763e38f;
constexpr int kPadPos = 1 << 30;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  void* out;
  int Sq, Skv, Hq, Hkv, hd;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale, softcap;
  int causal, window;
};

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

// Copy rows x hd elements of T (row stride src_stride) into fp32 shared memory
// (row pitch `pitch`), times `mul`. Each thread moves 16-byte chunks and keeps
// up to kUnroll loads in flight, so a tile costs about one memory latency
// rather than one per element. Rows and strides are 16-byte aligned (the
// wrapper checks).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src,
                                          long long src_stride, int rows, int hd,
                                          float mul) {
  constexpr int kEpc = 16 / sizeof(T);
  const int per_row = hd / kEpc;
  const int n = rows * per_row;
  for (int c0 = threadIdx.x; c0 < n; c0 += kThreads * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      if (c < n) {
        const int r = c / per_row, d = (c - r * per_row) * kEpc;
        raw[u] = __ldg(reinterpret_cast<const uint4*>(src + r * src_stride + d));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      if (c < n) {
        const int r = c / per_row, d = (c - r * per_row) * kEpc;
        float f[kEpc];
        unpack(raw[u], f, T());
#pragma unroll
        for (int i = 0; i < kEpc; ++i) dst[r * pitch + d + i] = f[i] * mul;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory, in floats: q tile and accumulator [kBlockQ][hd] each; K tile
// [kBlockKV][hd+1] (the odd row pitch keeps the per-thread dot products free of
// bank conflicts); V tile [kBlockKV][hd]; scores [kBlockQ][kBlockKV]; m, l,
// alpha [kBlockQ]; then int q positions [kBlockQ] and kv positions [kBlockKV].
size_t smem_bytes(int hd) {
  size_t floats = 2 * kBlockQ * hd + kBlockKV * (hd + 1) + kBlockKV * hd +
                  kBlockQ * kBlockKV + 3 * kBlockQ;
  size_t ints = kBlockQ + kBlockKV;
  return (floats + ints) * 4;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd;
  const int kpitch = hd + 1;
  float* q_s = smem;
  float* acc_s = q_s + kBlockQ * hd;
  float* k_s = acc_s + kBlockQ * hd;
  float* v_s = k_s + kBlockKV * kpitch;
  float* s_s = v_s + kBlockKV * hd;
  float* m_s = s_s + kBlockQ * kBlockKV;
  float* l_s = m_s + kBlockQ;
  float* alpha_s = l_s + kBlockQ;
  int* qpos_s = reinterpret_cast<int*>(alpha_s + kBlockQ);
  int* kvpos_s = qpos_s + kBlockQ;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.Hq;
  const int hq = blockIdx.x % a.Hq;
  const int hkv = hq / (a.Hq / a.Hkv);  // kv row b*Hkv + hq // G
  const int q0 = blockIdx.y * kBlockQ;
  const int nq = min(kBlockQ, a.Sq - q0);

  const TQ* qg = static_cast<const TQ*>(a.q) + b * a.q_sb + hq * a.q_sh + q0 * a.q_ss;
  const TKV* kg = static_cast<const TKV*>(a.k) + b * a.k_sb + hkv * a.k_sh;
  const TKV* vg = static_cast<const TKV*>(a.v) + b * a.v_sb + hkv * a.v_sh;
  TQ* og = static_cast<TQ*>(a.out) + b * a.o_sb + hq * a.o_sh + q0 * a.o_ss;

  load_tile(q_s, hd, qg, a.q_ss, nq, hd, a.scale);
  for (int e = tid; e < nq * hd; e += kThreads) acc_s[e] = 0.f;
  if (tid < nq) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    qpos_s[tid] = a.q_pos[q0 + tid];
  }

  const int warp = tid / 32, lane = tid % 32;
  for (int kv0 = 0; kv0 < a.Skv; kv0 += kBlockKV) {
    const int nk = min(kBlockKV, a.Skv - kv0);
    __syncthreads();  // the previous tile is consumed before it is overwritten
    load_tile(k_s, kpitch, kg + kv0 * a.k_ss, a.k_ss, nk, hd, 1.f);
    load_tile(v_s, hd, vg + kv0 * a.v_ss, a.v_ss, nk, hd, 1.f);
    if (tid < nk) kvpos_s[tid] = a.kv_pos[kv0 + tid];
    __syncthreads();

    // Scores of the tile; slots past Skv are not keys at all (-inf), masked
    // keys get the finite NEG_INF.
    for (int e = tid; e < nq * kBlockKV; e += kThreads) {
      const int r = e / kBlockKV, j = e - r * kBlockKV;
      float s = -INFINITY;
      if (j < nk) {
        const float* qr = q_s + r * hd;
        const float* kr = k_s + j * kpitch;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
        if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
        const int kp = kvpos_s[j], qp = qpos_s[r];
        bool ok = kp < kPadPos;
        if (a.causal) ok = ok && kp <= qp;
        if (a.window) ok = ok && kp > qp - a.window;
        if (!ok) s = kNegInf;
      }
      s_s[e] = s;
    }
    __syncthreads();

    // Online softmax, one warp per row.
    for (int r = warp; r < nq; r += kWarps) {
      float* sr = s_s + r * kBlockKV;
      float mx = -INFINITY;
      for (int j = lane; j < kBlockKV; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kBlockKV; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v; each thread owns the same (r, d) every tile.
    for (int e = tid; e < nq * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd;
      const float* pr = s_s + r * kBlockKV;
      float acc = acc_s[e] * alpha_s[r];
      for (int j = 0; j < nk; ++j) acc = fmaf(pr[j], v_s[j * hd + d], acc);
      acc_s[e] = acc;
    }
  }

  for (int e = tid; e < nq * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    const float l = fmaxf(l_s[r], 1e-30f);
    og[r * a.o_ss + d] = from_float<TQ>(acc_s[e] / l);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.Hq, (a.Sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<TQ, TKV><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* out, int B, int Sq, int Skv, int Hq, int Hkv,
    int hd, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
    int v_sb, int v_ss, int v_sh, int o_sb, int o_ss, int o_sh, float scale,
    int causal, int window, float softcap, int q_dtype, int kv_dtype,
    void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_pos = static_cast<const int*>(q_pos);
  a.kv_pos = static_cast<const int*>(kv_pos);
  a.out = out;
  a.Sq = Sq;
  a.Skv = Skv;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.scale = scale;
  a.softcap = softcap;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0) {
    err = launch<float, float>(a, B, s);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(a, B, s);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    err = launch<float, __nv_bfloat16>(a, B, s);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    err = launch<__nv_bfloat16, float>(a, B, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
