// Flash attention forward for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_kernel` of
// src/repro/kernels/flash_attention.py. Same function: GQA attention
// softmax(scale * q k^T -> optional tanh softcap -> position mask) v, with an
// online softmax whose running max, running sum and accumulator stay in fp32.
// Masks come from int32 position vectors: kv_pos >= 2^30 is always masked,
// causal keeps kv_pos <= q_pos, a window keeps kv_pos > q_pos - window.
// Masked scores take the finite NEG_INF, slots past Skv are -inf and the
// running max starts at -inf, as in the reference, so a wholly masked row
// yields mean(v) over all Skv like attend_naive.
//
// Three designs; `plan()` in kernels/flash_attention.py picks one per call.
// The two tensor-core designs take bf16 q and k/v at head_dim 64, 128, 192
// and 256; everything else goes to the CUDA-core design.
//
// 1. Tile kernel (`flash_fwd_tile_kernel`): more than 16 q rows per kv head
//    (Sq * G > 16): training (smollm q [8,512,15,64]; gemma2 q [8,512,8,256],
//    window 4096, softcap 50) and prefill (qwen q [4,32,16,128]; MLA q
//    [4,32,128,192], Hkv = H). Bound by bytes on the H100: 21.0 MB of
//    q/k/v/out at smollm's training shape, 6.3 us at 3.35 TB/s, against 4.1
//    us of bf16 tensor-core operations when causal (8.1 us when not); 50.3 MB
//    at gemma2's, 15.0 us, against 8.7 us of operations causal; the MLA
//    prefill 25.2 MB, 7.5 us; qwen's prefill 0.66 MB, 0.2 us. A block of W
//    warps owns 16 W q rows of one (b, hq), 16 rows a warp. K/V tiles of 64
//    rows stay bf16 in shared memory, double-buffered with 16-byte cp.async
//    so the next tile's copy overlaps this tile's products; rows are padded
//    by 16 bytes (HD + 8 bf16: 144, 272, 400 and 528 B, all 16 mod 128) so
//    ldmatrix reads them without bank conflicts. S = Q K^T and O += P V run
//    on tensor cores (mma.sync m16n8k16 bf16 -> fp32, V through
//    ldmatrix.trans); P is rounded to bf16 in registers and reused as the A
//    operand; row max and sum use quad shuffles. Scores are kept in log2
//    units, so a probability is one FFMA and one ex2. A KV tile is skipped
//    when every pair in it is masked, and takes no mask at all when every
//    pair is attendable, both judged from positions (never indices: a ring
//    cache is unsorted). A row that saw no attendable key takes mean(v) over
//    all Skv in the epilogue.
//    At head_dim 64 and 128 a block is 4 warps (64 q rows) and each thread
//    holds its Q fragments in registers; what holds it back is not its
//    copies but the latency of each warp's chain of products and softmax: 16
//    rows a warp and one barrier a tile leave little to overlap (PERF.md).
//    At head_dim 192 and 256 a thread's O accumulator alone is 96 and 128
//    fp32 registers, and its Q fragments would add 48 and 64: so Q stays in
//    shared memory, and each 16-wide k-step of S = Q K^T loads its fragment
//    by ldmatrix (at 256, 16 of a warp's 144 ldmatrix a K/V tile), leaving
//    O, S (32), m and l in registers: 255 with no spill (`-Xptxas -v`,
//    PERF.md). A block is 8 warps over 128 q rows that share each K/V stage
//    (a warp whose 16 rows all lie past Sq does no products): 2 stages of
//    64-row K and V tiles and the Q tile take 203 KB at 256 (153.6 KB at 192)
//    of the 227 KB a block may have, and 256 threads of 255 registers fill
//    the register file, so one block an SM, 8 warps, and each K/V tile is
//    read from memory once per 128 q rows. The other layout that fits, 4
//    warps over 64 rows with 32-key tiles in three stages, keeps 4 warps an
//    SM and reads each K/V tile twice as often for the same products.
//
// 2. Split-KV decode kernel (`flash_fwd_splitkv_kernel`, then
//    `flash_fwd_combine_kernel` when there is more than one split):
//    Sq * G <= 16 (decode: qwen q [4,1,16,128] over 2 kv heads; gemma2 q
//    [4,1,8,256] over 4). Bound by the bytes of K and V: 0.29 MB at qwen's
//    64-slot cache (0.09 us: the launch bounds it), 16.8 MB at 4096 slots
//    (5.0 us); gemma2's 64 slots 1.1 MB (0.3 us). One block of 4 warps per
//    (split, b, hkv) packs the G q heads (x Sq) of its kv head into the 16
//    rows of one mma tile, so K/V are read once per kv head, not G times. The
//    wrapper splits the keys so that the card gets about two blocks per SM;
//    each warp walks 16 of every 64 keys of its split; the block merges its
//    warps and writes (acc, m, l) in fp32, and the combine, one block per
//    (row, b * Hkv), weights split i by exp(m_i - max m) (0 for a split with
//    no key at all, whose m is -inf; a split of masked keys has m = NEG_INF
//    and counts). One split writes the output directly, with no combine
//    launch. At head_dim 192 and 256, Q stays in shared memory as in the tile
//    kernel; the 16 Q rows and two stages of K and V take 144 KB at 256, and
//    the warps' merge (64 KB of fp32 partials at 256) reuses the K/V stages.
//
// 3. CUDA-core kernel (`flash_fwd_kernel`): the fp32 path, for fp32 q or k/v
//    (TF32 products would miss the fp32 tolerance of 2e-5) and for head dims
//    the tensor-core kernels do not take (8, 24, 32, 96, 160, ...). Each
//    block stages a 16-row q tile and 64-row K/V tiles in fp32 shared memory
//    (16-byte loads, 8 in flight) and computes on CUDA cores. Bound, like the
//    others, by bytes; it is far from them (fp32 FMAs reading operands from
//    shared memory: 385x its bound at gemma2's training shape, PERF.md), which
//    is why bf16 never comes here at head_dim 64, 128, 192 or 256.
//
// Layout: q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd], out [B,Sq,Hq,hd], each with unit
// stride in hd and any other strides that keep rows 16-byte aligned.
//
// C entry `flash_attention_forward` returns a cudaError_t: a launch that is
// refused is reported through cudaGetLastError() right after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 16;
constexpr int kBlockKV = 64;
constexpr int kUnroll = 8;      // 16-byte loads in flight per thread
constexpr float kNegInf = -2.3819763e38f;
constexpr int kPadPos = 1 << 30;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  void* out;
  float* part_acc;  // split-KV partials: [B*Hkv][n_splits][16][hd]
  float* part_ml;   // [B*Hkv][n_splits][2][16]: running max, then sum
  int Sq, Skv, Hq, Hkv, hd;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale, softcap;
  int causal, window;
  int split_len, n_splits;
};

__device__ __forceinline__ bool attendable(int kp, int qp, const Args& a) {
  bool ok = kp < kPadPos;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window) ok = ok && kp > qp - a.window;
  return ok;
}

// ===========================================================================
// 3. CUDA-core kernel (the fp32 path)
// ===========================================================================

// Unpack 16 bytes of T into 16 / sizeof(T) floats.
__device__ __forceinline__ void unpack(const uint4& raw, float* f, float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* f, bf16) {
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
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
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
        if (!attendable(kvpos_s[j], qpos_s[r], a)) s = kNegInf;
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
cudaError_t launch_cuda_core(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.Hq, (a.Sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<TQ, TKV><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ===========================================================================
// Tensor-core kernels: shared tiles (building blocks in mma_sm90.cuh)
// ===========================================================================

constexpr int kRows = 64;        // kv rows of a K/V tile
constexpr int kDecodeRows = 16;  // q rows of a split-KV block: one mma tile

// Shared-memory rows of head_dim bf16 plus 16 bytes: consecutive rows start 16
// bytes apart modulo 128, so the 8 rows an ldmatrix reads hit all 32 banks.
template <int HD>
struct Tiles {
  static constexpr int kPitch = HD + 8;       // bf16 per shared row
  static constexpr int kTile = kRows * kPitch;  // bf16 per K or V tile
  static constexpr int kChunks = HD / 8;      // 16-byte chunks per row
};

__device__ __forceinline__ int warp_min_int(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max_int(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The tensor-core kernels keep scores, m and the combine's weights in log2
// units (times log2 e), so that exp is one ex2 after one FFMA. The NEG_INF of
// a masked key is not scaled: it stays below every real score, exp2(NEG_INF -
// m) is 0 against a real max m and 1 against m = NEG_INF, as exp was
// (kLog2e: mma_sm90.cuh).

// A warp's scores in log2 units, with the mask: scale, softcap, then NEG_INF
// for a masked key and -inf for a slot past the keys. Column j of n-tile n is
// key j0 + 8n + 2t (+1) of the stage, whose positions are ps; qp holds the
// positions of rows g and g + 8.
template <int NT>
__device__ __forceinline__ void mask_scores(float (&s)[NT][4], int j0, int nk, const int* ps,
                                            const int (&qp)[2], int t, const Args& a) {
  if (a.softcap > 0.f) {
    const float in = a.scale / a.softcap, out = a.softcap * kLog2e;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = tanhf(s[n][e] * in) * out;
  } else {
    const float c = a.scale * kLog2e;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= c;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + n * 8 + 2 * t + (e & 1);
      s[n][e] = j >= nk ? -INFINITY : attendable(ps[j], qp[e >> 1], a) ? s[n][e] : kNegInf;
    }
}

// Online-softmax step over one warp's 16 rows and NT n-tiles of scores in the
// mma accumulator layout (s[n][0..1] row g, s[n][2..3] row g+8); the scores in
// log2 units are c * s (c = 1 after `mask_scores`, c = scale * log2 e for raw dot
// products of a tile with no masked pair). Turns s into probabilities and
// rescales o; l keeps each thread's partial row sum (the quad's sum is taken
// once, at the end). A row that has seen no slot at all keeps m = -inf and
// p = 0 without a NaN.
template <int NT, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float (&o)[NO][4],
                                             float (&m)[2], float (&l)[2], float c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * c);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = fast_exp2(m[h] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][2 * h] = fast_exp2(fmaf(s[n][2 * h], c, -m_use));
      s[n][2 * h + 1] = fast_exp2(fmaf(s[n][2 * h + 1], c, -m_use));
      sum += s[n][2 * h] + s[n][2 * h + 1];
    }
    l[h] = l[h] * alpha + sum;
    m[h] = m_new;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * h] *= alpha;
      o[n][2 * h + 1] *= alpha;
    }
  }
}

// Copy `n` K and V rows starting at row kv0 (and their positions) into one
// stage, with NT threads; rows n..63 are zero-filled, so a slot past the keys
// adds 0 * 0. Where NT is a multiple of a row's chunks (head_dim 64, 128,
// 256), each thread copies the same column chunk of every (NT / chunks)-th
// row, so the loop unrolls with no division and one address step per row; at
// 192 (24 chunks a row) the threads walk the tile's chunks in order. The walk
// alone, at every head dim, is slower at 64, 128 and 256 and spills in
// tile<64>, tile<256> and split_kv<256> (repro_torch.tools.flash_copy_ab
// times both builds in turns; PERF.md has the times).
template <int HD, int NT>
__device__ __forceinline__ void load_kv(bf16* ks, bf16* vs, int* ps, const bf16* kg,
                                        const bf16* vg, int kv0, int n, const Args& a) {
  using T = Tiles<HD>;
  if constexpr (NT % T::kChunks == 0) {
    constexpr int kStep = NT / T::kChunks;  // rows apart
    const int r0 = threadIdx.x / T::kChunks, d = (threadIdx.x % T::kChunks) * 8;
    const bf16* kr = kg + (kv0 + r0) * a.k_ss + d;
    const bf16* vr = vg + (kv0 + r0) * a.v_ss + d;
#pragma unroll
    for (int u = 0; u < kRows / kStep; ++u) {
      const int r = r0 + u * kStep;
      const bool in = r < n;  // else a zero fill from a valid address
      cp_async16(ks + r * T::kPitch + d, in ? kr + u * kStep * a.k_ss : kg, in);
      cp_async16(vs + r * T::kPitch + d, in ? vr + u * kStep * a.v_ss : vg, in);
    }
  } else {
    static_assert(kRows * T::kChunks % NT == 0, "a K/V tile's chunks split evenly");
#pragma unroll
    for (int u = 0; u < kRows * T::kChunks / NT; ++u) {
      const int c = threadIdx.x + u * NT;
      const int r = c / T::kChunks, d = (c % T::kChunks) * 8;
      const bool in = r < n;
      cp_async16(ks + r * T::kPitch + d, in ? kg + (kv0 + r) * a.k_ss + d : kg, in);
      cp_async16(vs + r * T::kPitch + d, in ? vg + (kv0 + r) * a.v_ss + d : vg, in);
    }
  }
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    cp_async4(ps + r, a.kv_pos + kv0 + (r < n ? r : 0), r < n);
  }
}

// The A operand of S = Q K^T for a warp's 16 q rows, starting at shared row
// r0, one 16-column k-step at a time. Up to head_dim 128 the fragments of
// every k-step are loaded once into registers (QRegs); above it they would
// not fit beside O, so each k-step reads its fragment from shared memory by
// ldmatrix (QShared).
template <int HD>
__device__ __forceinline__ const bf16* q_frag_addr(const bf16* q_s, int r0, int lane) {
  return q_s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Tiles<HD>::kPitch + (lane >> 4) * 8;
}

template <int HD>
struct QRegs {
  unsigned f[HD / 16][4];
  __device__ __forceinline__ void load(const bf16* q_s, int r0, int lane) {
    const bf16* p = q_frag_addr<HD>(q_s, r0, lane);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) ldsm_x4(f[ks], p + ks * 16);
  }
  __device__ __forceinline__ void get(unsigned (&a)[4], int ks) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = f[ks][i];
  }
};

template <int HD>
struct QShared {
  const bf16* p;
  __device__ __forceinline__ void load(const bf16* q_s, int r0, int lane) {
    p = q_frag_addr<HD>(q_s, r0, lane);
  }
  __device__ __forceinline__ void get(unsigned (&a)[4], int ks) const { ldsm_x4(a, p + ks * 16); }
};

template <int HD>
using QOperand = typename std::conditional<(HD <= 128), QRegs<HD>, QShared<HD>>::type;

// s[n] (n < 2*NP) = Q K^T over the 8 keys of n-tile n, keys from shared row k0.
template <int HD, int NP>
__device__ __forceinline__ void qk(float (&s)[2 * NP][4], const QOperand<HD>& q,
                                   const bf16* ks, int k0, int lane) {
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const bf16* p = ks + (k0 + (lane >> 4) * 8 + (lane & 7)) * Tiles<HD>::kPitch +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks_ = 0; ks_ < HD / 16; ++ks_) {
    unsigned qa[4];
    q.get(qa, ks_);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      unsigned b[4];
      ldsm_x4(b, p + np * 16 * Tiles<HD>::kPitch + ks_ * 16);
      mma_bf16(s[2 * np], qa, b[0], b[1]);
      mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
    }
  }
}

// o += P V for the 16 keys of n-tiles (2kk, 2kk+1) of s, V from shared row v0.
template <int HD, int NT>
__device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&s)[NT][4], int kk,
                                   const bf16* vs, int v0, int lane) {
  const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
  const bf16* p = vs + (v0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * Tiles<HD>::kPitch +
                  (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < HD / 16; ++dp) {
    unsigned b[4];
    ldsm_x4_trans(b, p + dp * 16);
    mma_bf16(o[2 * dp], pa, b[0], b[1]);
    mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
  }
}

// ===========================================================================
// 1. Tile kernel (bf16, training and prefill)
// ===========================================================================

// K/V tiles in flight or in use per block. In trials on the H100 at the
// training shape, 3 or 4 stages were no faster than 2: the kernel does not
// wait on its copies.
constexpr int kTileStages = 2;

// A tile block's shape by head_dim: W warps over 16 W q rows, and the blocks
// per SM it is compiled for, which caps its registers. At head_dim 64, 4
// blocks (128 registers, no spill) ran faster than the 3 that its uncapped
// registers allow (168); at 128 a cap spills the accumulator. At 192 and 256
// shared memory allows one block an SM, so it takes 8 warps (the note at the
// top).
template <int HD>
struct TileShape {
  static constexpr int kWarps = HD > 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowsQ = 16 * kWarps;  // q rows of a block
  static constexpr int kMinBlocks = HD == 64 ? 4 : 1;
};

// Shared memory: Q tile, K and V tiles x kTileStages (bf16, padded rows), kv
// positions x kTileStages, the count and list of KV tiles to visit.
template <int HD>
size_t tile_smem_bytes(int Skv) {
  const int ntiles = (Skv + kRows - 1) / kRows;
  return (TileShape<HD>::kRowsQ * Tiles<HD>::kPitch + 2 * kTileStages * Tiles<HD>::kTile) *
             sizeof(bf16) +
         (kTileStages * kRows + 1 + ntiles) * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(TileShape<HD>::kThreads, TileShape<HD>::kMinBlocks)
    flash_fwd_tile_kernel(const Args a) {
  using T = Tiles<HD>;
  using S = TileShape<HD>;
  constexpr int P = T::kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + S::kRowsQ * P;
  bf16* v_s = k_s + kTileStages * T::kTile;
  int* kvpos_s = reinterpret_cast<int*>(v_s + kTileStages * T::kTile);
  int* count_s = kvpos_s + kTileStages * kRows;
  int* list_s = count_s + 1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / a.Hq, hq = blockIdx.x % a.Hq;
  const int hkv = hq / (a.Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * S::kRowsQ;  // longest causal rows first
  const int nq = min(S::kRowsQ, a.Sq - q0);
  // At 192 and 256 a warp whose rows all lie past Sq skips the products (the
  // MLA prefill's 32 rows leave 6 of 8 warps with none); at 64 and 128 the
  // test made the kernel slower on the card (PERF.md), so it is not compiled.
  const bool idle = HD > 128 && warp * 16 >= nq;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + hq * a.q_sh + q0 * a.q_ss;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + hkv * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + hkv * a.v_sh;
  bf16* og = static_cast<bf16*>(a.out) + b * a.o_sb + hq * a.o_sh + q0 * a.o_ss;

  // The Q tile joins the first copy group; rows past Sq are zero.
  for (int c = tid; c < S::kRowsQ * T::kChunks; c += S::kThreads) {
    const int r = c / T::kChunks, d = (c % T::kChunks) * 8;
    cp_async16(q_s + r * P + d, qg + (r < nq ? r : 0) * a.q_ss + d, r < nq);
  }

  // Which KV tiles hold an attendable pair for some row of this q tile,
  // judged from positions: skipped only when every pair is masked.
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = lane; r < nq; r += 32) {
    const int p = a.q_pos[q0 + r];
    qmin = min(qmin, p);
    qmax = max(qmax, p);
  }
  qmin = warp_min_int(qmin);
  qmax = warp_max_int(qmax);
  // A live tile whose every pair is attendable (all 64 slots keys, none PAD,
  // all inside the mask for every row) is "full": it needs no mask at all.
  const int ntiles = (a.Skv + kRows - 1) / kRows;
  for (int tile = warp; tile < ntiles; tile += S::kWarps) {
    int kmin = INT_MAX, kmax = INT_MIN, kmax_all = INT_MIN;  // kmax: non-PAD slots
    for (int j = lane; j < kRows; j += 32) {
      const int idx = tile * kRows + j;
      if (idx < a.Skv) {
        const int p = a.kv_pos[idx];
        kmin = min(kmin, p);
        kmax_all = max(kmax_all, p);
        if (p < kPadPos) kmax = max(kmax, p);
      }
    }
    kmin = warp_min_int(kmin);
    kmax = warp_max_int(kmax);
    kmax_all = warp_max_int(kmax_all);
    bool live = kmax != INT_MIN;
    bool full = kmax_all < kPadPos && (tile + 1) * kRows <= a.Skv;
    if (a.causal) {
      live = live && kmin <= qmax;
      full = full && kmax_all <= qmin;
    }
    if (a.window) {
      live = live && kmax > qmin - a.window;
      full = full && kmin > qmax - a.window;
    }
    if (lane == 0) list_s[tile] = live ? 1 + full : 0;
  }
  __syncthreads();
  if (warp == 0) {  // compact into the list of live tiles, in order: 2 * tile + full
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int flag = base + lane < ntiles ? list_s[base + lane] : 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, flag != 0);
      if (flag) list_s[n + __popc(ballot & ((1u << lane) - 1))] = 2 * (base + lane) + flag - 1;
      n += __popc(ballot);
    }
    if (lane == 0) *count_s = n;
  }
  __syncthreads();
  const int n_visit = *count_s;

  // Tile i of the list goes to stage i % kTileStages, in copy group i (Q joins
  // group 0); kTileStages - 1 tiles are in flight before the first product.
  auto issue = [&](int i) {
    if (i < n_visit) {
      const int kv0 = (list_s[i] >> 1) * kRows, st = i % kTileStages;
      load_kv<HD, S::kThreads>(k_s + st * T::kTile, v_s + st * T::kTile,
                               kvpos_s + st * kRows, kg, vg, kv0, min(kRows, a.Skv - kv0), a);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kTileStages - 1; ++i) issue(i);

  QOperand<HD> qf;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n_visit; ++i) {
    cp_async_wait<kTileStages - 2>();  // tile i (and Q) have landed
    __syncthreads();  // for every thread; and tile i - 1's stage is free again
    issue(i + kTileStages - 1);
    if (idle) continue;
    if (i == 0) qf.load(q_s, warp * 16, lane);
    const int st = i % kTileStages;
    const bf16* ks = k_s + st * T::kTile;
    const bf16* vs = v_s + st * T::kTile;
    const int* ps = kvpos_s + st * kRows;
    const int entry = list_s[i];
    const int nk = min(kRows, a.Skv - (entry >> 1) * kRows);

    float s[8][4];
    qk<HD, 4>(s, qf, ks, 0, lane);
    if ((entry & 1) && a.softcap == 0.f) {
      softmax_step(s, o, m, l, a.scale * kLog2e);
    } else {
      // The positions of rows g and g + 8, read here rather than held across
      // the loop: at head_dim 64 that keeps 128 registers free of spills.
      int qp[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) qp[h] = a.q_pos[q0 + min(warp * 16 + g + 8 * h, nq - 1)];
      mask_scores(s, 0, nk, ps, qp, t, a);
      softmax_step(s, o, m, l, 1.f);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pv<HD>(o, s, kk, vs, kk * 16, lane);
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: this warp's 16 rows, normalised, as bf16 into its rows of q_s.
  bf16* os = q_s + warp * 16 * P;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<unsigned*>(os + (g + 8 * h) * P + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
  }
  __syncwarp();
  // Rows that met no attendable key (m still NEG_INF or -inf): the skipped
  // tiles held keys of theirs, so they take mean(v) over all Skv here.
  const unsigned lo = __ballot_sync(0xffffffffu, m[0] <= kNegInf);
  const unsigned hi = __ballot_sync(0xffffffffu, m[1] <= kNegInf);
  unsigned rows = 0;
  for (int r = 0; r < 8; ++r)
    rows |= ((lo >> (4 * r)) & 1u) << r | ((hi >> (4 * r)) & 1u) << (r + 8);
  const int real = max(0, min(16, nq - warp * 16));
  rows &= real >= 16 ? 0xffffu : (1u << real) - 1;
  if (rows) {
    constexpr int kPer = HD / 32;  // columns per lane
    float acc[kPer] = {};
    for (int j = 0; j < a.Skv; ++j) {
      const bf16* vr = vg + j * a.v_ss + lane * kPer;
#pragma unroll
      for (int c = 0; c < kPer; ++c) acc[c] += __bfloat162float(vr[c]);
    }
    for (int r = 0; r < 16; ++r)
      if (rows >> r & 1u)
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          os[r * P + lane * kPer + c] = __float2bfloat16(acc[c] / a.Skv);
  }
  __syncwarp();
  for (int c = lane; c < 16 * T::kChunks; c += 32) {
    const int r = c / T::kChunks, d = (c % T::kChunks) * 8;
    const int row = warp * 16 + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(og + row * a.o_ss + d) =
          *reinterpret_cast<const uint4*>(os + r * P + d);
  }
}

template <int HD>
cudaError_t launch_tile(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<HD>(a.Skv);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tile_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int kRowsQ = TileShape<HD>::kRowsQ;
  const dim3 grid(B * a.Hq, (a.Sq + kRowsQ - 1) / kRowsQ);
  flash_fwd_tile_kernel<HD><<<grid, TileShape<HD>::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ===========================================================================
// 2. Split-KV decode kernel and its combine (bf16, Sq * G <= 16)
// ===========================================================================

// Shared memory: 16 Q rows, K and V tiles x 2 stages, kv positions x 2. After
// the loop the K/V stages hold the warps' partials for the block's merge.
template <int HD>
size_t splitkv_smem_bytes() {
  return (kDecodeRows * Tiles<HD>::kPitch + 4 * Tiles<HD>::kTile) * sizeof(bf16) +
         2 * kRows * sizeof(int);
}

// Row r of a split-KV block is q head hkv*G + r % G at query r / G.
__device__ __forceinline__ long long q_row_offset(const Args& a, int b, int hkv, int r) {
  const int G = a.Hq / a.Hkv;
  return b * a.q_sb + (r / G) * a.q_ss + (hkv * G + r % G) * a.q_sh;
}

__device__ __forceinline__ long long o_row_offset(const Args& a, int b, int hkv, int r) {
  const int G = a.Hq / a.Hkv;
  return b * a.o_sb + (r / G) * a.o_ss + (hkv * G + r % G) * a.o_sh;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_splitkv_kernel(const Args a) {
  using T = Tiles<HD>;
  constexpr int P = T::kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kDecodeRows * P;
  bf16* v_s = k_s + 2 * T::kTile;
  int* kvpos_s = reinterpret_cast<int*>(v_s + 2 * T::kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.Hkv, hkv = bh % a.Hkv;
  const int G = a.Hq / a.Hkv, R = a.Sq * G;
  const int k0 = split * a.split_len, k1 = min(k0 + a.split_len, a.Skv);
  const int nchunks = k1 > k0 ? (k1 - k0 + kRows - 1) / kRows : 0;
  const bf16* qg = static_cast<const bf16*>(a.q);
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + hkv * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + hkv * a.v_sh;

  for (int c = tid; c < kDecodeRows * T::kChunks; c += kThreads) {
    const int r = c / T::kChunks, d = (c % T::kChunks) * 8;
    cp_async16(q_s + r * P + d, qg + q_row_offset(a, b, hkv, r < R ? r : 0) + d, r < R);
  }
  if (nchunks > 0)
    load_kv<HD, kThreads>(k_s, v_s, kvpos_s, kg, vg, k0, min(kRows, k1 - k0), a);
  cp_async_commit();

  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qp[h] = a.q_pos[min(g + 8 * h, R - 1) / G];

  QOperand<HD> qf;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < nchunks; ++i) {
    if (i + 1 < nchunks) {
      const int kv0 = k0 + (i + 1) * kRows, st = (i + 1) & 1;
      load_kv<HD, kThreads>(k_s + st * T::kTile, v_s + st * T::kTile, kvpos_s + st * kRows,
                            kg, vg, kv0, min(kRows, k1 - kv0), a);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (i == 0) qf.load(q_s, 0, lane);
    const int st = i & 1;
    const int nk = min(kRows, k1 - (k0 + i * kRows));
    const int* ps = kvpos_s + st * kRows;

    // This warp's 16 keys of the chunk: rows 16*warp .. 16*warp + 15.
    float s[2][4];
    qk<HD, 1>(s, qf, k_s + st * T::kTile, warp * 16, lane);
    mask_scores(s, warp * 16, nk, ps, qp, t, a);
    softmax_step(s, o, m, l, 1.f);
    pv<HD>(o, s, 0, v_s + st * T::kTile, warp * 16, lane);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // Merge the four warps' (m, l, o) through shared memory (over the K/V
  // stages), weighting each by exp2(m_w - max m); a warp that saw no slot has
  // m = -inf and weight 0.
  float* red_o = reinterpret_cast<float*>(k_s);  // [4][16][HD]
  float* red_m = red_o + kWarps * kDecodeRows * HD;  // [4][16]
  float* red_l = red_m + kWarps * kDecodeRows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = warp * kDecodeRows + g + 8 * h;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      red_o[row * HD + n * 8 + 2 * t] = o[n][2 * h];
      red_o[row * HD + n * 8 + 2 * t + 1] = o[n][2 * h + 1];
    }
    if (t == 0) {
      red_m[row] = m[h];
      red_l[row] = l[h];
    }
  }
  __syncthreads();
  const long long part = (static_cast<long long>(bh) * a.n_splits + split) * kDecodeRows;
  for (int e = tid; e < R * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * kDecodeRows + r]);
    float acc = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red_m[w * kDecodeRows + r];
      const float wt = mw == -INFINITY ? 0.f : fast_exp2(mw - mx);
      acc += wt * red_o[(w * kDecodeRows + r) * HD + d];
      sum += wt * red_l[w * kDecodeRows + r];
    }
    if (a.n_splits == 1) {
      static_cast<bf16*>(a.out)[o_row_offset(a, b, hkv, r) + d] = __float2bfloat16(acc / sum);
    } else {
      a.part_acc[(part + r) * HD + d] = acc;
      if (d == 0) {
        a.part_ml[part * 2 + r] = mx;
        a.part_ml[part * 2 + kDecodeRows + r] = sum;
      }
    }
  }
}

// out = sum_i w_i acc_i / sum_i w_i l_i with w_i = exp2(m_i - max m): a split
// with no key (m = -inf) has weight 0; a split of masked keys (m = NEG_INF)
// counts, so a wholly masked row is mean(v) over all Skv. One block per (row,
// b * Hkv): the weights once into shared memory, then one thread per column.
__global__ void __launch_bounds__(kThreads) flash_fwd_combine_kernel(const Args a) {
  extern __shared__ float w_s[];  // [n_splits]
  __shared__ float red[kWarps];
  const int r = blockIdx.x, bh = blockIdx.y, b = bh / a.Hkv, hkv = bh % a.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long part = static_cast<long long>(bh) * a.n_splits * kDecodeRows;
  const float* ml = a.part_ml + part * 2;  // split i: max at [32 i + r], sum at [32 i + 16 + r]
  float mx = -INFINITY;
  for (int i = tid; i < a.n_splits; i += kThreads) mx = fmaxf(mx, ml[i * 2 * kDecodeRows + r]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  float sum = 0.f;
  for (int i = tid; i < a.n_splits; i += kThreads) {
    const float mi = ml[i * 2 * kDecodeRows + r];
    const float w = mi == -INFINITY ? 0.f : fast_exp2(mi - mx);
    w_s[i] = w;
    sum += w * ml[i * 2 * kDecodeRows + kDecodeRows + r];
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = red[0] + red[1] + red[2] + red[3];
  const float* acc_g = a.part_acc + (part + r) * a.hd;
  for (int d = tid; d < a.hd; d += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < a.n_splits; ++i)
      acc += w_s[i] * acc_g[static_cast<long long>(i) * kDecodeRows * a.hd + d];
    static_cast<bf16*>(a.out)[o_row_offset(a, b, hkv, r) + d] = __float2bfloat16(acc / sum);
  }
}

template <int HD>
cudaError_t launch_splitkv(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = splitkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_splitkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_splits, B * a.Hkv);
  flash_fwd_splitkv_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  const dim3 rows(a.Sq * (a.Hq / a.Hkv), B * a.Hkv);
  flash_fwd_combine_kernel<<<rows, kThreads, a.n_splits * sizeof(float), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 = CUDA-core kernel, 1 = tile kernel, 2 = split-KV (+ combine when
// n_splits > 1). dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t
// (0 = success); cudaErrorInvalidValue for a shape or type the variant does
// not take.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* out, int B, int Sq, int Skv, int Hq, int Hkv,
    int hd, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
    int v_sb, int v_ss, int v_sh, int o_sb, int o_ss, int o_sh, float scale,
    int causal, int window, float softcap, int q_dtype, int kv_dtype,
    int variant, int split_len, int n_splits, void* part_acc, void* part_ml,
    void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_pos = static_cast<const int*>(q_pos);
  a.kv_pos = static_cast<const int*>(kv_pos);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
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
  a.split_len = split_len;
  a.n_splits = n_splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16_in = q_dtype == 1 && kv_dtype == 1;
  if (variant == 1) {
    if (!bf16_in) return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
      case 64: return static_cast<int>(launch_tile<64>(a, B, s));
      case 128: return static_cast<int>(launch_tile<128>(a, B, s));
      case 192: return static_cast<int>(launch_tile<192>(a, B, s));
      case 256: return static_cast<int>(launch_tile<256>(a, B, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant == 2) {
    if (!bf16_in || Sq * (Hq / Hkv) > kDecodeRows || n_splits < 1 || split_len < 1 ||
        n_splits * sizeof(float) > 48 * 1024 ||
        (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
      case 64: return static_cast<int>(launch_splitkv<64>(a, B, s));
      case 128: return static_cast<int>(launch_splitkv<128>(a, B, s));
      case 192: return static_cast<int>(launch_splitkv<192>(a, B, s));
      case 256: return static_cast<int>(launch_splitkv<256>(a, B, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0) {
    err = launch_cuda_core<float, float>(a, B, s);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    err = launch_cuda_core<bf16, bf16>(a, B, s);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    err = launch_cuda_core<float, bf16>(a, B, s);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    err = launch_cuda_core<bf16, float>(a, B, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
