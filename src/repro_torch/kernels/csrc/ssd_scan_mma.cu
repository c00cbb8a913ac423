// Mamba2 SSD chunked scan on Hopper's tensor cores (sm_90a), bf16, bound
// through a plain C entry: the "mma" design of kernels/ssd_scan.py, which
// `plan()` picks for bf16 x, B, C with p in {16, 32, 64, 128}, n in
// {16, ..., 256} (p * n <= 16384), a chunk that is a multiple of 16 up to 256
// and 16-byte-aligned rows. Everything else goes to the CUDA-core kernel of
// ssd_scan.cu (the fp32 path).
//
// Replaces the Pallas TPU kernel `ssd_scan` / `_kernel` of
// src/repro/kernels/ssd_scan.py. Same function, for each (batch, head), with
// the chunks of Q steps in order (cs = inclusive cumsum of dt * A):
//   y     = (C B^T o L o dt) x + (C o exp(cs)) state^T + D x,
//           L[q,k] = exp(cs_q - cs_k) for k <= q, else 0
//   state = state * exp(cs_last) + (x o dt o exp(cs_last - cs))^T B
// The state starts at zero and is written out in bf16 after the last chunk.
//
// What bounds it on the H100: at the mamba2 training shape (x [8,512,32,64]
// bf16, B/C [8,512,1,128], chunk 256) a call must move 40.4 MB (x and y 16.8
// MB each, the final state 4.2 MB, B, C and dt 2.6 MB), 12.1 us at 3.35 TB/s,
// and does 10.8 GFLOP of products over the causal pairs, 10.9 us at the bf16
// tensor-core peak: bytes bound it, with the operations close behind. What
// the design does about each:
// - One block of 8 warps per (batch, head) walks the chunks in order and
//   carries the P x N state in fp32 registers (each warp a 16 x 8T slab of
//   m16n8 accumulator tiles), so the state never goes to device memory
//   between chunks and x, B, C are read once: one launch a call.
// - A chunk's C, B and x land in shared memory whole (bf16, rows padded by 16
//   bytes so that ldmatrix reads 8 rows without bank conflicts) through
//   16-byte cp.async; the next chunk's C is copied during the state update,
//   and its dt is loaded then too. 196 KB at the training shape: one block
//   an SM, 256 blocks in two waves (128, one wave, at prefill).
// - All four products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//   fp32 accumulators): S = C B^T over the causal 16 x 16 tiles only (tiles
//   above the diagonal are skipped, the diagonal tile is masked in
//   registers); S~ = S o L o dt is formed in registers, rounded to bf16 and
//   reused as the A operand of S~ x (x through ldmatrix.trans); C state^T
//   reads the state's bf16 copy in shared memory (the plain version rounds
//   the carried state to bf16 there too), skipped on the first chunk; the
//   state update x~^T B takes x~ = x o dt o exp(cs_last - cs) as A operand
//   through ldmatrix.trans, scaled in registers and rounded to bf16.
// - A warp's C fragments stay in registers over its q tile; warp w takes q
//   tiles w and Q/16 - 1 - w, so the causal work is the same for every warp.
// - Decays are exp2 of differences of cumsums kept in log2 units, masked to
//   -inf above the diagonal before the exp and never a ratio of exps; every
//   difference is <= 0 (dt >= 0, A < 0), so nothing overflows.
// Registers (-Xptxas -v, CUDA 12.8, sm_90a): 255 and no spill for the
// instance the model uses (p 64, n 128); the largest instances spill a little
// (p 128, n 128: 48 bytes; p 64, n 256: 8 bytes), the others use 145-255.
//
// Layout: x [b,l,h,p], B/C [b,l,g,n] bf16 with unit stride in the last dim,
// every other stride and the base pointers 16-byte aligned; dt [b,l,h] fp32
// with any strides; A, D [h] fp32; y [b,l,h,p] and state [b,h,p,n] bf16
// contiguous. C entry `ssd_scan_mma_forward` returns a cudaError_t: a launch
// that is refused is reported through cudaGetLastError() right after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 16;          // q rows of an mma tile; keys of a k step
constexpr int kMaxChunk = kThreads;   // one cumsum element per thread
constexpr int kMaxState = 16384;      // p * n: the state's registers
constexpr long long kMaxSmem = 232448;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  void* y;
  void* state;
  int L, H, G, Q;
  long long x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh;
  long long B_sb, B_sl, B_sg, C_sb, C_sl, C_sg;
};

// Dynamic shared memory: C and B [Q][N+8], x [Q][P+8], the bf16 state
// [P][N+8]; cs, dt and the state weights [Q] and the scan's warp sums, fp32.
long long smem_bytes(int P, int N, int Q) {
  return 2LL * (2LL * Q * (N + 8) + (long long)Q * (P + 8) + (long long)P * (N + 8)) +
         4LL * (3LL * Q + kWarps);
}

// `rows` rows of COLS bf16 from global (row stride `sl`) into shared rows of
// COLS + 8, 16 bytes a copy.
template <int COLS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long sl,
                                           int rows) {
  constexpr int kChunks = COLS / 8, kPitch = COLS + 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, k = (c % kChunks) * 8;
    cp_async16(dst + r * kPitch + k, src + r * sl + k, true);
  }
}

__device__ __forceinline__ unsigned scale_bf16x2(unsigned v, float2 w) {
  const float2 f = unpack_bf16(v);
  return pack_bf16(f.x * w.x, f.y * w.y);
}

// One q tile of 16 rows from q0 = 16 * mi: y = exp(cs_q) C state^T (unless
// the state is still zero) + sum over the k tiles up to the diagonal of
// (C B^T o L o dt) x, + D x; written to y in bf16.
template <int P, int N>
__device__ __forceinline__ void y_tile(int mi, bool with_state, const bf16* c_s,
                                       const bf16* b_s, const bf16* x_s,
                                       const bf16* st_s, const float* cs_s,
                                       const float* dt_s, float Dh, bf16* yc,
                                       long long y_sl, int lane) {
  constexpr int NP = N + 8, PP = P + 8;
  const int g = lane / 4, t = lane % 4, q0 = mi * kRowTile;
  unsigned cf[N / 16][4];
  {
    const bf16* p = c_s + (q0 + (lane & 7) + ((lane >> 3) & 1) * 8) * NP + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) ldsm_x4(cf[ks], p + ks * 16);
  }
  float o[P / 8][4];
#pragma unroll
  for (int n = 0; n < P / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const float cs0 = cs_s[q0 + g], cs1 = cs_s[q0 + g + 8];

  if (with_state) {  // C state^T: the state's p rows are the B operand's n
    const bf16* p = st_s + ((lane >> 4) * 8 + (lane & 7)) * NP + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks)
#pragma unroll
      for (int np = 0; np < P / 16; ++np) {
        unsigned bq[4];
        ldsm_x4(bq, p + np * 16 * NP + ks * 16);
        mma_bf16(o[2 * np], cf[ks], bq[0], bq[1]);
        mma_bf16(o[2 * np + 1], cf[ks], bq[2], bq[3]);
      }
    const float e0 = fast_exp2(cs0), e1 = fast_exp2(cs1);
#pragma unroll
    for (int n = 0; n < P / 8; ++n) {
      o[n][0] *= e0;
      o[n][1] *= e0;
      o[n][2] *= e1;
      o[n][3] *= e1;
    }
  }

  const bf16* pb = b_s + ((lane >> 4) * 8 + (lane & 7)) * NP + ((lane >> 3) & 1) * 8;
  const bf16* px = x_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * PP + (lane >> 4) * 8;
  const int r0 = q0 + g, r1 = q0 + g + 8;
  for (int kk = 0; kk <= mi; ++kk) {
    const int k0 = kk * kRowTile;
    float s[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      unsigned bq[4];
      ldsm_x4(bq, pb + k0 * NP + ks * 16);
      mma_bf16(s[0], cf[ks], bq[0], bq[1]);
      mma_bf16(s[1], cf[ks], bq[2], bq[3]);
    }
    // S~ = S o exp(cs_q - cs_k) o dt_k for k <= q; the exponent is -inf above
    // the diagonal (only the diagonal tile has such pairs), so exp2 gives 0.
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int k = k0 + n * 8 + 2 * t;
      const float2 csk = *reinterpret_cast<const float2*>(cs_s + k);
      const float2 dtk = *reinterpret_cast<const float2*>(dt_s + k);
      s[n][0] *= dtk.x * fast_exp2(k <= r0 ? cs0 - csk.x : -INFINITY);
      s[n][1] *= dtk.y * fast_exp2(k + 1 <= r0 ? cs0 - csk.y : -INFINITY);
      s[n][2] *= dtk.x * fast_exp2(k <= r1 ? cs1 - csk.x : -INFINITY);
      s[n][3] *= dtk.y * fast_exp2(k + 1 <= r1 ? cs1 - csk.y : -INFINITY);
    }
    const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int dp = 0; dp < P / 16; ++dp) {
      unsigned bx[4];
      ldsm_x4_trans(bx, px + k0 * PP + dp * 16);
      mma_bf16(o[2 * dp], pa, bx[0], bx[1]);
      mma_bf16(o[2 * dp + 1], pa, bx[2], bx[3]);
    }
  }

#pragma unroll
  for (int n = 0; n < P / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = hh ? r1 : r0;
      const float2 xv = unpack_bf16(*reinterpret_cast<const unsigned*>(x_s + r * PP + col));
      *reinterpret_cast<unsigned*>(yc + r * y_sl + col) =
          pack_bf16(o[n][2 * hh] + Dh * xv.x, o[n][2 * hh + 1] + Dh * xv.y);
    }
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_mma_kernel(const Args a) {
  constexpr int NP = N + 8, PP = P + 8;
  constexpr int kStateTiles = (P / 16) * (N / 8);  // m16 x n8 tiles of the state
  constexpr int T = kStateTiles >= kWarps ? kStateTiles / kWarps : 1;  // a warp's
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = a.Q, M = Q / kRowTile;
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* b_s = c_s + Q * NP;
  bf16* x_s = b_s + Q * NP;
  bf16* st_s = x_s + Q * PP;
  float* cs_s = reinterpret_cast<float*>(st_s + P * NP);
  float* dt_s = cs_s + Q;
  float* w_s = dt_s + Q;
  float* red_s = w_s + Q;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int grp = h / (a.H / a.G);
  const float A2 = a.A[h] * kLog2e, Dh = a.D[h];
  const bf16* xg = static_cast<const bf16*>(a.x) + b * a.x_sb + h * a.x_sh;
  const float* dtg = a.dt + b * a.dt_sb + h * a.dt_sh;
  const bf16* Bg = static_cast<const bf16*>(a.B) + b * a.B_sb + grp * a.B_sg;
  const bf16* Cg = static_cast<const bf16*>(a.C) + b * a.C_sb + grp * a.C_sg;
  bf16* yg = static_cast<bf16*>(a.y) + ((long long)b * a.L * a.H + h) * P;
  const long long y_sl = (long long)a.H * P;

  // This warp's slab of the fp32 state: T n8 tiles of rows sp0..sp0+15 from
  // column sn0 (a warp owns none when the state has fewer than 8 tiles).
  const int tile0 = warp * T;
  const bool owns_state = tile0 < kStateTiles;
  const int sp0 = (tile0 / (N / 8)) * 16, sn0 = (tile0 % (N / 8)) * 8;
  float st[T][4];
#pragma unroll
  for (int j = 0; j < T; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;

  stage_rows<N>(c_s, Cg, a.C_sl, Q);
  stage_rows<N>(b_s, Bg, a.B_sl, Q);
  stage_rows<P>(x_s, xg, a.x_sl, Q);
  cp_async_commit();
  float d = tid < Q ? dtg[tid * a.dt_sl] : 0.f;

  for (int l0 = 0; l0 < a.L; l0 += Q) {
    const bool more = l0 + Q < a.L;
    // Inclusive cumsum of dt * A over the chunk, in log2 units: a warp scan,
    // then the sums of the warps before. `total` equals cs[Q - 1] bit for bit.
    float v = d * A2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) red_s[warp] = v;
    __syncthreads();
    float before = 0.f, total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float r = red_s[w];
      if (w < warp) before += r;
      total += r;
    }
    const float cs = v + before;
    if (tid < Q) {
      cs_s[tid] = cs;
      dt_s[tid] = d;
      w_s[tid] = d * fast_exp2(total - cs);
    }
    cp_async_wait<0>();
    __syncthreads();  // this chunk's C, B, x and cs, dt, w are in place

    for (int j = warp; 2 * j < M; j += kWarps) {
      y_tile<P, N>(j, l0 > 0, c_s, b_s, x_s, st_s, cs_s, dt_s, Dh, yg + l0 * y_sl, y_sl,
                   lane);
      if (M - 1 - j != j)
        y_tile<P, N>(M - 1 - j, l0 > 0, c_s, b_s, x_s, st_s, cs_s, dt_s, Dh,
                     yg + l0 * y_sl, y_sl, lane);
    }
    __syncthreads();  // c_s and st_s are read: the next chunk's C may land
    if (more) stage_rows<N>(c_s, Cg + (l0 + Q) * a.C_sl, a.C_sl, Q);
    cp_async_commit();
    const float d_next = more && tid < Q ? dtg[(l0 + Q + tid) * a.dt_sl] : 0.f;

    // state = state * exp(cs_last) + x~^T B, x~ = x o dt o exp(cs_last - cs)
    if (owns_state) {
      const float decay = fast_exp2(total);
#pragma unroll
      for (int j = 0; j < T; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] *= decay;
      const bf16* pa = x_s + ((lane & 7) + ((lane >> 4) & 1) * 8) * PP + sp0 +
                       ((lane >> 3) & 1) * 8;
      const bf16* pb = b_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * NP + (lane >> 4) * 8 + sn0;
      for (int kk = 0; kk < M; ++kk) {
        const int k0 = kk * kRowTile;
        unsigned af[4];
        ldsm_x4_trans(af, pa + k0 * PP);
        const float2 w0 = *reinterpret_cast<const float2*>(w_s + k0 + 2 * t);
        const float2 w1 = *reinterpret_cast<const float2*>(w_s + k0 + 8 + 2 * t);
        af[0] = scale_bf16x2(af[0], w0);
        af[1] = scale_bf16x2(af[1], w0);
        af[2] = scale_bf16x2(af[2], w1);
        af[3] = scale_bf16x2(af[3], w1);
#pragma unroll
        for (int jj = 0; jj < T; jj += 2) {
          unsigned bq[4];
          ldsm_x4_trans(bq, pb + k0 * NP + jj * 8);
          mma_bf16(st[jj], af, bq[0], bq[1]);
          if (jj + 1 < T) mma_bf16(st[jj + 1], af, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // b_s, x_s and w_s are read
    if (owns_state) {  // the bf16 copy the next chunk's C state^T reads
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int n = sn0 + j * 8 + 2 * t;
        *reinterpret_cast<unsigned*>(st_s + (sp0 + g) * NP + n) = pack_bf16(st[j][0], st[j][1]);
        *reinterpret_cast<unsigned*>(st_s + (sp0 + g + 8) * NP + n) =
            pack_bf16(st[j][2], st[j][3]);
      }
    }
    if (more) {
      stage_rows<N>(b_s, Bg + (l0 + Q) * a.B_sl, a.B_sl, Q);
      stage_rows<P>(x_s, xg + (l0 + Q) * a.x_sl, a.x_sl, Q);
    }
    cp_async_commit();
    d = d_next;
  }

  if (owns_state) {
    bf16* sg = static_cast<bf16*>(a.state) + ((long long)b * a.H + h) * P * N;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int n = sn0 + j * 8 + 2 * t;
      *reinterpret_cast<unsigned*>(sg + (sp0 + g) * N + n) = pack_bf16(st[j][0], st[j][1]);
      *reinterpret_cast<unsigned*>(sg + (sp0 + g + 8) * N + n) = pack_bf16(st[j][2], st[j][3]);
    }
  }
}

template <int P, int N>
cudaError_t launch(const Args& a, int batch, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_mma_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan_mma_kernel<P, N><<<batch * a.H, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_p(const Args& a, int N, int batch, int smem, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<P, 16>(a, batch, smem, stream);
    case 32: return launch<P, 32>(a, batch, smem, stream);
    case 64: return launch<P, 64>(a, batch, smem, stream);
    case 128: return launch<P, 128>(a, batch, smem, stream);
    case 256:
      if constexpr (P * 256 <= kMaxState) return launch<P, 256>(a, batch, smem, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, B, C, y, state bf16; dt, A, D fp32. `smem` is the wrapper's count of
// dynamic shared memory, checked here against the layout. Returns a
// cudaError_t (0 = success).
extern "C" int ssd_scan_mma_forward(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    const void* D, void* y, void* state, int batch, int L, int H, int P, int G,
    int N, int Q, int smem, long long x_sb, long long x_sl, long long x_sh,
    long long dt_sb, long long dt_sl, long long dt_sh, long long B_sb,
    long long B_sl, long long B_sg, long long C_sb, long long C_sl,
    long long C_sg, void* stream) {
  const long long need = smem_bytes(P, N, Q);
  const bool strides16 = (x_sb | x_sl | x_sh | B_sb | B_sl | B_sg | C_sb | C_sl | C_sg) % 8 == 0;
  if (batch <= 0 || L <= 0 || H <= 0 || G <= 0 || Q <= 0 || Q % kRowTile ||
      Q > kMaxChunk || L % Q || H % G || (long long)P * N > kMaxState || need != smem ||
      need > kMaxSmem || !strides16 || !aligned16(x) || !aligned16(B) || !aligned16(C))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = B;
  a.C = C;
  a.D = static_cast<const float*>(D);
  a.y = y;
  a.state = state;
  a.L = L; a.H = H; a.G = G; a.Q = Q;
  a.x_sb = x_sb; a.x_sl = x_sl; a.x_sh = x_sh;
  a.dt_sb = dt_sb; a.dt_sl = dt_sl; a.dt_sh = dt_sh;
  a.B_sb = B_sb; a.B_sl = B_sl; a.B_sg = B_sg;
  a.C_sb = C_sb; a.C_sl = C_sl; a.C_sg = C_sg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return static_cast<int>(launch_p<16>(a, N, batch, smem, s));
    case 32: return static_cast<int>(launch_p<32>(a, N, batch, smem, s));
    case 64: return static_cast<int>(launch_p<64>(a, N, batch, smem, s));
    case 128: return static_cast<int>(launch_p<128>(a, N, batch, smem, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
