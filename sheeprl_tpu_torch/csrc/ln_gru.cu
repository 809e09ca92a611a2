// LayerNorm-GRU sequence kernels for Hopper (sm_90a), bound with ctypes.
//
// Port of the two Pallas TPU kernels of sheeprl_tpu/ops/pallas_gru.py:
//   ln_gru_fwd    replaces _pallas_forward  (pallas_gru.py:106-150)
//   ln_gru_bwd    replaces _pallas_backward (pallas_gru.py:153-268), together
//   ln_gru_wgrad  with the dW/dscale/dbias accumulation of that kernel body.
//
// Per step t and batch row b (eps 1e-3, two-pass LN statistics):
//   h_in = (1 - f) h + f h_first[b]
//   y    = LN([x, h_in] W) * scale + bias          W: [F+H, 3H] row-major
//   r = sigmoid(y_r), c = tanh(r y_c), u = sigmoid(y_u - 1)
//   h'   = u c + (1 - u) h_in
//
// Design. A TPU grid runs in order on one core, so the Pallas kernels carry
// h (and the recurrent cotangent) in VMEM scratch from one grid step to the
// next. CUDA blocks run in parallel and in no order, so the sequential axis
// becomes a loop INSIDE a block, and the grid runs over what is independent:
// the batch rows, whose recurrences never interact. Each of ln_gru_fwd and
// ln_gru_bwd is one block per batch row (grid = B), looping over t.
//   * The [F+H] input row lives in shared memory; threads own 4-column
//     groups of the 3H output and stream W row by row as float4, consecutive
//     threads on consecutive columns (coalesced); the rows are split between
//     up to 4 thread groups so that more loads are in flight. W (6 MiB at
//     DreamerV3-S) does not fit shared memory but stays in the 50 MB L2
//     across steps and blocks.
//   * The LayerNorm over 3H uses block reductions; the gates join columns H
//     apart, so a barrier separates the matvec from the gate math.
//   * ln_gru_bwd recomputes y_raw from the saved hidden states (as the Pallas
//     kernel does), runs the cell and LN backward, and computes
//     dxh = dy_raw W^T with one warp per row of W (float4 loads) and a warp
//     reduction. The
//     recurrent cotangent and the dh_first accumulator are per row, so no
//     atomics are needed. It writes dy, dy_raw, yn and xh per (t, b) to
//     scratch, and ln_gru_wgrad reduces them over all T*B rows:
//     dW = xh^T dy_raw (tiled shared-memory SGEMM), dscale = sum dy*yn,
//     dbias = sum dy. Every sum has a fixed order: results are deterministic.
//
// Bound. At DreamerV3-S (T=64, B=16, F=H=512) the forward does
// 2*T*B*(F+H)*3H = 3.2 GFLOP of f32 FMA, the backward about twice that (the
// recompute and dX), ln_gru_wgrad another 3.2 GFLOP; all three are bound by
// operations (f32 outside the tensor cores), not bytes. This first version
// keeps only B=16 of the 132 SMs busy in ln_gru_fwd/ln_gru_bwd and runs at a
// small fraction of that bound. The next step is a redesign: the 3H columns
// of a row split across a thread block cluster (LN statistics through
// distributed shared memory) and the per-step product on the tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 768;
constexpr int kPsum = 4 * kThreads;  // floats of the matvec's partial rows

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }
constexpr float kEps = 1e-3f;

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block, returned to every thread. `red` holds >= 32 floats.
// The leading barrier also publishes every shared write made before the call.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < nw; ++i) s += red[i];
  return s;
}

// y = xh · W for one row (N a multiple of 4). W is read as float4 (4
// consecutive columns per thread and load); when the block has threads to
// spare, the K rows are split between G <= 4 groups of threads so that more
// loads are in flight, and the groups' partial rows ([G, N] in `psum`, at
// most kPsum floats) are added in a fixed order. Afterwards thread t owns the
// columns t + m * blockDim.x of y; returns its partial sum of them. y and
// psum are 16-byte aligned.
__device__ float matvec_rows(const float* __restrict__ xh, const float* __restrict__ W,
                             float* __restrict__ y, float* __restrict__ psum, int K, int N) {
  const int NV = N >> 2, nt = blockDim.x;
  const int G = max(1, min(4, nt / NV));
  const int kc = (K + G - 1) / G;
  const float4* W4 = reinterpret_cast<const float4*>(W);
  float* dst = G == 1 ? y : psum;
  for (int e = threadIdx.x; e < G * NV; e += nt) {
    const int g = e / NV, c = e - g * NV;
    const int k0 = g * kc, k1 = min(K, k0 + kc);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* wp = W4 + (size_t)k0 * NV + c;
#pragma unroll 8
    for (int k = k0; k < k1; ++k, wp += NV) {
      const float x = xh[k];
      const float4 w = __ldg(wp);
      acc.x = fmaf(x, w.x, acc.x);
      acc.y = fmaf(x, w.y, acc.y);
      acc.z = fmaf(x, w.z, acc.z);
      acc.w = fmaf(x, w.w, acc.w);
    }
    reinterpret_cast<float4*>(dst)[e] = acc;
  }
  __syncthreads();
  float part = 0.f;
  for (int j = threadIdx.x; j < N; j += nt) {
    float v = dst[j];
    for (int g = 1; g < G; ++g) v += psum[g * N + j];
    if (G > 1) y[j] = v;
    part += v;
  }
  return part;
}

// LN statistics of y over N (two passes: mean, then mean squared deviation).
__device__ void ln_stats(const float* y, float part, int N, float* red, float* mu, float* istd) {
  const float m = block_sum(part, red) / N;
  float sq = 0.f;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float d = y[j] - m;
    sq += d * d;
  }
  const float var = block_sum(sq, red) / N;
  *mu = m;
  *istd = rsqrtf(var + kEps);
}

// ln_gru_fwd: replaces _pallas_forward. Bound: operations, 2*T*B*(F+H)*3H f32
// FMA work (0.048 ms at DV3-S on a 67 TFLOP/s H100). One block per batch row,
// time loop inside, W streamed from L2 every step (see the note above).
__global__ void __launch_bounds__(kThreads)
ln_gru_fwd_kernel(const float* __restrict__ feats, const float* __restrict__ first,
                  const float* __restrict__ h_first, const float* __restrict__ W,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  float* __restrict__ out, int T, int B, int F, int H) {
  extern __shared__ __align__(16) float smem[];
  const int K = F + H, N = 3 * H, b = blockIdx.x;
  float* psum = smem;            // [kPsum]
  float* xh = psum + kPsum;      // [K]: x_t, then the carry h (reset-blended in place)
  float* y = xh + pad4(K);       // [N]
  float* red = y + pad4(N);      // [32]
  for (int j = threadIdx.x; j < H; j += blockDim.x) xh[F + j] = 0.f;

  for (int t = 0; t < T; ++t) {
    const int row = t * B + b;
    const float f = first[row];
    for (int k = threadIdx.x; k < F; k += blockDim.x) xh[k] = feats[(size_t)row * F + k];
    for (int j = threadIdx.x; j < H; j += blockDim.x)
      xh[F + j] = (1.f - f) * xh[F + j] + f * h_first[(size_t)b * H + j];
    __syncthreads();

    const float part = matvec_rows(xh, W, y, psum, K, N);
    float mu, istd;
    ln_stats(y, part, N, red, &mu, &istd);

    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float yr = (y[j] - mu) * istd * scale[j] + bias[j];
      const float yc = (y[H + j] - mu) * istd * scale[H + j] + bias[H + j];
      const float yu = (y[2 * H + j] - mu) * istd * scale[2 * H + j] + bias[2 * H + j];
      const float r = sigmoidf_(yr);
      const float c = tanhf(r * yc);
      const float u = sigmoidf_(yu - 1.f);
      const float h_new = u * c + (1.f - u) * xh[F + j];
      xh[F + j] = h_new;
      out[(size_t)row * H + j] = h_new;
    }
    __syncthreads();
  }
}

// ln_gru_bwd: replaces the reverse sweep of _pallas_backward. Bound:
// operations, twice the forward's (the recompute and dX; 0.096 ms at DV3-S).
// One block per batch row, reverse time loop inside; the weight gradient is
// left to ln_gru_wgrad through the scratch rows this kernel writes.
__global__ void __launch_bounds__(kThreads)
ln_gru_bwd_kernel(const float* __restrict__ feats, const float* __restrict__ first,
                  const float* __restrict__ hs, const float* __restrict__ h_first,
                  const float* __restrict__ W, const float* __restrict__ scale,
                  const float* __restrict__ bias, const float* __restrict__ g,
                  float* __restrict__ dfeats, float* __restrict__ dh_first,
                  float* __restrict__ dy_out, float* __restrict__ dyraw_out,
                  float* __restrict__ yn_out, float* __restrict__ xh_out,
                  int T, int B, int F, int H) {
  extern __shared__ __align__(16) float smem[];
  const int K = F + H, N = 3 * H, b = blockIdx.x;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float* psum = smem;             // [kPsum]
  float* xh = psum + kPsum;       // [K]  [x_t, h_in]
  float* yn = xh + pad4(K);       // [N]  y_raw, then normalised in place
  float* dy = yn + pad4(N);       // [N]  cotangent of the affine output y
  float* dyr = dy + pad4(N);      // [N]  cotangent of y_raw
  float* dh = dyr + pad4(N);      // [H]  recurrent cotangent flowing into step t
  float* dhin = dh + pad4(H);     // [H]  cotangent of h_in
  float* dhf = dhin + pad4(H);    // [H]  dh_first accumulator of this row
  float* red = dhf + pad4(H);     // [32]
  for (int j = threadIdx.x; j < H; j += blockDim.x) { dh[j] = 0.f; dhf[j] = 0.f; }

  for (int t = T - 1; t >= 0; --t) {
    const int row = t * B + b;
    const float f = first[row];
    // ---- recompute the step's forward pre-activations ----
    for (int k = threadIdx.x; k < F; k += blockDim.x) xh[k] = feats[(size_t)row * F + k];
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float hp = t > 0 ? hs[((size_t)(t - 1) * B + b) * H + j] : 0.f;
      xh[F + j] = (1.f - f) * hp + f * h_first[(size_t)b * H + j];
    }
    __syncthreads();
    const float part = matvec_rows(xh, W, yn, psum, K, N);
    float mu, istd;
    ln_stats(yn, part, N, red, &mu, &istd);
    for (int j = threadIdx.x; j < N; j += blockDim.x) yn[j] = (yn[j] - mu) * istd;
    __syncthreads();

    // ---- cell backward ----
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float y_r = yn[j] * scale[j] + bias[j];
      const float y_c = yn[H + j] * scale[H + j] + bias[H + j];
      const float y_u = yn[2 * H + j] * scale[2 * H + j] + bias[2 * H + j];
      const float r = sigmoidf_(y_r);
      const float c = tanhf(r * y_c);
      const float u = sigmoidf_(y_u - 1.f);
      const float h_in = xh[F + j];
      const float d = g[(size_t)row * H + j] + dh[j];
      const float du = d * (c - h_in);
      const float dc = d * u;
      dhin[j] = d * (1.f - u);
      const float d_rc = dc * (1.f - c * c);
      const float dr = d_rc * y_c;
      dy[j] = dr * r * (1.f - r);
      dy[H + j] = d_rc * r;
      dy[2 * H + j] = du * u * (1.f - u);
    }

    // ---- affine + LayerNorm backward over N = 3H ----
    float s1 = 0.f, s2 = 0.f;
    __syncthreads();
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const float dyn = dy[j] * scale[j];
      s1 += dyn;
      s2 += dyn * yn[j];
    }
    const float m1 = block_sum(s1, red) / N;
    const float m2 = block_sum(s2, red) / N;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const float v = istd * (dy[j] * scale[j] - m1 - yn[j] * m2);
      dyr[j] = v;
      const size_t o = (size_t)row * N + j;
      dy_out[o] = dy[j];
      dyraw_out[o] = v;
      yn_out[o] = yn[j];
    }
    for (int k = threadIdx.x; k < K; k += blockDim.x) xh_out[(size_t)row * K + k] = xh[k];
    __syncthreads();

    // ---- dxh = dy_raw W^T: one warp per row of W, float4 loads ----
    const int NV = N >> 2;
    const float4* dyr4 = reinterpret_cast<const float4*>(dyr);
    for (int k = wid; k < K; k += nw) {
      const float4* wr = reinterpret_cast<const float4*>(W) + (size_t)k * NV;
      float s = 0.f;
      for (int c = lane; c < NV; c += 32) {
        const float4 w = __ldg(wr + c), d = dyr4[c];
        s = fmaf(d.x, w.x, fmaf(d.y, w.y, fmaf(d.z, w.z, fmaf(d.w, w.w, s))));
      }
      s = warp_sum(s);
      if (lane == 0) {
        if (k < F) dfeats[(size_t)row * F + k] = s;
        else dhin[k - F] += s;
      }
    }
    __syncthreads();

    // ---- the reset mask routes the carry cotangent ----
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      dh[j] = (1.f - f) * dhin[j];
      dhf[j] += f * dhin[j];
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < H; j += blockDim.x) dh_first[(size_t)b * H + j] = dhf[j];
}

// ln_gru_wgrad: replaces the dW/dscale/dbias accumulators of _pallas_backward.
// Bound: operations, 2*T*B*(F+H)*3H (0.048 ms at DV3-S). A plain tiled
// shared-memory SGEMM over all T*B rows, one output tile per block, so no two
// blocks write one output and the sums have a fixed order. Each thread owns a
// 4x4 block of adjacent outputs, so one stage row costs it two 16-byte
// shared-memory reads for 16 FMAs. Stages are double-buffered: the global
// loads of stage s+1 are in flight while stage s is multiplied.
constexpr int kTile = 64;   // dW tile: kTile rows (k) x kTile columns (j)
constexpr int kDepth = 16;  // rows of xh / dy_raw per shared-memory stage
constexpr int kWgradThreads = 256;
constexpr int kPer = kDepth * kTile / kWgradThreads;  // stage elements a thread loads

// dW[K, N] = xh[M, K]^T dy_raw[M, N]; the extra row of blocks
// (blockIdx.y == gridDim.y - 1) computes dscale = sum_m dy*yn and
// dbias = sum_m dy for its kTile columns. Four blocks fit an SM, so at
// DV3-S the 384 tile blocks and 24 column-sum blocks run in one wave.
__global__ void __launch_bounds__(kWgradThreads, 4)
ln_gru_wgrad_kernel(const float* __restrict__ xh, const float* __restrict__ dyr,
                    const float* __restrict__ dy, const float* __restrict__ yn,
                    float* __restrict__ dW, float* __restrict__ dscale, float* __restrict__ dbias,
                    int M, int K, int N) {
  const int j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  if (blockIdx.y == gridDim.y - 1) {
    __shared__ float ps[4][kTile], pb[4][kTile];
    const int c = tid % kTile, p = tid / kTile, j = j0 + c;
    float s1 = 0.f, s2 = 0.f;
    if (j < N) {
#pragma unroll 8
      for (int m = p; m < M; m += 4) {
        const float d = dy[(size_t)m * N + j];
        s1 = fmaf(d, yn[(size_t)m * N + j], s1);
        s2 += d;
      }
    }
    ps[p][c] = s1;
    pb[p][c] = s2;
    __syncthreads();
    if (p == 0 && j < N) {
      dscale[j] = ((ps[0][c] + ps[1][c]) + ps[2][c]) + ps[3][c];
      dbias[j] = ((pb[0][c] + pb[1][c]) + pb[2][c]) + pb[3][c];
    }
    return;
  }
  const int k0 = blockIdx.y * kTile;
  __shared__ __align__(16) float As[2][kDepth][kTile];  // xh rows m, columns k
  __shared__ __align__(16) float Bs[2][kDepth][kTile];  // dy_raw rows m, columns j
  // thread (tx, ty) owns dW rows k0 + 4ty .. +3 and columns j0 + 4tx .. +3
  const int tx = tid % 16, ty = tid / 16;
  float ra[kPer], rb[kPer];
  auto load = [&](int m0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kWgradThreads * i, r = e / kTile, c = e % kTile, m = m0 + r;
      ra[i] = (m < M && k0 + c < K) ? xh[(size_t)m * K + k0 + c] : 0.f;
      rb[i] = (m < M && j0 + c < N) ? dyr[(size_t)m * N + j0 + c] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kWgradThreads * i;
      As[buf][e / kTile][e % kTile] = ra[i];
      Bs[buf][e / kTile][e % kTile] = rb[i];
    }
  };
  float acc[4][4] = {};
  load(0);
  store(0);
  __syncthreads();
  for (int m0 = 0, buf = 0; m0 < M; m0 += kDepth, buf ^= 1) {
    const bool next = m0 + kDepth < M;
    if (next) load(m0 + kDepth);
#pragma unroll
    for (int r = 0; r < kDepth; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][r][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][r][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bq[q], acc[i][q]);
    }
    // the other buffer was last read before the previous barrier
    if (next) store(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 4 * tx + q;
      if (k < K && j < N) dW[(size_t)k * N + j] = acc[i][q];
    }
  }
}

int launch_checked(const void* fn, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Shared-memory bytes of one block (the Python fit check uses the same sums).
extern "C" size_t ln_gru_fwd_smem_bytes(int F, int H) {
  return (size_t)(kPsum + pad4(F + H) + pad4(3 * H) + 32) * 4;
}
extern "C" size_t ln_gru_bwd_smem_bytes(int F, int H) {
  return (size_t)(kPsum + pad4(F + H) + 3 * pad4(3 * H) + 3 * pad4(H) + 32) * 4;
}

extern "C" const char* ln_gru_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

extern "C" int ln_gru_fwd(const float* feats, const float* first, const float* h_first,
                          const float* W, const float* scale, const float* bias, float* out,
                          int T, int B, int F, int H, void* stream) {
  const size_t smem = ln_gru_fwd_smem_bytes(F, H);
  int rc = launch_checked((const void*)ln_gru_fwd_kernel, smem);
  if (rc) return rc;
  ln_gru_fwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(feats, first, h_first, W, scale,
                                                                 bias, out, T, B, F, H);
  return (int)cudaGetLastError();
}

extern "C" int ln_gru_bwd(const float* feats, const float* first, const float* hs,
                          const float* h_first, const float* W, const float* scale,
                          const float* bias, const float* g, float* dfeats, float* dh_first,
                          float* dy, float* dyraw, float* yn, float* xh, int T, int B, int F,
                          int H, void* stream) {
  const size_t smem = ln_gru_bwd_smem_bytes(F, H);
  int rc = launch_checked((const void*)ln_gru_bwd_kernel, smem);
  if (rc) return rc;
  ln_gru_bwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      feats, first, hs, h_first, W, scale, bias, g, dfeats, dh_first, dy, dyraw, yn, xh, T, B, F, H);
  return (int)cudaGetLastError();
}

extern "C" int ln_gru_wgrad(const float* xh, const float* dyraw, const float* dy, const float* yn,
                            float* dW, float* dscale, float* dbias, int M, int K, int N,
                            void* stream) {
  dim3 grid((N + kTile - 1) / kTile, (K + kTile - 1) / kTile + 1);
  ln_gru_wgrad_kernel<<<grid, kWgradThreads, 0, (cudaStream_t)stream>>>(xh, dyraw, dy, yn, dW, dscale, dbias,
                                                             M, K, N);
  return (int)cudaGetLastError();
}
