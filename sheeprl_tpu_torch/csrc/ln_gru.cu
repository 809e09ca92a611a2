// LayerNorm-GRU sequence kernels for Hopper (sm_90a), bound with ctypes.
//
// Port of the two Pallas TPU kernels of sheeprl_tpu/ops/pallas_gru.py:
//   ln_gru_xproj  Gx = feats W_x for all T*B rows           } _pallas_forward
//   ln_gru_fwd    the recurrence on thread-block clusters   } (pallas_gru.py:106-150)
//   ln_gru_bwd    the reverse sweep on the same clusters    } _pallas_backward
//   ln_gru_dx     dfeats = dy_raw W_x^T for all T*B rows    } (pallas_gru.py:153-268)
//   ln_gru_wgrad  dW, dscale, dbias over all T*B rows       }
//
// Per step t and batch row b (eps 1e-3, LN statistics over the 3H columns):
//   h_in = (1 - f) h + f h_first[b]
//   y    = LN(x W_x + h_in W_h) * scale + bias      W = [W_x; W_h]: [F+H, 3H] row-major
//   r = sigmoid(y_r), c = tanh(r y_c), u = sigmoid(y_u - 1)
//   h'   = u c + (1 - u) h_in
//
// Design.
//   * x does not depend on h, so x W_x for all T*B rows (ln_gru_xproj) and,
//     in the backward, dy_raw W_x^T (ln_gru_dx) and the weight gradient
//     xh^T dy_raw (ln_gru_wgrad) are time-parallel GEMMs over the whole card,
//     outside the serial loop: f32 in and out, on the tensor cores in 3xTF32
//     (tf32x3_gemm_kernel, one mainloop for the three operand layouts).
//     ln_gru_wgrad's blocks also sum dscale and dbias, each over its share of
//     the rows, in the same launch.
//   * The recurrence runs on thread-block clusters of NC = H / HS CTAs (16 at
//     DreamerV3-S), one cluster for each group of kRows = 4 batch rows (4
//     clusters, 64 SMs at B = 16). CTA c owns the HS hidden units
//     J_c = [c*HS, (c+1)*HS) and their three gate columns {j, H+j, 2H+j}, so
//     the gate math needs no exchange. It loads its [H, 3*HS] slice of W_h
//     into shared memory once (192 KiB at DV3-S) and keeps it there for all
//     T steps: no block reads W in the loop. That is the resident instance,
//     for H up to 512 (DreamerV3-XS and S); wider H (M, L, XL) takes the
//     streamed instance, which streams the slice through a ring of k-tiles
//     each step (see its note below).
//   * Forward step: y_raw = Gx[t] + h_in W_h on the CTA's columns (FFMA in
//     registers, the H rows of the sum split over the 8 warps and added in
//     warp order); per-row partial LN statistics (mean and M2 over the 3*HS
//     columns) pushed into every CTA of the cluster through distributed
//     shared memory (DSMEM); cluster barrier; the NC partials combined by
//     Chan's formula in CTA order; the gates and h' for J_c; h', already
//     reset-blended for step t+1, staged in shared memory and pushed as one
//     contiguous block of float4 into every CTA's h buffer; second cluster
//     barrier. Every CTA has read h_t before it reaches the first barrier, so
//     one h buffer is enough. The forward saves yn and istd (6 MiB at
//     DV3-S), so the backward recomputes no product.
//   * Backward step: the cell backward for J_c from the saved yn; the LN
//     backward's row sums (sum dyn, sum dyn*yn) pushed through DSMEM like the
//     forward's statistics; dy_raw on the CTA's columns; the partial
//     dh_in = dy_raw[:, cols_c] W_h[:, cols_c]^T over all H units; a
//     reduce-scatter: CTA c pushes the partial of J_d into CTA d's receive
//     buffer, and CTA d adds the NC partials of its units in CTA order; the
//     reset mask routes the cotangent into dh and dh_first. It writes dy,
//     dy_raw and xh for ln_gru_wgrad.
//   * The step's elementwise work is spread over the CTA's threads (one
//     unit x row each at DV3-S), and each DSMEM push is a warp-contiguous
//     span: the cost of a step outside its product is the two barriers and
//     the pushes, not one warp's serial work.
//   Every sum has a fixed order (no atomics): results are deterministic.
//
// Layout. ops/ln_gru.py holds the recurrent kernels' layout and passes it to
// nvcc (LN_GRU_ROWS, LN_GRU_THREADS, LN_GRU_MAX_CLUSTER, LN_GRU_STREAM_STAGES);
// it also picks the instance, the units of a CTA and the streamed instance's
// tile rows, and sums each kernel's shared memory (its fit rule), and the
// entries take them as arguments.
//
// Bound. At DreamerV3-S (T=64, B=16, F=H=512) ln_gru_xproj and ln_gru_dx do
// 2*T*B*F*3H = 1.6 GFLOP each, ln_gru_fwd and ln_gru_bwd 2*T*B*H*3H = 1.6
// GFLOP each, ln_gru_wgrad 3.2 GFLOP: all are bound by operations, not by
// bytes. The f32-accurate floor of each is the faster of f32 outside the
// tensor cores (67 TFLOP/s) and three TF32 products on them (3 x the work at
// 495 TFLOP/s): 0.0098 ms for the first four, 0.0195 ms for ln_gru_wgrad.
// The recurrent kernels occupy NC * ceil(B / kRows) SMs and pay two cluster
// barriers a step; their time is set by that serial chain, not by the FLOPs.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-3f;

// --------------------------------------------------------------------------
// The 3xTF32 GEMMs (ln_gru_xproj, ln_gru_dx, ln_gru_wgrad):
// C[M, NO] = A[M, K] B[K, NO], f32 in and out, on the tensor cores.
//   * Split. Each operand element v is split as big = tf32(v) and
//     small = tf32(v - big), both rounded to nearest with ties away: the bits
//     cvt.rna.tf32.f32 gives, here from adding half of TF32's last bit to the
//     magnitude and clearing the 13 dropped bits (integer operations, which
//     issue faster than the conversion). Per
//     8-deep step of the sum, mma.sync m16n8k8 forms small*big + big*small +
//     big*big (small*small lies below f32's last bit and is dropped). The
//     products of TF32 values are exact; the tensor core rounds its own sums
//     toward zero, so the products go into a partial accumulator that is
//     added to the f32 accumulator with an ordinary add (round to nearest)
//     every kFold steps and cleared: the truncation stays inside one partial
//     and does not build up along the whole sum.
//   * Operands (Gemm below). A is row-major [M, K] (lda; along the sum) or
//     stored along the output, element (m, k) at k * lda + m (ln_gru_wgrad's
//     xh^T: xh [T*B, F+H] read as its transpose). B is row-major [K, NO]
//     (ldb; W_x [F, 3H] of ln_gru_xproj, dy_raw [T*B, 3H] of ln_gru_wgrad)
//     or stored along the sum, element (k, n) at n * ldb + k (ln_gru_dx's W_x
//     read as its transpose). Rows must be 16-byte aligned: the length of
//     each operand's contiguous rows (K or M for A, NO or K for B), NO and
//     the leading dimensions multiples of 4, the pointers 16-byte aligned.
//   * Pipeline. A block computes a BM x BN tile of C with WM x WN warps, each
//     a (BM/WM) x (BN/WN) tile of m16n8 MMA tiles, times kSplitK: the k-steps
//     of a stage are dealt round-robin to kSplitK groups of warps with their
//     own accumulators, added in group order at the end (more warps to hide
//     latency, no more registers a warp). The sum runs in stages of BK
//     through a ring of kStages stages in shared memory, filled by 16-byte
//     cp.async (zero-filled past M, NO and K), with kStages - 1 stages in
//     flight while one is multiplied. Every warp splits the fragment
//     elements it loads (an element of A once for each warp along N, of B
//     once for each warp along M): splitting each stage once into shared
//     memory instead doubled the shared-memory traffic and was slower. Rows
//     are padded so that each fragment load of a warp hits 32 distinct banks:
//     a stage stored along the sum by BK + 4 floats (4 mod 32: lanes gid, tig
//     at 4 gid + tig), one stored along the output (A: BM + 8) or row-major
//     (B: BN + 8) by 8 mod 32 (lanes at 8 tig + gid).
//   * Order. No atomics on floats and no split of the sum over blocks: each
//     output is one block's, and its sum has a fixed order, so the result is
//     the same bits from launch to launch.
// Bound: operations, 3 TF32 products of 2*M*K*NO each at 495 TFLOP/s
// (0.0098 ms for ln_gru_xproj and ln_gru_dx at DreamerV3-S, under f32's
// 0.024 ms without the tensor cores; their bytes take 0.0034 ms).
// --------------------------------------------------------------------------

// The GEMM an instance computes, and with it the operand layouts:
//   kXproj  A along the sum, B row-major;
//   kDx     A along the sum, B along the sum;
//   kWgrad  A along the output, B row-major, and the column sums below.
enum class Gemm { kXproj, kDx, kWgrad };
template <Gemm G>
constexpr bool kAAlongOut = G == Gemm::kWgrad;
template <Gemm G>
constexpr bool kBAlongSum = G == Gemm::kDx;

template <int BM_, int BN_, int BK_, int WM_, int WN_, int kSplitK_, int kStages_, int kFold_>
struct GemmLayout {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, kSplitK = kSplitK_;
  static constexpr int kStages = kStages_, kFold = kFold_;
  static constexpr int kSteps = BK / 8 / kSplitK;  // k-steps of a stage for one group of warps
  static constexpr int kThreads = 32 * WM * WN * kSplitK;
  static constexpr int TM = BM / WM / 16, TN = BN / WN / 8;  // MMA tiles of a warp
  static constexpr int kLdSum = BK + 4;  // row stride of a stage stored along the sum
  static constexpr int kLdRow = BN + 8;  // row stride of a row-major B stage
  static constexpr int kLdOut = BM + 8;  // row stride of an A stage stored along the output
  static_assert(TM * 16 * WM == BM && TN * 8 * WN == BN, "whole MMA tiles");
  static_assert(kSteps * 8 * kSplitK == BK && kSteps % kFold == 0, "whole k-steps a group, whole folds a stage");
  static_assert(BN % 32 == 0, "a row-major B stage is bank-conflict free when BN + 8 = 8 mod 32");
  static_assert((BM * BK / 4) % kThreads == 0 && (BN * BK / 4) % kThreads == 0,
                "the 16-byte chunks of a stage are whole rounds of the block's threads");
  template <Gemm G>
  __host__ __device__ static constexpr int stage_a() { return kAAlongOut<G> ? BK * kLdOut : BM * kLdSum; }
  template <Gemm G>
  __host__ __device__ static constexpr int stage_b() { return kBAlongSum<G> ? BN * kLdSum : BK * kLdRow; }
  template <Gemm G>
  __host__ __device__ static constexpr int smem_bytes() { return 4 * kStages * (stage_a<G>() + stage_b<G>()); }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v -> (tf32(v), tf32(v - tf32(v))), rounded to nearest with ties away.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  small = (__float_as_uint(v - __uint_as_float(big)) + 0x1000u) & 0xFFFFE000u;
}

// d += a b on one m16n8k8 tile (TF32 in, f32 accumulators).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ln_gru_wgrad's column sums, dscale = sum_m dy*yn and dbias = sum_m dy over
// the K rows of the GEMM's sum (dy, yn [K, NO] row-major), spread over its
// blocks: the block at (bx, by) sums rows [by K / gy, (by + 1) K / gy) of its
// BN columns into the partial slot part[by][2][NO], and the last block of
// column tile bx to arrive adds the gy = gridDim.y partials in slot order.
// An arrival counter a column tile and __threadfence() tell it that it is
// last; no atomic adds a float, so the sums have a fixed order. The slots and
// the counters are the launch's own scratch (the wrapper allocates them, the
// counters zeroed), so launches on two streams at once share nothing.
struct ColumnSums {
  const float* dy;
  const float* yn;
  float* part;              // [gridDim.y][2][NO], written before it is read
  unsigned int* arrivals;   // [gridDim.x], zero at the launch
  float* dscale;
  float* dbias;
};

template <class L>
__device__ void column_sums(const ColumnSums& cs, int K, int NO) {
  constexpr int Q = L::BN / 4;         // float4 columns of the tile
  constexpr int P = L::kThreads / Q;   // rows summed side by side, one per group of Q threads
  static_assert(P >= 1, "a block covers its tile's columns");
  __shared__ __align__(16) float red[P][2][L::BN];
  __shared__ bool last;
  const int tid = threadIdx.x, n0 = blockIdx.x * L::BN, gy = gridDim.y;
  const int r0 = (int)((long long)blockIdx.y * K / gy), r1 = (int)((long long)(blockIdx.y + 1) * K / gy);
  if (tid < P * Q) {
    const int q = tid % Q, p = tid / Q, n = n0 + 4 * q;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f), b = s;
    if (n < NO) {
#pragma unroll 4
      for (int k = r0 + p; k < r1; k += P) {
        const float4 d = __ldg(reinterpret_cast<const float4*>(cs.dy + (size_t)k * NO + n));
        const float4 y = __ldg(reinterpret_cast<const float4*>(cs.yn + (size_t)k * NO + n));
        s.x = fmaf(d.x, y.x, s.x), s.y = fmaf(d.y, y.y, s.y), s.z = fmaf(d.z, y.z, s.z), s.w = fmaf(d.w, y.w, s.w);
        b.x += d.x, b.y += d.y, b.z += d.z, b.w += d.w;
      }
    }
    *reinterpret_cast<float4*>(&red[p][0][4 * q]) = s;
    *reinterpret_cast<float4*>(&red[p][1][4 * q]) = b;
  }
  __syncthreads();
  for (int c = tid; c < 2 * L::BN; c += L::kThreads) {  // this block's partial: the P row sums in order
    const int w = c / L::BN, j = c % L::BN, n = n0 + j;
    float v = red[0][w][j];
#pragma unroll
    for (int p = 1; p < P; ++p) v += red[p][w][j];
    if (n < NO) cs.part[((size_t)blockIdx.y * 2 + w) * NO + n] = v;
  }
  __threadfence();  // the partial is visible to every block before this block counts as arrived
  __syncthreads();
  if (tid == 0) last = atomicAdd(&cs.arrivals[blockIdx.x], 1u) == (unsigned)gy - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = tid; c < 2 * L::BN; c += L::kThreads) {  // the gy partials of the column tile, in slot order
    const int w = c / L::BN, n = n0 + c % L::BN;
    if (n >= NO) continue;
    const float* p = cs.part + (size_t)w * NO + n;
    float v = __ldcg(p);
    for (int g = 1; g < gy; ++g) v += __ldcg(p + (size_t)g * 2 * NO);
    (w ? cs.dbias : cs.dscale)[n] = v;
  }
}

template <class L, Gemm G>
__global__ void __launch_bounds__(L::kThreads, 1)
tf32x3_gemm_kernel(const float* __restrict__ A, int lda, const float* __restrict__ Bm, int ldb,
                   float* __restrict__ C, int ldc, int M, int NO, int K, ColumnSums cs) {
  constexpr int BM = L::BM, BN = L::BN, BK = L::BK, TM = L::TM, TN = L::TN, kStages = L::kStages;
  constexpr bool kAOut = kAAlongOut<G>, kBSum = kBAlongSum<G>;
  static_assert(!kAOut || BM % 32 == 0, "an A stage along the output is bank-conflict free when BM + 8 = 8 mod 32");
  constexpr int kLdA = kAOut ? L::kLdOut : L::kLdSum, kLdB = kBSum ? L::kLdSum : L::kLdRow;
  constexpr int kStageA = L::template stage_a<G>(), kStageB = L::template stage_b<G>();
  // strides of an A stage between two rows of the output and two steps of the sum
  constexpr int kARow = kAOut ? 1 : kLdA, kASum = kAOut ? kLdA : 1;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                      // [kStages][BK][kLdA] along the output, else [kStages][BM][kLdA]
  float* Bs = smem + kStages * kStageA;  // [kStages][BN][kLdB] along the sum, else [kStages][BK][kLdB]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // the fragments' row group and thread in group
  const int group = warp / (L::WM * L::WN), wt = warp % (L::WM * L::WN);  // k-step group; warp tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm0 = (wt / L::WN) * TM * 16, wn0 = (wt % L::WN) * TN * 8;

  auto load_stage = [&](int slot, int k0) {
    float* as = As + slot * kStageA;
    if constexpr (kAOut) {
#pragma unroll
      for (int it = 0; it < BK * BM / 4 / L::kThreads; ++it) {  // 16-byte chunks along the output, a row a k
        const int c = tid + it * L::kThreads, r = c / (BM / 4), q = 4 * (c % (BM / 4)), k = k0 + r, m = m0 + q;
        const bool ok = k < K && m < M;
        cp_async16(as + r * kLdA + q, ok ? A + (size_t)k * lda + m : A, ok);
      }
    } else {
#pragma unroll
      for (int it = 0; it < BM * BK / 4 / L::kThreads; ++it) {  // 16-byte chunks, row by row
        const int c = tid + it * L::kThreads, r = c / (BK / 4), q = 4 * (c % (BK / 4)), m = m0 + r, k = k0 + q;
        const bool ok = m < M && k < K;
        cp_async16(as + r * kLdA + q, ok ? A + (size_t)m * lda + k : A, ok);
      }
    }
    float* bs = Bs + slot * kStageB;
    if constexpr (kBSum) {
#pragma unroll
      for (int it = 0; it < BN * BK / 4 / L::kThreads; ++it) {
        const int c = tid + it * L::kThreads, r = c / (BK / 4), q = 4 * (c % (BK / 4)), n = n0 + r, k = k0 + q;
        const bool ok = n < NO && k < K;
        cp_async16(bs + r * kLdB + q, ok ? Bm + (size_t)n * ldb + k : Bm, ok);
      }
    } else {
#pragma unroll
      for (int it = 0; it < BK * BN / 4 / L::kThreads; ++it) {
        const int c = tid + it * L::kThreads, r = c / (BN / 4), q = 4 * (c % (BN / 4)), k = k0 + r, n = n0 + q;
        const bool ok = k < K && n < NO;
        cp_async16(bs + r * kLdB + q, ok ? Bm + (size_t)k * ldb + n : Bm, ok);
      }
    }
  };

  float acc[TM][TN][4] = {}, part[TM][TN][4] = {};
  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s * BK);
    cp_async_commit();
  }
  if constexpr (G == Gemm::kWgrad) column_sums<L>(cs, K, NO);  // while the first stages are in flight
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with the slot of stage kt - 1
    if (kt + kStages - 1 < KT) load_stage((kt + kStages - 1) % kStages, (kt + kStages - 1) * BK);
    cp_async_commit();
    const int slot = kt % kStages;
#pragma unroll
    for (int s = 0; s < L::kSteps; ++s) {
      const int k = 8 * (s * L::kSplitK + group);  // this group's k-step
      uint32_t a_big[TM][4], a_small[TM][4], b_big[TN][2], b_small[TN][2];
      const float* as = As + slot * kStageA + (wm0 + gid) * kARow + (tig + k) * kASum;
      const float* bs = Bs + slot * kStageB + (kBSum ? (wn0 + gid) * kLdB + tig + k : (tig + k) * kLdB + wn0 + gid);
#pragma unroll
      for (int i = 0; i < TM; ++i) {  // rows gid, gid + 8; columns tig, tig + 4
        const float* p = as + i * 16 * kARow;
        split_tf32(p[0], a_big[i][0], a_small[i][0]);
        split_tf32(p[8 * kARow], a_big[i][1], a_small[i][1]);
        split_tf32(p[4 * kASum], a_big[i][2], a_small[i][2]);
        split_tf32(p[8 * kARow + 4 * kASum], a_big[i][3], a_small[i][3]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {  // sum index tig, tig + 4; column gid
        const float* p = kBSum ? bs + j * 8 * kLdB : bs + j * 8;
        split_tf32(p[0], b_big[j][0], b_small[j][0]);
        split_tf32(p[kBSum ? 4 : 4 * kLdB], b_big[j][1], b_small[j][1]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          mma_tf32(part[i][j], a_small[i], b_big[j]);
          mma_tf32(part[i][j], a_big[i], b_small[j]);
          mma_tf32(part[i][j], a_big[i], b_big[j]);
          if constexpr (L::kFold == 1) {  // fold at once: one tile's partial is live at a time
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r], part[i][j][r] = 0.f;
          }
        }
      if (L::kFold > 1 && (s + 1) % L::kFold == 0) {  // fold the partials into the accumulators, round to nearest
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r], part[i][j][r] = 0.f;
      }
    }
  }
  if constexpr (L::kSplitK > 1) {  // the groups' sums into group 0's, in group order, through shared memory
    static_assert((L::kSplitK - 1) * BM * BN <= kStages * (kStageA + kStageB), "the exchange fits the stage ring");
    cp_async_wait<0>();  // only empty groups are left
    __syncthreads();     // every warp is done with the ring
    // [group - 1][warp tile][i][j][r][lane]
    float* x = smem + (size_t)wt * TM * TN * 4 * 32 + lane;
    if (group > 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) x[(group - 1) * BM * BN + ((i * TN + j) * 4 + r) * 32] = acc[i][j][r];
    }
    __syncthreads();
    if (group > 0) return;
#pragma unroll
    for (int g = 1; g < L::kSplitK; ++g)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += x[(g - 1) * BM * BN + ((i * TN + j) * 4 + r) * 32];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {  // rows gid, gid + 8; columns 2 tig, 2 tig + 1
      const int m = m0 + wm0 + i * 16 + gid, n = n0 + wn0 + j * 8 + 2 * tig;
      if (n < NO) {  // NO % 4 == 0, so n + 1 < NO too
        if (m < M) *reinterpret_cast<float2*>(C + (size_t)m * ldc + n) = make_float2(acc[i][j][0], acc[i][j][1]);
        if (m + 8 < M)
          *reinterpret_cast<float2*>(C + (size_t)(m + 8) * ldc + n) = make_float2(acc[i][j][2], acc[i][j][3]);
      }
    }
}

template <class L, Gemm G>
cudaError_t launch_gemm(const float* A, int lda, const float* Bm, int ldb, float* C, int ldc, int M, int NO, int K,
                        const ColumnSums& cs, cudaStream_t stream, dim3* grid) {
  constexpr int smem = L::template smem_bytes<G>();
  *grid = dim3((NO + L::BN - 1) / L::BN, (M + L::BM - 1) / L::BM);
  // the lengths of the operands' contiguous rows, which cp.async copies as 16-byte chunks
  const int a_row = kAAlongOut<G> ? M : K, b_row = kBAlongSum<G> ? K : NO;
  uintptr_t ptrs = (uintptr_t)A | (uintptr_t)Bm | (uintptr_t)C;
  if constexpr (G == Gemm::kWgrad) ptrs |= (uintptr_t)cs.dy | (uintptr_t)cs.yn;  // read as float4
  if (a_row % 4 || b_row % 4 || NO % 4 || lda % 4 || ldb % 4 || ldc % 2 || ptrs % 16) return cudaErrorInvalidValue;
  // set once, at the first launch: the port drives one card a process
  static const cudaError_t attr = cudaFuncSetAttribute((const void*)tf32x3_gemm_kernel<L, G>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  tf32x3_gemm_kernel<L, G><<<*grid, L::kThreads, smem, stream>>>(A, lda, Bm, ldb, C, ldc, M, NO, K, cs);
  return cudaSuccess;
}

// The layouts the three GEMMs launch, as GemmLayout's parameters (BM, BN,
// BK, WM, WN, kSplitK, kStages, kFold). At DreamerV3-S, xproj's [1024, 1536]
// output in 128 x 96 tiles (sum 512) is 128 blocks of 8 warps, one wave on
// 132 SMs; dx's [1024, 512] output in 32 x 64 tiles (sum 1536) is 256 blocks
// of 4 warps, two to an SM, each warp tile's k-steps split between two warps;
// wgrad's [1024, 1536] output in xproj's tiles, with stages half as deep
// (sum 1024 in 32 stages of 32), is 128 blocks, one wave, and 8 rows of
// blocks for the column sums' partials. A source that
// defines these macros before it includes this file builds another layout:
// scripts/torch_gemm_layouts.py times the layouts tried that way, and
// PERF.md has their times.
#ifndef LN_GRU_XPROJ_LAYOUT
#define LN_GRU_XPROJ_LAYOUT 128, 96, 64, 4, 2, 1, 3, 4
#endif
#ifndef LN_GRU_DX_LAYOUT
#define LN_GRU_DX_LAYOUT 32, 64, 32, 1, 2, 2, 4, 1
#endif
#ifndef LN_GRU_WGRAD_LAYOUT
#define LN_GRU_WGRAD_LAYOUT 128, 96, 32, 4, 2, 1, 4, 4
#endif
using XprojLayout = GemmLayout<LN_GRU_XPROJ_LAYOUT>;
using DxLayout = GemmLayout<LN_GRU_DX_LAYOUT>;
using WgradLayout = GemmLayout<LN_GRU_WGRAD_LAYOUT>;

// ln_gru_wgrad: replaces the dW/dscale/dbias accumulators of _pallas_backward
// (sheeprl_tpu/ops/pallas_gru.py:206-207, :217). dW[F+H, 3H] = xh^T dy_raw,
// a sum over the T*B rows, on tf32x3_gemm_kernel with A = xh read along the
// output; dscale and dbias by column_sums in the same launch, in the
// prologue of every block while its first stages are in flight. Bound:
// operations, 3 TF32 products of 2*T*B*(F+H)*3H at 495 TFLOP/s (0.0195 ms at
// DV3-S); its bytes (xh, dy_raw, dy and yn read once, dW written) take
// 0.0088 ms. The column sums' reads are spread over all 128 blocks of the
// launch (about 100 KB a block at DV3-S) instead of a row of extra blocks
// that would run after the tiles.

// --------------------------------------------------------------------------
// The recurrent kernels on thread-block clusters (see the design note).
// Grid (NC, ceil(B / kRows)), cluster (NC, 1, 1), kSeqThreads threads.
// Two thread layouts:
//   * the product: warp w sums its share of the H rows of the product; its
//     lane l owns unit l % HS of the CTA and the RPT = kRows*HS/32 rows
//     (l / HS) * RPT .. +RPT-1, so a warp covers HS units x kRows rows;
//   * the step's elementwise work: thread t owns unit j = c*HS + t % HS and
//     the RPE rows (t / HS) * RPE .. +RPE-1; the kRows*HS items fill whole
//     warps, which may leave the last warps idle.
// Each kernel carves its dynamic shared memory in the order of the sum that
// ops/ln_gru.py makes for it (_resident_smem; _streamed_smem for the
// streamed instance below).
// --------------------------------------------------------------------------
#if !defined(LN_GRU_ROWS) || !defined(LN_GRU_THREADS) || !defined(LN_GRU_MAX_CLUSTER)
#error "build with sheeprl_tpu_torch.ops.ln_gru.build(), which passes the recurrent kernels' layout"
#endif
constexpr int kRows = LN_GRU_ROWS;              // batch rows of one cluster
constexpr int kSeqThreads = LN_GRU_THREADS;     // threads of a CTA
constexpr int kSeqWarps = kSeqThreads / 32;
constexpr int kMaxCluster = LN_GRU_MAX_CLUSTER; // the largest (non-portable) cluster on Hopper
static_assert(kSeqThreads % 32 == 0 && 32 % kRows == 0, "whole warps; a warp covers whole rows");

template <int G>  // sum over the aligned group of G lanes (a power of two) holding this lane
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int R>  // R consecutive floats, 16-byte aligned where R % 4 == 0 (8 bytes where R == 2)
__device__ __forceinline__ void load_rows(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else if constexpr (R == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = p[i];
  }
}

template <int R>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (R == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = v[i];
  }
}

// 1 / x, correctly rounded like 1.f / x, without the division's slow path.
__device__ __forceinline__ float sigmoid_rn(float x) { return __frcp_rn(1.f + expf(-x)); }

// The CTA's [H, 3*hs] slice of W_h (columns {j, H+j, 2H+j} for j in J_c,
// row stride 3H in global memory) into S, row stride ld.
__device__ void load_slice(float* S, int ld, const float* __restrict__ Wh, int H, int hs, int c) {
  const int q4 = hs / 4, per_row = 3 * q4;
  for (int e = threadIdx.x; e < H * per_row; e += blockDim.x) {
    const int k = e / per_row, rem = e - k * per_row, g = rem / q4, v = rem - g * q4;
    const float4 w = __ldg(reinterpret_cast<const float4*>(Wh + (size_t)k * 3 * H + g * H + c * hs) + v);
    float* d = S + (size_t)k * ld + g * hs + 4 * v;
    d[0] = w.x, d[1] = w.y, d[2] = w.z, d[3] = w.w;
  }
}

// Two values for each of this thread's R rows (from row r0) into slot
// [crank][row][2] of `buf` in every CTA of the cluster; the HS lanes that
// share the rows (and, after group_sum, the values) split the destinations.
template <int HS, int R>
__device__ __forceinline__ void push_row_pairs(cg::cluster_group& cluster, float* buf, int nc, int crank,
                                               int ej, int r0, const float (&v)[2 * R]) {
  for (int q = ej; q < nc; q += HS)
    store_rows<2 * R>(cluster.map_shared_rank(buf, q) + (crank * kRows + r0) * 2, v);
}

// ln_gru_fwd: the recurrence of _pallas_forward, from Gx = x W_x. Bound:
// operations, 2*T*B*H*3H (0.024 ms at DV3-S on a 67 TFLOP/s H100); it
// occupies NC * ceil(B / kRows) SMs and pays two cluster barriers a step.
// kSkipProduct leaves out h_in W_h: the probe variant (ln_gru_fwd_probe)
// that times the rest of a step; its result is not the function's.
template <int HS, bool kSkipProduct>
__global__ void __launch_bounds__(kSeqThreads, 1)
ln_gru_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ first,
                  const float* __restrict__ h_first, const float* __restrict__ Wh,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  float* __restrict__ hs_out, float* __restrict__ yn_out,
                  float* __restrict__ istd_out, int T, int B, int H) {
  constexpr int NCOL = 3 * HS, RPT = kRows * HS / 32;
  constexpr int RPE = kRows * HS > kSeqThreads ? kRows * HS / kSeqThreads : 1;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = H / HS, crank = (int)cluster.block_rank(), b0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int jl = lane % HS, rg = lane / HS;  // product layout
  const int ej = tid % HS, r0 = (tid / HS) * RPE, j = crank * HS + ej;  // elementwise layout
  const bool ew = r0 < kRows;
  float* Ws = smem;                             // [H][NCOL]
  float* hbuf = Ws + (size_t)H * NCOL;          // [H][kRows]
  float* part = hbuf + (size_t)H * kRows;       // [kSeqWarps][kRows][NCOL]
  float* stat = part + kSeqWarps * kRows * NCOL;  // [nc][kRows][2]
  float* hnext = stat + nc * kRows * 2;         // [HS][kRows]

  load_slice(Ws, NCOL, Wh, H, HS, crank);
  for (int e = tid; e < H * kRows; e += kSeqThreads) {  // h_in of step 0: the carry starts at 0
    const int k = e / kRows, b = b0 + e % kRows;
    hbuf[e] = b < B ? first[b] * h_first[(size_t)b * H + k] : 0.f;
  }
  float sc[3], bi[3], hf[RPE];
#pragma unroll
  for (int g = 0; g < 3; ++g) sc[g] = scale[g * H + j], bi[g] = bias[g * H + j];
#pragma unroll
  for (int i = 0; i < RPE; ++i) {
    const int b = b0 + r0 + i;
    hf[i] = ew && b < B ? h_first[(size_t)b * H + j] : 0.f;
  }
  auto load_gx = [&](int t, float (&v)[3][RPE], float (&f)[RPE]) {
#pragma unroll
    for (int i = 0; i < RPE; ++i) {
      const int b = b0 + r0 + i;
      const bool ok = ew && t < T && b < B;
#pragma unroll
      for (int g = 0; g < 3; ++g) v[g][i] = ok ? gx[((size_t)t * B + b) * 3 * H + g * H + j] : 0.f;
      f[i] = ok ? first[(size_t)t * B + b] : 0.f;
    }
  };
  float gcur[3][RPE], f0[RPE];  // step 0's reset is already in h_in
  load_gx(0, gcur, f0);
  cluster.sync();  // every CTA has started (DSMEM is safe to use) and holds h_in of step 0

  const int kc = kSkipProduct ? 0 : H / kSeqWarps;
  for (int t = 0; t < T; ++t) {
    float gnext[3][RPE], fnext[RPE];  // the next step's inputs, in flight during the product
    load_gx(t + 1, gnext, fnext);
    {  // this warp's share of the sum h_in W_h on the CTA's columns
      float acc[3][RPT] = {};
      const int k0 = warp * (H / kSeqWarps);
      const float* wp = Ws + (size_t)k0 * NCOL + jl;
      const float* hp = hbuf + (size_t)k0 * kRows + rg * RPT;
#pragma unroll 4
      for (int k = 0; k < kc; ++k, wp += NCOL, hp += kRows) {
        float hv[RPT];
        load_rows<RPT>(hp, hv);
        const float w0 = wp[0], w1 = wp[HS], w2 = wp[2 * HS];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[0][i] = fmaf(w0, hv[i], acc[0][i]);
          acc[1][i] = fmaf(w1, hv[i], acc[1][i]);
          acc[2][i] = fmaf(w2, hv[i], acc[2][i]);
        }
      }
      float* p = part + warp * kRows * NCOL;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g) p[(rg * RPT + i) * NCOL + g * HS + jl] = acc[g][i];
    }
    __syncthreads();
    float y[3][RPE];
    if (ew) {
      // y_raw = Gx + the warps' shares in warp order; the row's partial
      // statistics over this CTA's columns go to every CTA
      float st[2 * RPE];
#pragma unroll
      for (int i = 0; i < RPE; ++i) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float* p = part + (r0 + i) * NCOL + g * HS + ej;
          float s = p[0];
#pragma unroll
          for (int w = 1; w < kSeqWarps; ++w) s += p[w * kRows * NCOL];
          y[g][i] = gcur[g][i] + s;
        }
        const float m = group_sum<HS>(y[0][i] + y[1][i] + y[2][i]) * (1.f / NCOL);
        const float d0 = y[0][i] - m, d1 = y[1][i] - m, d2 = y[2][i] - m;
        st[2 * i] = m;
        st[2 * i + 1] = group_sum<HS>(d0 * d0 + d1 * d1 + d2 * d2);
      }
      push_row_pairs<HS, RPE>(cluster, stat, nc, crank, ej, r0, st);
    }
    cluster.sync();  // (1) the statistics have arrived; every CTA is done reading h_in
    if (ew) {
      float hn[RPE];
#pragma unroll
      for (int i = 0; i < RPE; ++i) {
        const int row = r0 + i, b = b0 + row;
        float m = 0.f, m2 = 0.f;  // Chan's formula over the nc partials, in CTA order
        for (int q = 0; q < nc; ++q) {
          const float2 s = *reinterpret_cast<const float2*>(stat + (q * kRows + row) * 2);
          const float delta = s.x - m;
          m += delta / (float)(q + 1);
          m2 += s.y + delta * delta * ((float)(NCOL * q) / (float)(q + 1));
        }
        const float is = rsqrtf(m2 / (float)(nc * NCOL) + kEps);
        float yn[3], ya[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) yn[g] = (y[g][i] - m) * is, ya[g] = yn[g] * sc[g] + bi[g];
        const float r = sigmoid_rn(ya[0]);
        const float c = tanhf(r * ya[1]);
        const float u = sigmoid_rn(ya[2] - 1.f);
        const float h_new = u * c + (1.f - u) * hbuf[j * kRows + row];
        if (b < B) {
          const size_t o = (size_t)t * B + b;
          hs_out[o * H + j] = h_new;
#pragma unroll
          for (int g = 0; g < 3; ++g) yn_out[o * 3 * H + g * H + j] = yn[g];
          if (j == 0) istd_out[o] = is;
        }
        hn[i] = (1.f - fnext[i]) * h_new + fnext[i] * hf[i];  // h_in of step t+1
      }
      store_rows<RPE>(hnext + ej * kRows + r0, hn);
    }
    __syncthreads();
    if (t + 1 < T) {  // the CTA's block of h_in into every CTA's h buffer, as float4
      constexpr int V = HS * kRows / 4;
      for (int e = tid; e < nc * V; e += kSeqThreads) {
        const int q = e / V, v = e - q * V;
        reinterpret_cast<float4*>(cluster.map_shared_rank(hbuf, q) + crank * HS * kRows)[v] =
            reinterpret_cast<const float4*>(hnext)[v];
      }
    }
#pragma unroll
    for (int i = 0; i < RPE; ++i)
#pragma unroll
      for (int g = 0; g < 3; ++g) gcur[g][i] = gnext[g][i];
    cluster.sync();  // (2) h_in of step t+1 has arrived in every CTA
  }
}

// ln_gru_bwd: the reverse sweep of _pallas_backward, from the forward's
// saved yn and istd (no recompute). Bound: operations, 2*T*B*H*3H for
// dh_in = dy_raw W_h^T (0.024 ms at DV3-S); same SMs and barriers as the
// forward. The input cotangent (ln_gru_dx) and the weight gradient
// (ln_gru_wgrad) come after it from the dy, dy_raw and xh it writes.
// kSkipProduct leaves out dy_raw W_h^T (the probe variant, ln_gru_bwd_probe).
template <int HS, bool kSkipProduct>
__global__ void __launch_bounds__(kSeqThreads, 1)
ln_gru_bwd_kernel(const float* __restrict__ feats, const float* __restrict__ first,
                  const float* __restrict__ hs, const float* __restrict__ h_first,
                  const float* __restrict__ Wh, const float* __restrict__ scale,
                  const float* __restrict__ bias, const float* __restrict__ g,
                  const float* __restrict__ yn, const float* __restrict__ istd,
                  float* __restrict__ dh_first, float* __restrict__ dy_out,
                  float* __restrict__ dyr_out, float* __restrict__ xh_out,
                  int T, int B, int F, int H) {
  constexpr int NCOL = 3 * HS, LDW = NCOL + 1;
  constexpr int RPE = kRows * HS > kSeqThreads ? kRows * HS / kSeqThreads : 1;
  constexpr int KPT = (kMaxCluster * HS + kSeqThreads - 1) / kSeqThreads;  // units of dh_in a thread sums
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = H / HS, crank = (int)cluster.block_rank(), b0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int ej = tid % HS, r0 = (tid / HS) * RPE, j = crank * HS + ej;  // elementwise layout
  const bool ew = r0 < kRows;
  const int N = 3 * H, K = F + H;
  float* Ws = smem;                          // [H][LDW]: odd stride, so lanes on consecutive k hit distinct banks
  float* recv = Ws + (size_t)H * LDW;        // [nc][HS][kRows]
  float* dyrs = recv + nc * kRows * HS;      // [NCOL][kRows]
  float* stat = dyrs + NCOL * kRows;         // [nc][kRows][2]

  load_slice(Ws, LDW, Wh, H, HS, crank);
  {  // xh[:, :, :F] = feats for the cluster's rows, the columns shared among its CTAs
    const int rows = min(kRows, B - b0), F4 = F / 4;
    const size_t n = (size_t)T * rows * F4;
    for (size_t e = (size_t)crank * kSeqThreads + tid; e < n; e += (size_t)nc * kSeqThreads) {
      const int c4 = (int)(e % F4);
      const size_t tr = e / F4;
      const size_t o = (size_t)(tr / rows) * B + b0 + (int)(tr % rows);
      *reinterpret_cast<float4*>(xh_out + o * K + 4 * c4) = __ldg(reinterpret_cast<const float4*>(feats + o * F) + c4);
    }
  }
  float sc[3], bi[3], hf[RPE], dh[RPE] = {}, dhf[RPE] = {};
#pragma unroll
  for (int q = 0; q < 3; ++q) sc[q] = scale[q * H + j], bi[q] = bias[q * H + j];
#pragma unroll
  for (int i = 0; i < RPE; ++i) {
    const int b = b0 + r0 + i;
    hf[i] = ew && b < B ? h_first[(size_t)b * H + j] : 0.f;
  }
  // one step's inputs of this thread's rows, loaded a step ahead
  float ynv[3][RPE], gv[RPE], fv[RPE], hp[RPE], isv[RPE];
  float ynn[3][RPE], gn[RPE], fn[RPE], hpn[RPE], isn[RPE];
  auto load_step = [&](int t, float (&y_)[3][RPE], float (&g_)[RPE], float (&f_)[RPE], float (&h_)[RPE],
                       float (&s_)[RPE]) {
#pragma unroll
    for (int i = 0; i < RPE; ++i) {
      const int b = b0 + r0 + i;
      const bool ok = ew && t >= 0 && b < B;
      const size_t o = (size_t)t * B + b;
#pragma unroll
      for (int q = 0; q < 3; ++q) y_[q][i] = ok ? yn[o * N + q * H + j] : 0.f;
      g_[i] = ok ? g[o * H + j] : 0.f;
      f_[i] = ok ? first[o] : 0.f;
      h_[i] = ok && t > 0 ? hs[(o - B) * H + j] : 0.f;
      s_[i] = ok ? istd[o] : 0.f;
    }
  };
  load_step(T - 1, ynv, gv, fv, hp, isv);
  cluster.sync();  // every CTA has started (DSMEM is safe to use)

  const int ncol = kSkipProduct ? 0 : NCOL;
  for (int t = T - 1; t >= 0; --t) {
    float dd[RPE], dyn[3][RPE];  // d (1 - u), the direct part of dh_in; dy * scale
    if (ew) {
      float st[2 * RPE];
#pragma unroll
      for (int i = 0; i < RPE; ++i) {
        const int b = b0 + r0 + i;
        const float h_in = (1.f - fv[i]) * hp[i] + fv[i] * hf[i];
        float ya[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) ya[q] = ynv[q][i] * sc[q] + bi[q];
        const float r = sigmoid_rn(ya[0]);
        const float c = tanhf(r * ya[1]);
        const float u = sigmoid_rn(ya[2] - 1.f);
        const float d = gv[i] + dh[i];
        const float du = d * (c - h_in);
        const float d_rc = d * u * (1.f - c * c);
        dd[i] = d * (1.f - u);
        const float dy[3] = {d_rc * ya[1] * r * (1.f - r), d_rc * r, du * u * (1.f - u)};
        if (b < B) {
          const size_t o = (size_t)t * B + b;
#pragma unroll
          for (int q = 0; q < 3; ++q) dy_out[o * N + q * H + j] = dy[q];
          xh_out[o * K + F + j] = h_in;
        }
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          dyn[q][i] = dy[q] * sc[q];
          s1 += dyn[q][i];
          s2 += dyn[q][i] * ynv[q][i];
        }
        st[2 * i] = group_sum<HS>(s1);
        st[2 * i + 1] = group_sum<HS>(s2);
      }
      push_row_pairs<HS, RPE>(cluster, stat, nc, crank, ej, r0, st);
    }
    cluster.sync();  // (1) the LN-backward row sums have arrived
    if (ew) {
#pragma unroll
      for (int i = 0; i < RPE; ++i) {
        const int row = r0 + i, b = b0 + row;
        float s1 = 0.f, s2 = 0.f;  // the nc partial sums in CTA order
        for (int q = 0; q < nc; ++q) {
          const float2 s = *reinterpret_cast<const float2*>(stat + (q * kRows + row) * 2);
          s1 += s.x;
          s2 += s.y;
        }
        const float m1 = s1 / (float)N, m2 = s2 / (float)N;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float v = isv[i] * (dyn[q][i] - m1 - ynv[q][i] * m2);
          if (b < B) dyr_out[((size_t)t * B + b) * N + q * H + j] = v;
          dyrs[(q * HS + ej) * kRows + row] = v;
        }
      }
    }
    load_step(t - 1, ynn, gn, fn, hpn, isn);  // in flight during the product
    __syncthreads();
    {  // this CTA's partial of dh_in = dy_raw W_h^T for units tid + p * kSeqThreads
      float acc[KPT][kRows] = {};
      for (int c = 0; c < ncol; ++c) {
        float dv[kRows];
        load_rows<kRows>(dyrs + c * kRows, dv);
#pragma unroll
        for (int p = 0; p < KPT; ++p) {
          const float w = Ws[min(tid + p * kSeqThreads, H - 1) * LDW + c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[p][r] = fmaf(w, dv[r], acc[p][r]);
        }
      }
#pragma unroll
      for (int p = 0; p < KPT; ++p) {  // reduce-scatter: unit k's partial goes to the CTA that owns k
        const int k = tid + p * kSeqThreads;
        if (k < H) {
          const int q = k / HS;
          store_rows<kRows>(cluster.map_shared_rank(recv, q) + (crank * HS + k - q * HS) * kRows, acc[p]);
        }
      }
    }
    cluster.sync();  // (2) every CTA's partial of J_c has arrived
    if (ew) {
#pragma unroll
      for (int i = 0; i < RPE; ++i) {
        float s = 0.f;
        for (int q = 0; q < nc; ++q) s += recv[(q * HS + ej) * kRows + r0 + i];
        const float dh_in = dd[i] + s;
        dh[i] = (1.f - fv[i]) * dh_in;  // the reset mask routes the carry cotangent
        dhf[i] += fv[i] * dh_in;
      }
    }
#pragma unroll
    for (int i = 0; i < RPE; ++i) {
      gv[i] = gn[i], fv[i] = fn[i], hp[i] = hpn[i], isv[i] = isn[i];
#pragma unroll
      for (int q = 0; q < 3; ++q) ynv[q][i] = ynn[q][i];
    }
  }
#pragma unroll
  for (int i = 0; i < RPE; ++i) {
    const int b = b0 + r0 + i;
    if (ew && b < B) dh_first[(size_t)b * H + j] = dhf[i];
  }
}

// --------------------------------------------------------------------------
// The streamed instance of the recurrent kernels, for widths whose W_h slice
// does not fit a CTA's shared memory (DreamerV3-M, L and XL: H = 1024, 2048
// and 4096, where a slice is 786,432 B, 3.1 MB and 12.6 MB). The same
// cluster of nc = H / HS CTAs (16), the same DSMEM exchanges of the LN
// statistics, the LN-backward row sums, h and the reduce-scatter, and the
// same per-unit elementwise work; HS = H / 16 units a CTA (64, 128, 256 at
// M, L, XL; any multiple of 8 up to kSeqThreads). What changes:
//   * The CTA does not keep its [H, 3*HS] slice of W_h. Every step streams it
//     through a ring of kStreamStages k-tiles of KT rows (row stride LD) in
//     shared memory, filled by 16-byte cp.async kStreamStages - 1 tiles ahead
//     of the tile being multiplied; the ring runs on from one step to the
//     next, so the next step's first tiles load during this step's
//     elementwise work and barriers. KT (32 at M, 16 at L, 8 at XL) keeps a
//     stage near 24 KB; ops/ln_gru.py picks it and passes it to the launch.
//   * Forward product: thread t owns unit j = t % HS of the CTA and its three
//     gate columns for the kRows rows (12 accumulators), and sums the tile
//     rows kk = g, g + KS, ... of every tile, g = t / HS being its k-group
//     (KS = kSeqThreads / HS groups); the KS partials are added in group
//     order.
//   * Backward product dh_in = dy_raw W_h^T: a tile holds KT units of the
//     sum's output; thread t owns unit t / CS of the tile (CS = kSeqThreads /
//     KT lanes a unit) and sums the columns c = s, s + CS, ... (s = t % CS),
//     whose dy_raw it holds in registers for the whole step (the same
//     columns in every tile); the CS lanes' sums are added by a butterfly,
//     and the unit's kRows values go to the CTA that owns the unit, as in the
//     resident reduce-scatter.
//   * A row's LN statistics (forward) and LN-backward sums (backward) over
//     the CTA's 3*HS columns span several warps: each thread's share goes to
//     shared memory and warp r adds row r's HS shares in unit order (the
//     forward's mean first, then its M2 about that mean).
//   * The elementwise layout: thread t owns unit t % HS and rows
//     (t / HS) * RPE .. +RPE-1, RPE = ceil(kRows / KS).
// Bound: operations, 2*T*B*H*3H a sweep (0.096 ms at M, 0.38 ms at L, 1.5
// ms at XL on a 67 TFLOP/s H100), when every input is read once. The design
// reads W_h again every step and in every one of the ceil(B / kRows)
// clusters: T reads of W_h alone take 0.24, 0.96 and 3.8 ms at 3.35 TB/s
// (M's 12.6 MB stay in the 50 MB L2; L's and XL's do not), so at L and XL
// those reads, not the FLOPs, set the pace.
// --------------------------------------------------------------------------
#if !defined(LN_GRU_STREAM_STAGES) || !defined(LN_GRU_STREAM_TILE)
#error "build with sheeprl_tpu_torch.ops.ln_gru.build(), which passes the streamed kernels' ring layout"
#endif
constexpr int kStreamStages = LN_GRU_STREAM_STAGES;  // k-tiles of the W_h ring
constexpr int kStreamTile = LN_GRU_STREAM_TILE;      // the most rows x units a k-tile holds
// 16-byte chunks of a tile (3 * rows * units / 4) a thread copies at most
constexpr int kTileChunks = (3 * kStreamTile / 4 + kSeqThreads - 1) / kSeqThreads;
// columns of the CTA's 3 * units a thread of the backward's product sums at
// most: 3 * units / (kSeqThreads / rows) <= 3 * kStreamTile / kSeqThreads
constexpr int kBwdCols = (3 * kStreamTile + kSeqThreads - 1) / kSeqThreads;
static_assert(kStreamStages >= 2, "a ring of at least two stages");
static_assert(kRows <= kSeqWarps, "one warp a row for the row sums");

// Whether the streamed kernels take this layout: HS units a CTA, a multiple
// of 8 (whole float4 chunks of each gate's columns) and at most one a thread;
// KT rows a tile, a divisor of kSeqThreads (so a power of two) from 8, so that
// the CS = kSeqThreads / KT lanes of a unit are whole groups of a warp.
bool stream_layout_ok(int H, int hs, int kt) {
  return hs > 0 && hs % 8 == 0 && H % hs == 0 && H / hs <= kMaxCluster && hs <= kSeqThreads && kt >= 8 &&
         kSeqThreads % kt == 0 && H % kt == 0 && kt * hs <= kStreamTile;
}

// sum over the aligned group of n lanes (a power of two) holding this lane
__device__ __forceinline__ float lane_group_sum(float v, int n) {
  for (int o = n / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The ring of a streamed kernel: tile n of the sweep (T * nt tiles in all)
// holds rows (n % nt) * kt .. +kt-1 of the CTA's slice of W_h (columns
// {j, H+j, 2H+j} for j in J_c, row stride 3H in global memory) in slot
// n % kStreamStages, row stride ld. Every tile splits into the same 16-byte
// chunks, so a thread works out the offsets of its chunks once (init) and a
// tile's copies cost it a few adds.
struct WRing {
  float* base;
  int ld, kt, nt, total, issued;
  const float* Wh;
  int H;
  int src[kTileChunks], dst[kTileChunks];  // this thread's chunks: offsets in W_h from the tile's row, in a slot

  __device__ void init(int hs, int c) {
    const int q4 = hs / 4, per_row = 3 * q4;
#pragma unroll
    for (int i = 0; i < kTileChunks; ++i) {
      const int e = threadIdx.x + i * kSeqThreads;
      const int r = e / per_row, rem = e - r * per_row, g = rem / q4, v = rem - g * q4;
      src[i] = e < kt * per_row ? r * 3 * H + g * H + c * hs + 4 * v : -1;
      dst[i] = r * ld + g * hs + 4 * v;
    }
  }

  __device__ float* slot(int n) const { return base + (size_t)(n % kStreamStages) * kt * ld; }

  // the next tile's cp.async copies, one commit group a call (empty past the end)
  __device__ void issue() {
    if (issued < total) {
      float* S = slot(issued);
      const float* w = Wh + (size_t)(issued % nt) * kt * 3 * H;
#pragma unroll
      for (int i = 0; i < kTileChunks; ++i)
        if (src[i] >= 0) cp_async16(S + dst[i], w + src[i], true);
    }
    cp_async_commit();
    ++issued;
  }

  // Tile n, landed and visible to the whole block; tile n + kStreamStages - 1
  // goes in flight into the slot of tile n - 1, which every thread is done
  // with. Called for n = 0, 1, ... in turn by all threads, after
  // kStreamStages - 1 issue() calls.
  __device__ const float* acquire(int n) {
    cp_async_wait<kStreamStages - 2>();
    __syncthreads();
    issue();
    return slot(n);
  }
};

// ln_gru_fwd, streamed instance: the recurrence of _pallas_forward from
// Gx = x W_x with the CTA's W_h slice streamed each step (see above).
// kSkipProduct leaves out h_in W_h and the ring (the probe variant).
template <bool kSkipProduct>
__global__ void __launch_bounds__(kSeqThreads, 1)
ln_gru_fwd_streamed_kernel(const float* __restrict__ gx, const float* __restrict__ first,
                           const float* __restrict__ h_first, const float* __restrict__ Wh,
                           const float* __restrict__ scale, const float* __restrict__ bias,
                           float* __restrict__ hs_out, float* __restrict__ yn_out,
                           float* __restrict__ istd_out, int T, int B, int H, int HS, int KT) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = H / HS, crank = (int)cluster.block_rank(), b0 = blockIdx.y * kRows;
  const int NCOL = 3 * HS, KS = kSeqThreads / HS, LD = NCOL + kSeqThreads / KT, NT = H / KT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pj = tid % HS, pg = tid / HS, j = crank * HS + pj;  // unit; k-group, and row group
  const int RPE = (kRows + KS - 1) / KS, r0 = pg * RPE, nrow = max(0, min(RPE, kRows - r0));
  float* ring = smem;                                    // [kStreamStages][KT][LD]
  float* hbuf = ring + (size_t)kStreamStages * KT * LD;  // [H][kRows]
  float* part = hbuf + (size_t)H * kRows;                // [KS][kRows][NCOL]
  float* stat = part + (size_t)KS * kRows * NCOL;        // [nc][kRows][2]
  float* hnext = stat + nc * kRows * 2;                  // [HS][kRows]
  float* red = hnext + HS * kRows;                       // [kRows][HS]
  float* rowm = red + kRows * HS;                        // [kRows]: the CTA's mean of each row

  for (int e = tid; e < H * kRows; e += kSeqThreads) {  // h_in of step 0: the carry starts at 0
    const int k = e / kRows, b = b0 + e % kRows;
    hbuf[e] = b < B ? first[b] * h_first[(size_t)b * H + k] : 0.f;
  }
  float sc[3], bi[3], hf[kRows];
#pragma unroll
  for (int g = 0; g < 3; ++g) sc[g] = scale[g * H + j], bi[g] = bias[g * H + j];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int b = b0 + r0 + i;
    hf[i] = i < nrow && b < B ? h_first[(size_t)b * H + j] : 0.f;
  }
  auto load_gx = [&](int t, float (&v)[3][kRows], float (&f)[kRows]) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int b = b0 + r0 + i;
      const bool ok = i < nrow && t < T && b < B;
#pragma unroll
      for (int g = 0; g < 3; ++g) v[g][i] = ok ? gx[((size_t)t * B + b) * 3 * H + g * H + j] : 0.f;
      f[i] = ok ? first[(size_t)t * B + b] : 0.f;
    }
  };
  float gcur[3][kRows], f0[kRows];  // step 0's reset is already in h_in
  load_gx(0, gcur, f0);
  WRing wr{ring, LD, KT, NT, kSkipProduct ? 0 : T * NT, 0, Wh, H, {}, {}};
  wr.init(HS, crank);
  for (int s = 0; s < kStreamStages - 1; ++s) wr.issue();
  cluster.sync();  // every CTA has started (DSMEM is safe to use) and holds h_in of step 0

  for (int t = 0; t < T; ++t) {
    float gnext[3][kRows], fnext[kRows];  // the next step's inputs, in flight during the product
    load_gx(t + 1, gnext, fnext);
    {  // this thread's k-group of the sum h_in W_h on its unit's three columns
      float acc[3][kRows] = {};
      if (!kSkipProduct) {
        for (int i = 0; i < NT; ++i) {
          const float* ws = wr.acquire(t * NT + i);
          if (pg >= KS) continue;
          const float* hp = hbuf + (size_t)i * KT * kRows;
#pragma unroll 4
          for (int kk = pg; kk < KT; kk += KS) {
            float hv[kRows];
            load_rows<kRows>(hp + kk * kRows, hv);
            const float* w = ws + kk * LD + pj;
            const float w0 = w[0], w1 = w[HS], w2 = w[2 * HS];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              acc[0][r] = fmaf(w0, hv[r], acc[0][r]);
              acc[1][r] = fmaf(w1, hv[r], acc[1][r]);
              acc[2][r] = fmaf(w2, hv[r], acc[2][r]);
            }
          }
        }
      }
      if (pg < KS) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int g = 0; g < 3; ++g) part[((size_t)pg * kRows + r) * NCOL + g * HS + pj] = acc[g][r];
      }
    }
    __syncthreads();
    // y_raw = Gx + the k-groups' partials in group order; each row's sum over
    // the CTA's columns, through shared memory
    float y[3][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      y[0][i] = y[1][i] = y[2][i] = 0.f;
      if (i >= nrow) continue;
      const int row = r0 + i;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float* p = part + (size_t)row * NCOL + g * HS + pj;
        float s = p[0];
        for (int q = 1; q < KS; ++q) s += p[(size_t)q * kRows * NCOL];
        y[g][i] = gcur[g][i] + s;
      }
      red[row * HS + pj] = y[0][i] + y[1][i] + y[2][i];
    }
    __syncthreads();
    if (warp < kRows) {  // warp r: row r's mean over the CTA's columns, the HS shares in unit order
      float s = 0.f;
      for (int e = lane; e < HS; e += 32) s += red[warp * HS + e];
      s = group_sum<32>(s);
      if (lane == 0) rowm[warp] = s / (float)NCOL;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= nrow) continue;
      const int row = r0 + i;
      const float m = rowm[row], d0 = y[0][i] - m, d1 = y[1][i] - m, d2 = y[2][i] - m;
      red[row * HS + pj] = d0 * d0 + d1 * d1 + d2 * d2;
    }
    __syncthreads();
    if (warp < kRows) {  // row r's M2; (mean, M2) into slot [crank][r] of every CTA
      float s = 0.f;
      for (int e = lane; e < HS; e += 32) s += red[warp * HS + e];
      s = group_sum<32>(s);
      if (lane < nc)
        *reinterpret_cast<float2*>(cluster.map_shared_rank(stat, lane) + (crank * kRows + warp) * 2) =
            make_float2(rowm[warp], s);
    }
    cluster.sync();  // (1) the statistics have arrived; every CTA is done reading h_in
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= nrow) continue;
      const int row = r0 + i, b = b0 + row;
      float m = 0.f, m2 = 0.f;  // Chan's formula over the nc partials, in CTA order
      for (int q = 0; q < nc; ++q) {
        const float2 s = *reinterpret_cast<const float2*>(stat + (q * kRows + row) * 2);
        const float delta = s.x - m;
        m += delta / (float)(q + 1);
        m2 += s.y + delta * delta * ((float)(NCOL * q) / (float)(q + 1));
      }
      const float is = rsqrtf(m2 / (float)(nc * NCOL) + kEps);
      float yn[3], ya[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) yn[g] = (y[g][i] - m) * is, ya[g] = yn[g] * sc[g] + bi[g];
      const float r = sigmoid_rn(ya[0]);
      const float c = tanhf(r * ya[1]);
      const float u = sigmoid_rn(ya[2] - 1.f);
      const float h_new = u * c + (1.f - u) * hbuf[j * kRows + row];
      if (b < B) {
        const size_t o = (size_t)t * B + b;
        hs_out[o * H + j] = h_new;
#pragma unroll
        for (int g = 0; g < 3; ++g) yn_out[o * 3 * H + g * H + j] = yn[g];
        if (j == 0) istd_out[o] = is;
      }
      hnext[pj * kRows + row] = (1.f - fnext[i]) * h_new + fnext[i] * hf[i];  // h_in of step t+1
    }
    __syncthreads();
    if (t + 1 < T) {  // the CTA's block of h_in into every CTA's h buffer, as float4
      const int V = HS * kRows / 4;
      for (int e = tid; e < nc * V; e += kSeqThreads) {
        const int q = e / V, v = e - q * V;
        reinterpret_cast<float4*>(cluster.map_shared_rank(hbuf, q) + crank * HS * kRows)[v] =
            reinterpret_cast<const float4*>(hnext)[v];
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int g = 0; g < 3; ++g) gcur[g][i] = gnext[g][i];
    cluster.sync();  // (2) h_in of step t+1 has arrived in every CTA
  }
}

// ln_gru_bwd, streamed instance: the reverse sweep of _pallas_backward from
// the forward's saved yn and istd, the CTA's W_h slice streamed each step
// for dy_raw W_h^T (see above). kSkipProduct leaves out that product and the
// ring (the probe variant).
template <bool kSkipProduct>
__global__ void __launch_bounds__(kSeqThreads, 1)
ln_gru_bwd_streamed_kernel(const float* __restrict__ feats, const float* __restrict__ first,
                           const float* __restrict__ hs, const float* __restrict__ h_first,
                           const float* __restrict__ Wh, const float* __restrict__ scale,
                           const float* __restrict__ bias, const float* __restrict__ g,
                           const float* __restrict__ yn, const float* __restrict__ istd,
                           float* __restrict__ dh_first, float* __restrict__ dy_out,
                           float* __restrict__ dyr_out, float* __restrict__ xh_out,
                           int T, int B, int F, int H, int HS, int KT) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = H / HS, crank = (int)cluster.block_rank(), b0 = blockIdx.y * kRows;
  const int NCOL = 3 * HS, KS = kSeqThreads / HS, CS = kSeqThreads / KT, LD = NCOL + CS, NT = H / KT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ej = tid % HS, j = crank * HS + ej;  // elementwise layout
  const int RPE = (kRows + KS - 1) / KS, r0 = (tid / HS) * RPE, nrow = max(0, min(RPE, kRows - r0));
  const int pu = tid / CS, ps = tid % CS;  // product layout: unit of the tile, column phase
  const int N = 3 * H, K = F + H;
  float* ring = smem;                                    // [kStreamStages][KT][LD]
  float* recv = ring + (size_t)kStreamStages * KT * LD;  // [nc][HS][kRows]
  float* dyrs = recv + (size_t)nc * HS * kRows;          // [NCOL][kRows]
  float* stat = dyrs + (size_t)NCOL * kRows;             // [nc][kRows][2]
  float* red = stat + nc * kRows * 2;                    // [kRows][HS][2]

  {  // xh[:, :, :F] = feats for the cluster's rows, the columns shared among its CTAs
    const int rows = min(kRows, B - b0), F4 = F / 4;
    const size_t n = (size_t)T * rows * F4;
    for (size_t e = (size_t)crank * kSeqThreads + tid; e < n; e += (size_t)nc * kSeqThreads) {
      const int c4 = (int)(e % F4);
      const size_t tr = e / F4;
      const size_t o = (size_t)(tr / rows) * B + b0 + (int)(tr % rows);
      *reinterpret_cast<float4*>(xh_out + o * K + 4 * c4) = __ldg(reinterpret_cast<const float4*>(feats + o * F) + c4);
    }
  }
  float sc[3], bi[3], hf[kRows], dh[kRows] = {}, dhf[kRows] = {};
#pragma unroll
  for (int q = 0; q < 3; ++q) sc[q] = scale[q * H + j], bi[q] = bias[q * H + j];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int b = b0 + r0 + i;
    hf[i] = i < nrow && b < B ? h_first[(size_t)b * H + j] : 0.f;
  }
  // one step's inputs of this thread's rows, loaded a step ahead
  float ynv[3][kRows], gv[kRows], fv[kRows], hp[kRows], isv[kRows];
  float ynn[3][kRows], gn[kRows], fn[kRows], hpn[kRows], isn[kRows];
  auto load_step = [&](int t, float (&y_)[3][kRows], float (&g_)[kRows], float (&f_)[kRows],
                       float (&h_)[kRows], float (&s_)[kRows]) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int b = b0 + r0 + i;
      const bool ok = i < nrow && t >= 0 && b < B;
      const size_t o = (size_t)t * B + b;
#pragma unroll
      for (int q = 0; q < 3; ++q) y_[q][i] = ok ? yn[o * N + q * H + j] : 0.f;
      g_[i] = ok ? g[o * H + j] : 0.f;
      f_[i] = ok ? first[o] : 0.f;
      h_[i] = ok && t > 0 ? hs[(o - B) * H + j] : 0.f;
      s_[i] = ok ? istd[o] : 0.f;
    }
  };
  load_step(T - 1, ynv, gv, fv, hp, isv);
  WRing wr{ring, LD, KT, NT, kSkipProduct ? 0 : T * NT, 0, Wh, H, {}, {}};
  wr.init(HS, crank);
  for (int s = 0; s < kStreamStages - 1; ++s) wr.issue();
  cluster.sync();  // every CTA has started (DSMEM is safe to use)

  int n = 0;  // tiles consumed
  for (int t = T - 1; t >= 0; --t) {
    float dd[kRows], dyn[3][kRows];  // d (1 - u), the direct part of dh_in; dy * scale
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      dd[i] = dyn[0][i] = dyn[1][i] = dyn[2][i] = 0.f;
      if (i >= nrow) continue;
      const int row = r0 + i, b = b0 + row;
      const float h_in = (1.f - fv[i]) * hp[i] + fv[i] * hf[i];
      float ya[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) ya[q] = ynv[q][i] * sc[q] + bi[q];
      const float r = sigmoid_rn(ya[0]);
      const float c = tanhf(r * ya[1]);
      const float u = sigmoid_rn(ya[2] - 1.f);
      const float d = gv[i] + dh[i];
      const float du = d * (c - h_in);
      const float d_rc = d * u * (1.f - c * c);
      dd[i] = d * (1.f - u);
      const float dy[3] = {d_rc * ya[1] * r * (1.f - r), d_rc * r, du * u * (1.f - u)};
      if (b < B) {
        const size_t o = (size_t)t * B + b;
#pragma unroll
        for (int q = 0; q < 3; ++q) dy_out[o * N + q * H + j] = dy[q];
        xh_out[o * K + F + j] = h_in;
      }
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        dyn[q][i] = dy[q] * sc[q];
        s1 += dyn[q][i];
        s2 += dyn[q][i] * ynv[q][i];
      }
      *reinterpret_cast<float2*>(red + (row * HS + ej) * 2) = make_float2(s1, s2);
    }
    __syncthreads();
    if (warp < kRows) {  // warp r: row r's sums over the CTA's columns in unit order, to every CTA
      float s1 = 0.f, s2 = 0.f;
      for (int e = lane; e < HS; e += 32) {
        const float2 v = *reinterpret_cast<const float2*>(red + (warp * HS + e) * 2);
        s1 += v.x;
        s2 += v.y;
      }
      s1 = group_sum<32>(s1);
      s2 = group_sum<32>(s2);
      if (lane < nc)
        *reinterpret_cast<float2*>(cluster.map_shared_rank(stat, lane) + (crank * kRows + warp) * 2) =
            make_float2(s1, s2);
    }
    cluster.sync();  // (1) the LN-backward row sums have arrived
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= nrow) continue;
      const int row = r0 + i, b = b0 + row;
      float s1 = 0.f, s2 = 0.f;  // the nc partial sums in CTA order
      for (int q = 0; q < nc; ++q) {
        const float2 s = *reinterpret_cast<const float2*>(stat + (q * kRows + row) * 2);
        s1 += s.x;
        s2 += s.y;
      }
      const float m1 = s1 / (float)N, m2 = s2 / (float)N;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float v = isv[i] * (dyn[q][i] - m1 - ynv[q][i] * m2);
        if (b < B) dyr_out[((size_t)t * B + b) * N + q * H + j] = v;
        dyrs[(q * HS + ej) * kRows + row] = v;
      }
    }
    load_step(t - 1, ynn, gn, fn, hpn, isn);  // in flight during the product
    __syncthreads();
    if (!kSkipProduct) {  // this CTA's partial of dh_in for every unit, a tile of KT units at a time
      float dv[kBwdCols][kRows];  // dy_raw of this thread's columns c = ps + i * CS
#pragma unroll
      for (int i = 0; i < kBwdCols; ++i) {
        const int c = ps + i * CS;
        if (c < NCOL) {
          load_rows<kRows>(dyrs + c * kRows, dv[i]);
        } else {
#pragma unroll
          for (int r = 0; r < kRows; ++r) dv[i][r] = 0.f;
        }
      }
      for (int i = 0; i < NT; ++i) {
        const float* w = wr.acquire(n++) + pu * LD;
        float acc[kRows] = {};
#pragma unroll
        for (int q = 0; q < kBwdCols; ++q) {
          const int c = ps + q * CS;
          const float wv = c < NCOL ? w[c] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = fmaf(wv, dv[q][r], acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = lane_group_sum(acc[r], CS);
        if (ps == 0) {  // reduce-scatter: unit k's partial goes to the CTA that owns k
          const int k = i * KT + pu, q = k / HS;
          store_rows<kRows>(cluster.map_shared_rank(recv, q) + (crank * HS + k - q * HS) * kRows, acc);
        }
      }
    }
    cluster.sync();  // (2) every CTA's partial of J_c has arrived
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i >= nrow) continue;
      float s = 0.f;
      for (int q = 0; q < nc; ++q) s += recv[(q * HS + ej) * kRows + r0 + i];
      const float dh_in = dd[i] + s;
      dh[i] = (1.f - fv[i]) * dh_in;  // the reset mask routes the carry cotangent
      dhf[i] += fv[i] * dh_in;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      gv[i] = gn[i], fv[i] = fn[i], hp[i] = hpn[i], isv[i] = isn[i];
#pragma unroll
      for (int q = 0; q < 3; ++q) ynv[q][i] = ynn[q][i];
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int b = b0 + r0 + i;
    if (i < nrow && b < B) dh_first[(size_t)b * H + j] = dhf[i];
  }
}

using FwdKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                           const float*, float*, float*, float*, int, int, int);
using BwdKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                           const float*, const float*, const float*, const float*, const float*, float*,
                           float*, float*, float*, int, int, int, int);

// The instance for HS units a CTA (4, 8, 16 or 32), or nullptr where a
// warp's lanes would not cover HS units x kRows rows or H does not split
// into at most kMaxCluster such CTAs.
template <int HS, bool kSkipProduct>
FwdKernel fwd_instance() {
  if constexpr (kRows * HS >= 32) return ln_gru_fwd_kernel<HS, kSkipProduct>;
  else return nullptr;
}
template <int HS, bool kSkipProduct>
BwdKernel bwd_instance() {
  if constexpr (kRows * HS >= 32) return ln_gru_bwd_kernel<HS, kSkipProduct>;
  else return nullptr;
}

template <bool kSkipProduct>
FwdKernel fwd_kernel(int H, int hs) {
  if (hs <= 0 || H % hs || H / hs > kMaxCluster || H % kSeqWarps) return nullptr;
  switch (hs) {
    case 4: return fwd_instance<4, kSkipProduct>();
    case 8: return fwd_instance<8, kSkipProduct>();
    case 16: return fwd_instance<16, kSkipProduct>();
    case 32: return fwd_instance<32, kSkipProduct>();
  }
  return nullptr;
}

template <bool kSkipProduct>
BwdKernel bwd_kernel(int H, int hs) {
  if (hs <= 0 || H % hs || H / hs > kMaxCluster || H % kSeqWarps) return nullptr;
  switch (hs) {
    case 4: return bwd_instance<4, kSkipProduct>();
    case 8: return bwd_instance<8, kSkipProduct>();
    case 16: return bwd_instance<16, kSkipProduct>();
    case 32: return bwd_instance<32, kSkipProduct>();
  }
  return nullptr;
}

// The launch of a recurrent kernel: grid (NC, ceil(B / kRows)) in clusters
// of NC CTAs; sets the kernel's shared-memory and cluster-size attributes.
template <typename Kern>
cudaError_t cluster_config(Kern kernel, int nc, int B, size_t smem, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && nc > 8)
    e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(nc, (B + kRows - 1) / kRows, 1);
  cfg->blockDim = dim3(kSeqThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = nc;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

// Blocks of the last launch that each entry made, in the order of
// ops/ln_gru.py's KERNELS (the probes record nothing).
enum { kXproj, kFwd, kBwd, kDx, kWgrad, kNumKernels };
int g_last_blocks[kNumKernels];

int record(int kernel, dim3 grid, cudaError_t e) {
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) g_last_blocks[kernel] = (int)(grid.x * grid.y * grid.z);
  return (int)e;
}

// units: hidden units of a CTA; kt: rows of a W_h tile of the streamed
// instance, 0 for the resident one; smem: a CTA's shared-memory bytes (all
// three from the fit rule of ops/ln_gru.py).
template <bool kSkipProduct>
cudaError_t launch_fwd(const float* gx, const float* first, const float* h_first, const float* Wh,
                       const float* scale, const float* bias, float* hs, float* yn, float* istd, int T, int B,
                       int H, int units, int kt, int smem, void* stream, dim3* grid) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e;
  if (kt == 0) {
    FwdKernel k = fwd_kernel<kSkipProduct>(H, units);
    if (!k) return cudaErrorInvalidValue;
    e = cluster_config(k, H / units, B, smem, (cudaStream_t)stream, &cfg, &attr);
    if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, k, gx, first, h_first, Wh, scale, bias, hs, yn, istd, T, B, H);
  } else {
    if (!stream_layout_ok(H, units, kt)) return cudaErrorInvalidValue;
    auto k = ln_gru_fwd_streamed_kernel<kSkipProduct>;
    e = cluster_config(k, H / units, B, smem, (cudaStream_t)stream, &cfg, &attr);
    if (e == cudaSuccess)
      e = cudaLaunchKernelEx(&cfg, k, gx, first, h_first, Wh, scale, bias, hs, yn, istd, T, B, H, units, kt);
  }
  *grid = cfg.gridDim;
  return e;
}

template <bool kSkipProduct>
cudaError_t launch_bwd(const float* feats, const float* first, const float* hs, const float* h_first,
                       const float* Wh, const float* scale, const float* bias, const float* g, const float* yn,
                       const float* istd, float* dh_first, float* dy, float* dyraw, float* xh, int T, int B,
                       int F, int H, int units, int kt, int smem, void* stream, dim3* grid) {
  if (F % 4) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e;
  if (kt == 0) {
    BwdKernel k = bwd_kernel<kSkipProduct>(H, units);
    if (!k) return cudaErrorInvalidValue;
    e = cluster_config(k, H / units, B, smem, (cudaStream_t)stream, &cfg, &attr);
    if (e == cudaSuccess)
      e = cudaLaunchKernelEx(&cfg, k, feats, first, hs, h_first, Wh, scale, bias, g, yn, istd, dh_first, dy, dyraw,
                             xh, T, B, F, H);
  } else {
    if (!stream_layout_ok(H, units, kt)) return cudaErrorInvalidValue;
    auto k = ln_gru_bwd_streamed_kernel<kSkipProduct>;
    e = cluster_config(k, H / units, B, smem, (cudaStream_t)stream, &cfg, &attr);
    if (e == cudaSuccess)
      e = cudaLaunchKernelEx(&cfg, k, feats, first, hs, h_first, Wh, scale, bias, g, yn, istd, dh_first, dy, dyraw,
                             xh, T, B, F, H, units, kt);
  }
  *grid = cfg.gridDim;
  return e;
}

// Clusters of kernel k that the card holds at once; minus a CUDA error code.
template <typename Kern>
int active_clusters(Kern k, int nc, int smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t e = cluster_config(k, nc, kRows, smem, 0, &cfg, &attr);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, (const void*)k, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" const char* ln_gru_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Blocks of the last launch of kernel k (0 xproj, 1 fwd, 2 bwd, 3 dx,
// 4 wgrad) through its entry; 0 before the first.
extern "C" int ln_gru_last_blocks(int k) { return k >= 0 && k < kNumKernels ? g_last_blocks[k] : -1; }

// Clusters of the forward (which = 0) or backward (which = 1) kernel that the
// card can hold at once (kt as for ln_gru_fwd); minus a CUDA error code if it
// cannot tell.
extern "C" int ln_gru_max_active_clusters(int which, int H, int units, int kt, int smem) {
  if (kt != 0) {
    if (!stream_layout_ok(H, units, kt)) return -(int)cudaErrorInvalidValue;
    return which == 0 ? active_clusters(ln_gru_fwd_streamed_kernel<false>, H / units, smem)
                      : active_clusters(ln_gru_bwd_streamed_kernel<false>, H / units, smem);
  }
  if (which == 0) {
    if (FwdKernel k = fwd_kernel<false>(H, units)) return active_clusters(k, H / units, smem);
  } else if (BwdKernel k = bwd_kernel<false>(H, units)) {
    return active_clusters(k, H / units, smem);
  }
  return -(int)cudaErrorInvalidValue;
}

extern "C" int ln_gru_xproj(const float* x, const float* wx, float* gx, int M, int F, int N, void* stream) {
  dim3 grid;
  const cudaError_t e =
      launch_gemm<XprojLayout, Gemm::kXproj>(x, F, wx, N, gx, N, M, N, F, {}, (cudaStream_t)stream, &grid);
  return record(kXproj, grid, e);
}

// kt: rows of a W_h tile of the streamed instance, 0 for the resident one.
extern "C" int ln_gru_fwd(const float* gx, const float* first, const float* h_first, const float* Wh,
                          const float* scale, const float* bias, float* hs, float* yn, float* istd, int T,
                          int B, int H, int units, int kt, int smem, void* stream) {
  dim3 grid;
  cudaError_t e = launch_fwd<false>(gx, first, h_first, Wh, scale, bias, hs, yn, istd, T, B, H, units, kt, smem,
                                    stream, &grid);
  return record(kFwd, grid, e);
}

// ln_gru_fwd without its product h_in W_h: a timing probe of the rest of a
// step (barriers, DSMEM pushes, gate math, loads and stores).
extern "C" int ln_gru_fwd_probe(const float* gx, const float* first, const float* h_first, const float* Wh,
                                const float* scale, const float* bias, float* hs, float* yn, float* istd, int T,
                                int B, int H, int units, int kt, int smem, void* stream) {
  dim3 grid;
  cudaError_t e = launch_fwd<true>(gx, first, h_first, Wh, scale, bias, hs, yn, istd, T, B, H, units, kt, smem,
                                   stream, &grid);
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}

extern "C" int ln_gru_bwd(const float* feats, const float* first, const float* hs, const float* h_first,
                          const float* Wh, const float* scale, const float* bias, const float* g,
                          const float* yn, const float* istd, float* dh_first, float* dy, float* dyraw,
                          float* xh, int T, int B, int F, int H, int units, int kt, int smem, void* stream) {
  dim3 grid;
  cudaError_t e = launch_bwd<false>(feats, first, hs, h_first, Wh, scale, bias, g, yn, istd, dh_first, dy, dyraw, xh,
                                    T, B, F, H, units, kt, smem, stream, &grid);
  return record(kBwd, grid, e);
}

// ln_gru_bwd without its product dy_raw W_h^T: a timing probe, as above.
extern "C" int ln_gru_bwd_probe(const float* feats, const float* first, const float* hs, const float* h_first,
                                const float* Wh, const float* scale, const float* bias, const float* g,
                                const float* yn, const float* istd, float* dh_first, float* dy, float* dyraw,
                                float* xh, int T, int B, int F, int H, int units, int kt, int smem, void* stream) {
  dim3 grid;
  cudaError_t e = launch_bwd<true>(feats, first, hs, h_first, Wh, scale, bias, g, yn, istd, dh_first, dy, dyraw, xh,
                                   T, B, F, H, units, kt, smem, stream, &grid);
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}

extern "C" int ln_gru_dx(const float* dyraw, const float* wx, float* dx, int M, int F, int N, void* stream) {
  dim3 grid;
  const cudaError_t e =
      launch_gemm<DxLayout, Gemm::kDx>(dyraw, N, wx, N, dx, F, M, F, N, {}, (cudaStream_t)stream, &grid);
  return record(kDx, grid, e);
}

// Partial slots of ln_gru_wgrad's column sums for K = F+H output rows: the
// rows of blocks of its grid. The caller gives the launch [slots][2][N] floats.
extern "C" int ln_gru_wgrad_slots(int K) { return (K + WgradLayout::BM - 1) / WgradLayout::BM; }

// Arrival counters of ln_gru_wgrad for N = 3H output columns: the column
// tiles of its grid. The caller gives the launch that many zeroed uint32.
extern "C" int ln_gru_wgrad_tiles(int N) { return (N + WgradLayout::BN - 1) / WgradLayout::BN; }

// part: [ln_gru_wgrad_slots(K)][2][N] floats of scratch; arrivals:
// [ln_gru_wgrad_tiles(N)] uint32, zero.
extern "C" int ln_gru_wgrad(const float* xh, const float* dyraw, const float* dy, const float* yn, float* part,
                            unsigned int* arrivals, float* dW, float* dscale, float* dbias, int M, int K, int N,
                            void* stream) {
  dim3 grid;
  const ColumnSums cs{dy, yn, part, arrivals, dscale, dbias};
  const cudaError_t e =
      launch_gemm<WgradLayout, Gemm::kWgrad>(xh, K, dyraw, N, dW, N, K, N, M, cs, (cudaStream_t)stream, &grid);
  return record(kWgrad, grid, e);
}
