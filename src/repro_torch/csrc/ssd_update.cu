// The SSD (Mamba2) state recurrence over a short window of T tokens — the
// speculative verify window (T = gamma + 1) or one decode token:
//
//   a_t = exp(dt_t * (-A))                               (per batch row, head)
//   h_t = a_t * h_{t-1} + (dt_t * x_t) (outer) B_t       (P x N per head)
//   y_t = h_t . C_t                                      (sum over N)
//
// with every window position's state h_t written out when collect != 0
// (the verify candidate: the commit keeps the state after the last
// accepted token), else only h_T.
//
// Not a TPU kernel: the reference runs this recurrence as a lax.scan
// (repro/models/ssm.py:_ssd_sequential, ssm.py:89-106).  Written as plain
// PyTorch ops, each window token reads and writes the (B, H, P, N) state
// several times; here each state element is read once and written once per
// token it must be kept for.
//
// Bound on the H100: bytes.  h0 (B*H*P*N f32) is read once; the states
// (B*T*H*P*N f32 with collect, B*H*P*N without) are written once; x, B, C,
// dt and y are a few hundred KB.  About five f32 operations per state
// element per token, far below the card's rate.
//
// Design.  One block of 128 threads per (batch row, head, 16 rows of P).
// A row's N state values are spread over LPR = min(N, 32) lanes, NPL =
// N / LPR each, held in registers across the T tokens; each lane group
// (LPR lanes) owns RG rows.  Per token the block reads dt, x of its rows
// and the lane's slices of B and C (from L2), updates the state in
// registers and writes it (collect) with one vector store per lane.
// The update is __fmul_rn/__fadd_rn in the reference's order,
// (a * h) + ((dt * x) * B), never contracted into an FMA, so the states
// are bit-equal to the plain version (kernels/ssd_update.py
// ssd_update_ref, the same elementwise ops) on the card.  y sums a lane's
// NPL products in index order, then the LPR lanes by the shuffle tree xor
// LPR/2 .. 1: one fixed order, so a row's y and states depend on neither T
// nor B, and greedy speculation equals vanilla decoding by construction.
// a = expf(dt * -A) is the CUDA math library's expf, as torch.exp's on the
// card.  Build without --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;  // rows of P per block

// n floats at p into v (n = 1, 2, 4 or a multiple of 4; p aligned to n * 4
// bytes up to 16).
template <int n>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      v[i] = u.x; v[i + 1] = u.y; v[i + 2] = u.z; v[i + 3] = u.w;
    }
  } else if constexpr (n == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x; v[1] = u.y;
  } else {
    v[0] = *p;
  }
}

template <int n>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (n == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// x: (B, T, H, P); Bm, Cm: (B, T, N); dt: (B, T, H); A: (H,); h0: (B, H, P, N);
// y: (B, T, H, P); states: (B, T, H, P, N) when collect, else (B, H, P, N).
// All f32, contiguous.  grid (B * H, P / 16), 128 threads.
template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_update_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ states, int collect, int T,
                  int H, int P) {
  constexpr int LPR = N < 32 ? N : 32;   // lanes per state row
  constexpr int NPL = N / LPR;           // state values per lane
  constexpr int GROUPS = kThreads / LPR;
  constexpr int RG = kRows / GROUPS;     // rows per lane group
  static_assert(RG >= 1 && RG * GROUPS == kRows, "N must be 16, 32, 64, 128 or 256");
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int li = threadIdx.x % LPR, grp = threadIdx.x / LPR;
  const int p0 = blockIdx.y * kRows + grp * RG;
  const int n0 = li * NPL;
  const float neg_a = -A[h];

  float s[RG][NPL];
#pragma unroll
  for (int r = 0; r < RG; ++r)
    load_vec<NPL>(h0 + ((static_cast<int64_t>(bh) * P + p0 + r) * N + n0), s[r]);

  for (int t = 0; t < T; ++t) {
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    const float dtv = dt[bt * H + h];
    const float a = expf(__fmul_rn(dtv, neg_a));
    float bv[NPL], cv[NPL];
    load_vec<NPL>(Bm + bt * N + n0, bv);
    load_vec<NPL>(Cm + bt * N + n0, cv);
    const int64_t row = (bt * H + h) * P + p0;   // (b, t, h, p0) in x and y
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const float dx = __fmul_rn(dtv, x[row + r]);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        s[r][j] = __fadd_rn(__fmul_rn(a, s[r][j]), __fmul_rn(dx, bv[j]));
        acc = __fadd_rn(acc, __fmul_rn(s[r][j], cv[j]));
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      if (li == 0) y[row + r] = acc;
      if (collect) store_vec<NPL>(states + (row + r) * N + n0, s[r]);
    }
  }
  if (!collect) {
#pragma unroll
    for (int r = 0; r < RG; ++r)
      store_vec<NPL>(states + (static_cast<int64_t>(bh) * P + p0 + r) * N + n0, s[r]);
  }
}

}  // namespace

// The shapes above; P a multiple of 16, N one of 16, 32, 64, 128, 256.
// Returns a cudaError_t (cudaErrorInvalidValue for another N).
extern "C" int ssd_update_launch(const float* x, const float* Bm, const float* Cm,
                                 const float* dt, const float* A, const float* h0, float* y,
                                 float* states, int collect, int B, int T, int H, int P,
                                 int N, void* stream) {
  if (B == 0 || H == 0 || P == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(B * H, P / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_CASE(n)                                                                      \
  case n:                                                                                \
    ssd_update_kernel<n><<<grid, kThreads, 0, st>>>(x, Bm, Cm, dt, A, h0, y, states,     \
                                                    collect, T, H, P);                   \
    break;
  switch (N) {
    SSD_CASE(16)
    SSD_CASE(32)
    SSD_CASE(64)
    SSD_CASE(128)
    SSD_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSD_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
