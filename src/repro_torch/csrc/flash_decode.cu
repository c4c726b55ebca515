// Decode/verify attention over a contiguous KV cache: a short query window
// (T = 1 .. gamma+1 positions, G = Hq/Hkv query heads per KV head) against
// S cached keys, with slot == absolute position causality (key s is visible
// to the query at position p iff s <= p) and online softmax.  bf16/f32 K/V,
// or int8 K/V with per-(token, head) f32 scales: the key scale multiplies
// the score columns, the value scale multiplies the probabilities after the
// normaliser has summed them.
//
// Replaces the Pallas TPU kernels repro/kernels/flash_decode.py:_kernel
// (chain, bf16/f32 KV) and :_kernel_int8 (chain, int8 KV), both through
// _flash_body and the pallas_call at flash_decode.py:248.
//
// Bound on the H100: bytes.  Each call reads, for each batch row, the K/V
// slots up to the window's last position once (Hkv*dh elements each per
// slot, plus the scales) for only 4*G*T operations per cached element pair —
// far below the rate at which arithmetic would bound it.  Slots past the
// window's last position are masked for every query row, so they are never
// read: a split that starts past it is skipped, and the last live split
// stops there.
//
// Design: the TPU kernel walks S as a sequential grid axis carrying (m, l,
// acc) in VMEM; here B*Hkv blocks alone would leave most of the 132 SMs
// idle, so S is split into ranges of split_len keys (flash-decoding).  The
// split depends on S alone — never on T or B — so a query row's result does
// not depend on the window length.  One block per (b, kv head, split) holds
// the G*T query rows of its KV head in shared memory, streams its key range
// in chunks of 32 keys (16-byte loads, widened to f32 in shared memory), and
// keeps the running max m, sum l and f32 accumulator per query row in the
// order of flash_decode.py:100-114: s = q.k * scale [* k_scale], masked to
// -1e30; m_new = max(m, max s); p = valid ? exp(s - m_new) : 0;
// l = l*alpha + sum p; p *= v_scale; acc = acc*alpha + p.V.  The two
// products are register-tiled — a thread holds 8 query rows' dot products
// for one key, or 8 rows x 4 dims of p.V — so each shared-memory float4
// feeds 4-32 FMAs.  A second kernel merges the splits and divides by
// max(l, 1e-30), reading only the live splits.  Loads are bounded by S and
// by the window's last position: no slot past either is read.
// Arithmetic is f32 with accurate expf (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int CK = 32;  // keys per chunk: one per lane in the softmax update
constexpr int RB = 8;   // query rows per register block
constexpr float MASK_VAL = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One 16-byte load of K/V elements, widened to f32 (4, 8 or 16 values).
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(c[i]);
}

// Largest query position of one batch row's window: keys past it are
// masked for every query row of the row.
__device__ __forceinline__ int max_qpos(const int* __restrict__ qpos_b, int T) {
  int m = -1;
  for (int t = 0; t < T; ++t) m = max(m, qpos_b[t]);
  return m;
}

// Splits holding at least one key at or before the window's last position.
__device__ __forceinline__ int live_splits(const int* __restrict__ qpos_b, int T,
                                           int split_len, int nsplit) {
  const int m = max_qpos(qpos_b, T);
  return m < 0 ? 0 : min(nsplit, m / split_len + 1);
}

__device__ __forceinline__ void fma4(float& acc, const float4 a, const float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

template <typename QT, typename KVT, int DH>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
                   const KVT* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs, const int* __restrict__ qpos,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int T, int Hq, int Hkv, int S,
                   int split_len, float scale) {
  constexpr bool kInt8 = sizeof(KVT) == 1;
  constexpr int EPV = 16 / sizeof(KVT);  // K/V elements per 16-byte load
  constexpr int VPR = DH / EPV;          // 16-byte loads per key row
  constexpr int D4 = DH / 4;             // float4s per row
  constexpr int KST = DH + 4;            // k_s row stride: float4-aligned, conflict-free
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int G = Hq / Hkv, R = G * T;
  const int nrb = (R + RB - 1) / RB, Rp = nrb * RB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // keys past the window's last position are masked for every query row:
  // a split that starts past it writes nothing (the merge skips it), and
  // the last live split stops there
  const int qmax = max_qpos(qpos + b * T, T);
  const int s_begin = split * split_len;
  if (s_begin > qmax) return;
  const int s_end = min(min(S, s_begin + split_len), qmax + 1);

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [Rp][DH]  query rows r = g*T + t
  float* acc_s = q_s + Rp * DH;         // [Rp][DH]
  float* k_s = acc_s + Rp * DH;         // [CK][KST]
  float* v_s = k_s + CK * KST;          // [CK][DH]
  float* p_s = v_s + CK * DH;           // [Rp][CK]  scores, then probabilities
  float* m_s = p_s + Rp * CK;           // [R]
  float* l_s = m_s + R;                 // [R]
  float* alpha_s = l_s + R;             // [R]
  float* ksc_s = alpha_s + R;           // [CK]
  float* vsc_s = ksc_s + CK;            // [CK]
  int* qpos_s = reinterpret_cast<int*>(vsc_s + CK);  // [R]

  for (int i = tid; i < R * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, g = r / T, t = r % T;
    q_s[i] = to_f32(q[((static_cast<int64_t>(b) * T + t) * Hq + h * G + g) * DH + d]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = MASK_VAL;
    l_s[r] = 0.f;
    qpos_s[r] = qpos[b * T + r % T];
  }

  for (int c0 = s_begin; c0 < s_end; c0 += CK) {
    __syncthreads();  // previous chunk fully consumed (and q/acc set up)
    for (int i = tid; i < CK * VPR; i += kThreads) {
      const int j = i / VPR, c = (i % VPR) * EPV, s = c0 + j;
      float kv[EPV], vv[EPV];
      if (s < s_end) {
        const int64_t off = ((static_cast<int64_t>(b) * S + s) * Hkv + h) * DH + c;
        load16(k + off, kv);
        load16(v + off, vv);
      } else {
#pragma unroll
        for (int e = 0; e < EPV; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPV; e += 4) {
        *reinterpret_cast<float4*>(k_s + j * KST + c + e) =
            make_float4(kv[e], kv[e + 1], kv[e + 2], kv[e + 3]);
        *reinterpret_cast<float4*>(v_s + j * DH + c + e) =
            make_float4(vv[e], vv[e + 1], vv[e + 2], vv[e + 3]);
      }
    }
    if (kInt8) {
      for (int j = tid; j < CK; j += kThreads) {
        const int s = c0 + j;
        const int64_t off = (static_cast<int64_t>(b) * S + s) * Hkv + h;
        ksc_s[j] = s < s_end ? ks[off] : 0.f;
        vsc_s[j] = s < s_end ? vs[off] : 0.f;
      }
    }
    __syncthreads();

    // scores: each thread owns one key and RB query rows, d ascending
    for (int item = tid; item < nrb * CK; item += kThreads) {
      const int rb = item / CK, j = item % CK;
      const float4* k4 = reinterpret_cast<const float4*>(k_s + j * KST);
      const float4* q4 = reinterpret_cast<const float4*>(q_s + rb * RB * DH);
      float dot[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) dot[i] = 0.f;
#pragma unroll 4
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 kv = k4[d4];
#pragma unroll
        for (int i = 0; i < RB; ++i) fma4(dot[i], q4[i * D4 + d4], kv);
      }
      const int s = c0 + j;
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = rb * RB + i;
        if (r < R) {
          float sc = dot[i] * scale;
          if (kInt8) sc = sc * ksc_s[j];
          p_s[r * CK + j] = (s < s_end && s <= qpos_s[r]) ? sc : MASK_VAL;
        }
      }
    }
    __syncthreads();

    for (int r = warp; r < R; r += kThreads / 32) {
      const int s = c0 + lane;
      const bool valid = s < s_end && s <= qpos_s[r];
      const float sc = p_s[r * CK + lane];
      float mx = sc;
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float p = valid ? expf(sc - m_new) : 0.f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (kInt8) p = p * vsc_s[lane];
      p_s[r * CK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // p.V: each thread owns four output dims of RB query rows, keys ascending
    for (int item = tid; item < nrb * D4; item += kThreads) {
      const int rb = item / D4, d4 = item % D4;
      const float4* v4 = reinterpret_cast<const float4*>(v_s) + d4;
      const float* pr = p_s + rb * RB * CK;
      float4 pv[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) pv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = 0; j < CK; ++j) {
        const float4 vv = v4[j * D4];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float p = pr[i * CK + j];
          pv[i].x = fmaf(p, vv.x, pv[i].x);
          pv[i].y = fmaf(p, vv.y, pv[i].y);
          pv[i].z = fmaf(p, vv.z, pv[i].z);
          pv[i].w = fmaf(p, vv.w, pv[i].w);
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = rb * RB + i;
        if (r < R) {
          float4* a = reinterpret_cast<float4*>(acc_s + r * DH) + d4;
          const float al = alpha_s[r];
          float4 o = *a;
          o.x = o.x * al + pv[i].x;
          o.y = o.y * al + pv[i].y;
          o.z = o.z * al + pv[i].z;
          o.w = o.w * al + pv[i].w;
          *a = o;
        }
      }
    }
  }
  __syncthreads();

  const int64_t base = (static_cast<int64_t>(bh) * nsplit + split) * R;
  for (int r = tid; r < R; r += kThreads) {
    part_m[base + r] = m_s[r];
    part_l[base + r] = l_s[r];
  }
  for (int i = tid; i < R * DH; i += kThreads) part_acc[base * DH + i] = acc_s[i];
}

// One block per (b, kv head, query row), one thread per output dim: every
// thread reads the row's split maxima and sums (broadcast loads), then its
// column of the partial accumulators (coalesced), over the live splits.
template <typename QT, int DH>
__global__ void __launch_bounds__(DH)
flash_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, const int* __restrict__ qpos,
                   QT* __restrict__ out, int T, int Hq, int Hkv, int split_len,
                   int nsplit) {
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int r = blockIdx.y, d = threadIdx.x;
  const int G = Hq / Hkv, R = G * T, g = r / T, t = r % T;
  const int64_t base = static_cast<int64_t>(bh) * nsplit * R + r;
  const int live = live_splits(qpos + b * T, T, split_len, nsplit);
  float m = MASK_VAL;
  for (int sp = 0; sp < live; ++sp) m = fmaxf(m, part_m[base + sp * R]);
  float l = 0.f, o = 0.f;
  for (int sp = 0; sp < live; ++sp) {
    const int64_t row = base + sp * R;
    const float w = expf(part_m[row] - m);
    l += part_l[row] * w;
    o += part_acc[row * DH + d] * w;
  }
  store(out + ((static_cast<int64_t>(b) * T + t) * Hq + h * G + g) * DH + d,
        o / fmaxf(l, 1e-30f));
}

template <typename QT, typename KVT, int DH>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* qpos, void* out, float* part_m,
           float* part_l, float* part_acc, int B, int T, int Hq, int Hkv, int S,
           int split_len, int nsplit, size_t smem, float scale, cudaStream_t st) {
  auto split = flash_split_kernel<QT, KVT, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  split<<<dim3(B * Hkv, nsplit), kThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), ks, vs, qpos, part_m, part_l, part_acc, T, Hq,
      Hkv, S, split_len, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_merge_kernel<QT, DH><<<dim3(B * Hkv, (Hq / Hkv) * T), DH, 0, st>>>(
      part_m, part_l, part_acc, qpos, static_cast<QT*>(out), T, Hq, Hkv, split_len,
      nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KVT>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const float* ks, const float* vs, const int* qpos, void* out,
              float* pm, float* pl, float* pa, int B, int T, int Hq, int Hkv,
              int S, int split_len, int nsplit, size_t smem, float scale,
              cudaStream_t st) {
  switch (dh) {
    case 32:
      return launch<QT, KVT, 32>(q, k, v, ks, vs, qpos, out, pm, pl, pa, B, T,
                                 Hq, Hkv, S, split_len, nsplit, smem, scale, st);
    case 64:
      return launch<QT, KVT, 64>(q, k, v, ks, vs, qpos, out, pm, pl, pa, B, T,
                                 Hq, Hkv, S, split_len, nsplit, smem, scale, st);
    case 128:
      return launch<QT, KVT, 128>(q, k, v, ks, vs, qpos, out, pm, pl, pa, B, T,
                                  Hq, Hkv, S, split_len, nsplit, smem, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, T, Hq, dh) bf16 (q_is_bf16 != 0) or f32; k, v: (B, S, Hkv, dh) of
// q's type, or int8 (kv_int8 != 0), 16-byte aligned, with ks, vs: (B, S, Hkv)
// f32; qpos: (B, T) int32; out: (B, T, Hq, dh) of q's type.  part_m, part_l: (B*Hkv*nsplit*R)
// f32 and part_acc: (B*Hkv*nsplit*R*dh) f32 scratch, R = (Hq/Hkv)*T,
// nsplit = ceil(S / split_len).  smem: dynamic shared bytes of the split
// kernel.  All contiguous.  Returns a cudaError_t.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const float* ks, const float* vs,
                                   const int* qpos, void* out, float* part_m,
                                   float* part_l, float* part_acc, int B, int T,
                                   int Hq, int Hkv, int S, int dh, int q_is_bf16,
                                   int kv_int8, int split_len, int nsplit,
                                   long long smem, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || T == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const size_t sm = static_cast<size_t>(smem);
  if (q_is_bf16) {
    if (kv_int8)
      return launch_dh<__nv_bfloat16, int8_t>(dh, q, k, v, ks, vs, qpos, out, part_m,
                                              part_l, part_acc, B, T, Hq, Hkv, S,
                                              split_len, nsplit, sm, scale, st);
    return launch_dh<__nv_bfloat16, __nv_bfloat16>(dh, q, k, v, ks, vs, qpos, out,
                                                   part_m, part_l, part_acc, B, T, Hq,
                                                   Hkv, S, split_len, nsplit, sm,
                                                   scale, st);
  }
  if (kv_int8)
    return launch_dh<float, int8_t>(dh, q, k, v, ks, vs, qpos, out, part_m, part_l,
                                    part_acc, B, T, Hq, Hkv, S, split_len, nsplit,
                                    sm, scale, st);
  return launch_dh<float, float>(dh, q, k, v, ks, vs, qpos, out, part_m, part_l,
                                 part_acc, B, T, Hq, Hkv, S, split_len, nsplit, sm,
                                 scale, st);
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
