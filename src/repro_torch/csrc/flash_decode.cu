// Decode/verify attention over a contiguous KV cache: a short query window
// (T = 1 .. gamma+1 positions, G = Hq/Hkv query heads per KV head) against
// S cached keys, with slot == absolute position causality (key s is visible
// to the query at position p iff s <= p) and online softmax.  bf16/f32 K/V,
// or int8 K/V with per-(token, head) f32 scales: the key scale multiplies
// the score columns, the value scale multiplies the probabilities after the
// normaliser has summed them.
//
// Token-tree windows (tree_bits != nullptr): the window's T nodes sit at
// slots [win_start, win_start + T) in packed node order while qpos carries
// win_start + depth, so inside that slot range the template's
// ancestor-or-self mask decides visibility instead of position, read as
// ceil(T/32) bit words per node; slots below win_start keep the positional
// rule, and slots past the window stay masked by it.
//
// Replaces the Pallas TPU kernels repro/kernels/flash_decode.py:_kernel
// (chain, bf16/f32 KV), :_kernel_int8 (chain, int8 KV), :_kernel_tree
// (tree, bf16/f32 KV) and :_kernel_tree_int8 (tree, int8 KV), all through
// _flash_body and the pallas_call at flash_decode.py:248.  The TPU kernel
// gathers each score column's ancestor bit with a one-hot matmul (it has
// no dynamic gather); here each thread reads its bit from the word.
//
// Bound on the H100: bytes.  Each call reads, for each batch row, the K/V
// slots up to the window's last live slot once (Hkv*dh elements each per
// slot, plus the scales) for only 4*G*T operations per cached element pair —
// far below the rate at which arithmetic would bound it.  The last live slot
// is the window's last position for a chain, and the larger of that and
// win_start + T - 1 for a tree, whose nodes are packed past their
// positions.  Slots past it are masked for every query row, so they are
// never read: a split that starts past it is skipped, and the last live
// split stops there.
//
// Design: the TPU kernel walks S as a sequential grid axis carrying (m, l,
// acc) in VMEM; here B*Hkv blocks alone would leave most of the 132 SMs
// idle, so S is split into ranges of split_len keys (flash-decoding).  The
// split depends on S alone — never on T or B — so a query row's result does
// not depend on the window length.  One block per (b, kv head, split, row
// block) holds up to rows_per_block of the G*T query rows of its KV head in
// shared memory — few enough that two 8-warp blocks fit an SM (a tree
// window's rows span several row blocks; each row's sums keep their order,
// so neither the row split nor the thread count changes a bit) — streams its key range
// in chunks of 32 keys (16-byte loads, widened to f32 in shared memory), and
// keeps the running max m, sum l and f32 accumulator per query row in the
// order of flash_decode.py:100-114: s = q.k * scale [* k_scale], masked to
// -1e30; m_new = max(m, max s); p = valid ? exp(s - m_new) : 0;
// l = l*alpha + sum p; p *= v_scale; acc = acc*alpha + p.V.  The two
// products are register-tiled — a thread holds 8 query rows' dot products
// for one key, or 8 rows x 4 dims of p.V — so each shared-memory float4
// feeds 4-32 FMAs.  A second kernel merges the splits and divides by
// max(l, 1e-30), reading only the live splits.  Loads are bounded by S and
// by the last live slot: no slot past either is read.
// Arithmetic is f32 with accurate expf (no fast math).
//
// Paged variant (flash_decode_paged_launch): replaces the Pallas TPU
// kernel repro/kernels/flash_decode.py:_make_paged_kernel (chain and tree,
// bf16/f32 and int8 KV) called by flash_decode_paged (pallas_call at
// flash_decode.py:378).  K/V (and the int8 scales) live in physical pools
// (N, bs, Hkv, dh) shared by all rows, and a (B, nb) int32 block table maps
// logical block s / bs of row b to its physical block; the logical key
// position is s.  The TPU kernel walks logical blocks through scalar-
// prefetched BlockSpec index maps; here the split kernel is the same
// template with another key-row functor (ContigRows / PagedRows): each
// 16-byte load computes its key's pool row from bt[b, s / bs] and s % bs
// (a cached __ldg of the table).  Splits, live range, row blocks and every
// sum keep the contiguous kernel's order, so the paged kernel gives the
// contiguous kernel's bits for the same logical content, for any bs >= 1
// (a 32-key chunk may straddle physical blocks; a 16-byte load never
// does, it stays inside one key's dh row).  Bound on the H100: bytes, as
// the contiguous kernel — the live K/V rows of each batch row, read once:
// the table lookup replaces the address arithmetic and adds no pass over
// K/V.  Slots past the live range are never read, so the unallocated
// logical blocks (all mapped to scratch block 0) cost nothing, and
// results do not depend on nb beyond the live range.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps: 2 blocks of them per SM (see rows_per_block)
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

// One past the last slot any query row of batch row b can see: the
// window's last position + 1, and for a tree window at least
// win_start + T (its packed nodes); never past S.  Keys from there on are
// masked for every query row of the batch row.
__device__ __forceinline__ int live_end(const int* __restrict__ qpos, const int* win_start,
                                        int b, int T, int S) {
  int e = 0;
  for (int t = 0; t < T; ++t) e = max(e, qpos[b * T + t] + 1);
  if (win_start != nullptr) e = max(e, win_start[b] + T);
  return min(e, S);
}

// Splits holding at least one live key.
__device__ __forceinline__ int live_splits(int end, int split_len, int nsplit) {
  return end <= 0 ? 0 : min(nsplit, (end - 1) / split_len + 1);
}

// Is slot s visible to a query row at position qp, window node t?  Inside
// a tree window's slots the ancestor bit decides; elsewhere s <= qp.
__device__ __forceinline__ bool visible(int s, int qp, int t,
                                        const int* __restrict__ tree_bits,
                                        int win_start, int T, int words) {
  if (tree_bits != nullptr) {
    const int rel = s - win_start;
    if (rel >= 0 && rel < T)
      return (__ldg(tree_bits + t * words + (rel >> 5)) >> (rel & 31)) & 1;
  }
  return s <= qp;
}

// Key-row functors: the row of key s of batch row b in a (rows, Hkv, ...)
// K/V (or scale) array.  Contiguous cache: row b*S + s.  Paged pools:
// block bt[b, s / bs] at offset s % bs (s < nb*bs by the live range).
struct ContigRows {
  int S;
  __device__ __forceinline__ int64_t operator()(int b, int s) const {
    return static_cast<int64_t>(b) * S + s;
  }
};
struct PagedRows {
  const int* __restrict__ bt;
  int nb, bs;
  __device__ __forceinline__ int64_t operator()(int b, int s) const {
    const int blk = __ldg(bt + static_cast<int64_t>(b) * nb + s / bs);
    return static_cast<int64_t>(blk) * bs + s % bs;
  }
};

__device__ __forceinline__ void fma4(float& acc, const float4 a, const float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

template <typename QT, typename KVT, int DH, typename Rows>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
                   const KVT* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs, const Rows rows,
                   const int* __restrict__ qpos,
                   const int* __restrict__ tree_bits, const int* __restrict__ win_start,
                   int tree_words, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc, int T,
                   int Hq, int Hkv, int S, int split_len, int rows_per_block,
                   float scale) {
  constexpr bool kInt8 = sizeof(KVT) == 1;
  constexpr int EPV = 16 / sizeof(KVT);  // K/V elements per 16-byte load
  constexpr int VPR = DH / EPV;          // 16-byte loads per key row
  constexpr int D4 = DH / 4;             // float4s per row
  constexpr int KST = DH + 4;            // k_s row stride: float4-aligned, conflict-free
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int G = Hq / Hkv, Rtot = G * T;
  const int row0 = blockIdx.z * rows_per_block;       // this block's query rows
  const int R = min(rows_per_block, Rtot - row0);
  const int nrb = (R + RB - 1) / RB, Rp = ((rows_per_block + RB - 1) / RB) * RB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // keys past the last live slot are masked for every query row: a split
  // that starts past it writes nothing (the merge skips it), and the last
  // live split stops there
  const int end = live_end(qpos, tree_bits != nullptr ? win_start : nullptr, b, T, S);
  const int s_begin = split * split_len;
  if (s_begin >= end) return;
  const int s_end = min(s_begin + split_len, end);
  const int ws = tree_bits != nullptr ? win_start[b] : 0;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [Rp][DH]  local rows r (row0 + r = g*T + t)
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

  // local row r is query row row0 + r = g*T + t
  for (int i = tid; i < R * DH; i += kThreads) {
    const int r = row0 + i / DH, d = i % DH, g = r / T, t = r % T;
    q_s[i] = to_f32(q[((static_cast<int64_t>(b) * T + t) * Hq + h * G + g) * DH + d]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = MASK_VAL;
    l_s[r] = 0.f;
    qpos_s[r] = qpos[b * T + (row0 + r) % T];
  }

  for (int c0 = s_begin; c0 < s_end; c0 += CK) {
    __syncthreads();  // previous chunk fully consumed (and q/acc set up)
    for (int i = tid; i < CK * VPR; i += kThreads) {
      const int j = i / VPR, c = (i % VPR) * EPV, s = c0 + j;
      float kv[EPV], vv[EPV];
      if (s < s_end) {
        const int64_t off = (rows(b, s) * Hkv + h) * DH + c;
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
        if (s < s_end) {
          const int64_t off = rows(b, s) * Hkv + h;
          ksc_s[j] = ks[off];
          vsc_s[j] = vs[off];
        } else {
          ksc_s[j] = vsc_s[j] = 0.f;
        }
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
          p_s[r * CK + j] = (s < s_end && visible(s, qpos_s[r], (row0 + r) % T, tree_bits,
                                                  ws, T, tree_words))
                                ? sc : MASK_VAL;
        }
      }
    }
    __syncthreads();

    for (int r = warp; r < R; r += kThreads / 32) {
      const int s = c0 + lane;
      const bool valid = s < s_end && visible(s, qpos_s[r], (row0 + r) % T, tree_bits, ws,
                                              T, tree_words);
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

  const int64_t base = (static_cast<int64_t>(bh) * nsplit + split) * Rtot + row0;
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
                   const int* __restrict__ win_start, QT* __restrict__ out, int T,
                   int Hq, int Hkv, int S, int split_len, int nsplit) {
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int r = blockIdx.y, d = threadIdx.x;
  const int G = Hq / Hkv, R = G * T, g = r / T, t = r % T;
  const int64_t base = static_cast<int64_t>(bh) * nsplit * R + r;
  const int live = live_splits(live_end(qpos, win_start, b, T, S), split_len, nsplit);
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

// Everything a launch needs beyond the template arguments.
struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *qpos, *tree_bits, *win_start;
  void* out;
  float *part_m, *part_l, *part_acc;
  int B, T, Hq, Hkv, S, tree_words, split_len, nsplit, rows_per_block;
  size_t smem;
  float scale;
  cudaStream_t st;
};

template <typename QT, typename KVT, int DH, typename Rows>
int launch(const Args& a, const Rows rows) {
  auto split = flash_split_kernel<QT, KVT, DH, Rows>;
  if (a.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(a.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int R = (a.Hq / a.Hkv) * a.T;
  const int row_blocks = (R + a.rows_per_block - 1) / a.rows_per_block;
  split<<<dim3(a.B * a.Hkv, a.nsplit, row_blocks), kThreads, a.smem, a.st>>>(
      static_cast<const QT*>(a.q), static_cast<const KVT*>(a.k),
      static_cast<const KVT*>(a.v), a.ks, a.vs, rows, a.qpos, a.tree_bits, a.win_start,
      a.tree_words, a.part_m, a.part_l, a.part_acc, a.T, a.Hq, a.Hkv, a.S,
      a.split_len, a.rows_per_block, a.scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_merge_kernel<QT, DH><<<dim3(a.B * a.Hkv, R), DH, 0, a.st>>>(
      a.part_m, a.part_l, a.part_acc, a.qpos,
      a.tree_bits != nullptr ? a.win_start : nullptr, static_cast<QT*>(a.out), a.T,
      a.Hq, a.Hkv, a.S, a.split_len, a.nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KVT, typename Rows>
int launch_dh(int dh, const Args& a, const Rows rows) {
  switch (dh) {
    case 32:
      return launch<QT, KVT, 32>(a, rows);
    case 64:
      return launch<QT, KVT, 64>(a, rows);
    case 128:
      return launch<QT, KVT, 128>(a, rows);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Rows>
int launch_types(int q_is_bf16, int kv_int8, int dh, const Args& a, const Rows rows) {
  if (q_is_bf16)
    return kv_int8 ? launch_dh<__nv_bfloat16, int8_t>(dh, a, rows)
                   : launch_dh<__nv_bfloat16, __nv_bfloat16>(dh, a, rows);
  return kv_int8 ? launch_dh<float, int8_t>(dh, a, rows) : launch_dh<float, float>(dh, a, rows);
}

}  // namespace

// q: (B, T, Hq, dh) bf16 (q_is_bf16 != 0) or f32; k, v: (B, S, Hkv, dh) of
// q's type, or int8 (kv_int8 != 0), 16-byte aligned, with ks, vs: (B, S, Hkv)
// f32; qpos: (B, T) int32; out: (B, T, Hq, dh) of q's type.  A tree window
// passes tree_bits: (T, tree_words) int32 ancestor-or-self bit words and
// win_start: (B,) int32; a chain passes null for both.  part_m, part_l:
// (B*Hkv*nsplit*R) f32 and part_acc: (B*Hkv*nsplit*R*dh) f32 scratch,
// R = (Hq/Hkv)*T, nsplit = ceil(S / split_len).  rows_per_block: query rows
// per block (a multiple of 8, or R); smem: dynamic shared bytes of the split
// kernel for that many rows.  All contiguous.  Returns a cudaError_t.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const float* ks, const float* vs,
                                   const int* qpos, const int* tree_bits,
                                   const int* win_start, int tree_words, void* out,
                                   float* part_m, float* part_l, float* part_acc,
                                   int B, int T, int Hq, int Hkv, int S, int dh,
                                   int q_is_bf16, int kv_int8, int split_len,
                                   int nsplit, int rows_per_block, long long smem,
                                   float scale, void* stream) {
  if (B == 0 || T == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k, v, ks, vs, qpos, tree_bits, win_start, out, part_m, part_l,
               part_acc, B, T, Hq, Hkv, S, tree_words, split_len, nsplit,
               rows_per_block, static_cast<size_t>(smem), scale,
               static_cast<cudaStream_t>(stream)};
  return launch_types(q_is_bf16, kv_int8, dh, a, ContigRows{S});
}

// As flash_decode_launch, over paged pools: k, v: (N, bs, Hkv, dh) and ks,
// vs: (N, bs, Hkv) f32 (int8 KV) addressed through bt: (B, nb) int32
// physical block ids in [0, N); the logical cache length is S = nb * bs,
// and nsplit = ceil(S / split_len).  Returns a cudaError_t.
extern "C" int flash_decode_paged_launch(const void* q, const void* k, const void* v,
                                         const float* ks, const float* vs, const int* bt,
                                         int nb, int bs, const int* qpos,
                                         const int* tree_bits, const int* win_start,
                                         int tree_words, void* out, float* part_m,
                                         float* part_l, float* part_acc, int B, int T,
                                         int Hq, int Hkv, int dh, int q_is_bf16,
                                         int kv_int8, int split_len, int nsplit,
                                         int rows_per_block, long long smem, float scale,
                                         void* stream) {
  const int S = nb * bs;
  if (B == 0 || T == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k, v, ks, vs, qpos, tree_bits, win_start, out, part_m, part_l,
               part_acc, B, T, Hq, Hkv, S, tree_words, split_len, nsplit,
               rows_per_block, static_cast<size_t>(smem), scale,
               static_cast<cudaStream_t>(stream)};
  return launch_types(q_is_bf16, kv_int8, dh, a, PagedRows{bt, nb, bs});
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
