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
// Ring caches (kpos != nullptr, the sliding window): each slot holds the
// absolute position kpos[b, s] of the key it stores (-2^30 while unwritten),
// and key s is visible to the query at position p iff 0 <= p - kpos[b, s] <
// window.  Once the ring has wrapped any slot can be live, so no split is
// past the live range; the split layout depends on S alone, so a row's bits
// depend on neither T nor B.  bf16 queries read a ring through a body of
// its own (flash_sliced_kernel, below); f32 queries through the f32 body.
// The reference reads a ring through plain jnp (repro/models/attention.py:242
// attend); this variant is the port's own, for row invariance on the card.
//
// Replaces the Pallas TPU kernels repro/kernels/flash_decode.py:_kernel
// (chain, bf16/f32 KV), :_kernel_int8 (chain, int8 KV), :_kernel_tree
// (tree, bf16/f32 KV) and :_kernel_tree_int8 (tree, int8 KV), all through
// _flash_body and the pallas_call at flash_decode.py:248, and — through the
// PagedRows functor below — :_make_paged_kernel (pallas_call at
// flash_decode.py:378).  Each computes what _flash_body does:
// s = q.k * scale [* k_scale], masked to -1e30; m_new = max(m, max s);
// p = valid ? exp(s - m_new) : 0; l = l*alpha + sum p; p *= v_scale;
// acc = acc*alpha + p.V; out = acc / max(l, 1e-30).
//
// Bound on the H100: bytes.  Each call reads, for each batch row, the K/V
// slots up to the window's last live slot once (Hkv*dh elements each per
// slot, plus the scales) for only 4*G*T operations per cached element pair.
// The last live slot is the window's last position for a chain, and the
// larger of that and win_start + T - 1 for a tree, whose nodes are packed
// past their positions; slots past it are masked for every query row and
// never read.  A ring reads the slots some query row sees (the ring body
// skips the 32-key chunks no row sees) and each read slot's position.
//
// Design.  S is split into 128-key ranges (flash-decoding: B*Hkv blocks
// alone would leave most of the 132 SMs idle); the split depends on S
// alone, never on T or B, a split past the live range is skipped, and a
// second kernel merges the live splits in split order and divides by
// max(l, 1e-30).  Three split bodies: the tensor-core body and the f32
// body below, and the sliced body (flash_sliced_kernel, its own note) for a
// ring with bf16 queries and for the cross-attention read
// (flash_decode_cross_launch), whose split length comes from S alone and
// which merges its splits itself.
//
// * Tensor-core body (bf16 queries, bf16 or int8 K/V) — what the earlier
//   CUDA-core kernel lost time to, and what this one does about it:
//   1. Both products ran on CUDA cores in f32 with most threads idle, at a
//      cost linear in the G*T rows.  Here one block per (b, kv head, split)
//      holds all G*T rows of its KV head when G*T <= 128 (wider windows take
//      ceil(G*T / 128) row blocks, each re-reading its split's K/V, mostly
//      from L2); warp w owns the 16-row tile w and sweeps every key of the
//      split, its m, l and f32 accumulator in registers.  s = q.k^T and p.V
//      run on mma.sync.m16n8k16 bf16 -> f32, K fragments from ldmatrix on
//      the key rows, V fragments from ldmatrix.trans (int8 K/V: every
//      thread of the block, the copying warps too, widens the chunk's codes
//      to bf16 in shared memory first — exact, |x| <= 127 — so both
//      types share one fragment path).  P enters p.V as two bf16 terms,
//      hi = bf16(p) and lo = bf16(p - hi), into the same accumulator: a
//      single bf16 P loses ~2^-9 of each weight, hi + lo keeps ~16 bits.
//      Row max and row sum are taken within the quad of lanes sharing an
//      accumulator row (xor 1, 2) after each lane folds its own values in
//      a fixed order; exp is ex2.approx on the scaled argument (relative
//      error ~2^-22).
//   2. No copy overlapped the math.  Here K/V are copied with 16-byte
//      cp.async in their stored type (bf16 or int8, never to f32) into a
//      ring of three 32-key chunks: two chunks are in flight while one is
//      used.  Rows are padded by 16 bytes, so ldmatrix has no bank conflict.
//      cp.async rather than TMA: each 16-byte piece's address comes from the
//      key-row functor, which is what keeps the paged kernel bit-equal to
//      the contiguous one for any block size.
//   3. Wide windows read K/V once per row block of at most 64 rows (dh
//      128: six at (4,4,4)'s 340 rows); here once per row block of at most
//      128 rows (three), and once in all for G*T <= 128.
//   A query row's bits depend on neither T nor B: every row's sums run in
//   the same order whatever tile, warp or row block holds it (mma computes
//   each output element from its own row and column alone), keys are never
//   handed between warps, and chunks past the live range — the only thing
//   T changes — add exact zeros.  Warps past the last tile only copy.
// * f32 body (f32 queries; f32 or int8 K/V), the reduced config's path:
//   CUDA cores in f32 throughout (TF32 would miss the 1e-5 agreement), one
//   thread per (key, 8 rows) for the scores and per (4 dims, 8 rows) for
//   p.V over 32-key chunks widened to f32 in shared memory, rows per block
//   as many as keep two blocks on an SM.
//
// Paged variant (flash_decode_paged_launch): K/V (and the int8 scales) live
// in physical pools (N, bs, Hkv, dh) shared by all rows, and a (B, nb)
// int32 block table maps logical block s / bs of row b to its physical
// block; the logical key position is s.  The TPU kernel walks logical
// blocks through scalar-prefetched BlockSpec index maps; here both split
// bodies take a key-row functor (ContigRows / PagedRows): each 16-byte copy
// computes its key's pool row from bt[b, s / bs] and s % bs (a cached __ldg
// of the table).  Splits, live range, row blocks and every sum keep the
// contiguous kernel's order, so the paged kernel gives the contiguous
// kernel's bits for any bs >= 1 (a chunk may straddle physical blocks; a
// 16-byte copy never does).  Bound: bytes, as the contiguous kernel — the
// table lookup adds no pass over K/V, and slots past the live range (the
// unallocated logical blocks, all on scratch block 0) are never read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // 8 warps
constexpr int CK = 32;          // keys per chunk: one online-softmax update (both bodies)
constexpr int SPLIT = 128;      // keys per split (SPLIT_LEN in kernels/flash_decode.py)
constexpr int RING = 3;         // tensor-core body: K/V chunks staged at once (cp.async ring)
constexpr int RB = 8;           // f32 body: query rows per register block
constexpr int RING_SLICES = 4;  // ring body: key slices per split (RING_SLICES in flash_decode.py)
constexpr int RING_ROWS = 32;   // ring body: most query rows per block (two 16-row tiles)
constexpr int RCK = 16;         // ring body: keys per chunk (one online-softmax update)
constexpr int RING_STAGES = 3;  // sliced body: chunk slots per slice (two in flight, one read)
constexpr int RING_MAX_PAIRS = 4;  // ring body: most 32-key runs per slice (split <= 512 keys)
constexpr int NEG_POS = -(1 << 30);  // an unwritten ring slot's position (models/attention.py)
constexpr float MASK_VAL = -1e30f;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// f32 body: one 16-byte load of K/V elements, widened to f32 (4 or 16 values).
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
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
// masked for every query row of the batch row.  A ring (kpos) may hold a
// live key in any slot, and the cross read (no qpos) sees every slot: S.
__device__ __forceinline__ int live_end(const int* __restrict__ qpos, const int* win_start,
                                        const int* kpos, int b, int T, int S) {
  if (kpos != nullptr || qpos == nullptr) return S;
  int e = 0;
  for (int t = 0; t < T; ++t) e = max(e, qpos[b * T + t] + 1);
  if (win_start != nullptr) e = max(e, win_start[b] + T);
  return min(e, S);
}

// Splits of split_len keys holding at least one live key.
__device__ __forceinline__ int live_splits(int end, int nsplit, int split_len) {
  return end <= 0 ? 0 : min(nsplit, (end - 1) / split_len + 1);
}

// Is slot s visible to a query row at position qp, window node t?  Over a
// ring (kpos_b: batch row b's slot positions) iff 0 <= qp - kpos_b[s] <
// window (qp < 2^30, so the difference stays in int); inside a tree
// window's slots the ancestor bit decides; elsewhere s <= qp.
__device__ __forceinline__ bool visible(int s, int qp, int t,
                                        const int* __restrict__ tree_bits,
                                        int win_start, int T, int words,
                                        const int* __restrict__ kpos_b, int window) {
  if (kpos_b != nullptr) {
    const int d = qp - __ldg(kpos_b + s);
    return d >= 0 && d < window;
  }
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

// The f32 body (f32 queries; f32 or int8 K/V): CUDA cores, f32 throughout,
// so the reduced config's f32 path keeps its 1e-5 agreement (TF32 would
// not).  One thread per (key, 8 query rows) for the scores and per (4 dims,
// 8 query rows) for p.V, over 32-key chunks widened to f32 in shared memory.
template <typename KVT, int DH, typename Rows>
__global__ void __launch_bounds__(kMaxThreads)
flash_split_f32_kernel(const float* __restrict__ q, const KVT* __restrict__ k,
                       const KVT* __restrict__ v, const float* __restrict__ ks,
                       const float* __restrict__ vs, const Rows rows,
                       const int* __restrict__ qpos, const int* __restrict__ tree_bits,
                       const int* __restrict__ win_start, int tree_words,
                       const int* __restrict__ kpos, int window,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int T, int Hq, int Hkv, int S,
                       int rows_per_block, float scale) {
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
  const int end = live_end(qpos, tree_bits != nullptr ? win_start : nullptr, kpos, b, T, S);
  const int* kpos_b = kpos != nullptr ? kpos + static_cast<int64_t>(b) * S : nullptr;
  const int s_begin = split * SPLIT;
  if (s_begin >= end) return;
  const int s_end = min(s_begin + SPLIT, end);
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
  for (int i = tid; i < R * DH; i += kMaxThreads) {
    const int r = row0 + i / DH, d = i % DH, g = r / T, t = r % T;
    q_s[i] = q[((static_cast<int64_t>(b) * T + t) * Hq + h * G + g) * DH + d];
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kMaxThreads) {
    m_s[r] = MASK_VAL;
    l_s[r] = 0.f;
    qpos_s[r] = qpos != nullptr ? qpos[b * T + (row0 + r) % T] : S - 1;  // cross: every key
  }

  for (int c0 = s_begin; c0 < s_end; c0 += CK) {
    __syncthreads();  // previous chunk fully consumed (and q/acc set up)
    for (int i = tid; i < CK * VPR; i += kMaxThreads) {
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
      for (int j = tid; j < CK; j += kMaxThreads) {
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
    for (int item = tid; item < nrb * CK; item += kMaxThreads) {
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
                                                  ws, T, tree_words, kpos_b, window))
                                ? sc : MASK_VAL;
        }
      }
    }
    __syncthreads();

    for (int r = warp; r < R; r += kMaxThreads / 32) {
      const int s = c0 + lane;
      const bool valid = s < s_end && visible(s, qpos_s[r], (row0 + r) % T, tree_bits, ws,
                                              T, tree_words, kpos_b, window);
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
    for (int item = tid; item < nrb * D4; item += kMaxThreads) {
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
  for (int r = tid; r < R; r += kMaxThreads) {
    part_m[base + r] = m_s[r];
    part_l[base + r] = l_s[r];
  }
  for (int i = tid; i < R * DH; i += kMaxThreads) part_acc[base * DH + i] = acc_s[i];
}

// ---------------------------------------------------------------------------
// Tensor-core body (bf16 queries; bf16 or int8 K/V)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Async 16- and 4-byte copies to shared memory; pred false reads nothing
// and zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}
// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// e^x as 2^(x log2 e) on the special-function unit (relative error ~2^-22).
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}
// Two values as a bf16x2 register, lo in the low half (exact for int8 codes).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack_s8(int8_t lo, int8_t hi) {
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}
// Eight int8 codes (8-byte aligned) to eight bf16 (16-byte aligned), exact.
__device__ __forceinline__ void widen8(unsigned char* dst, const unsigned char* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_s8(c[0], c[1]), pack_s8(c[2], c[3]),
                                              pack_s8(c[4], c[5]), pack_s8(c[6], c[7]));
}
// p = hi + lo to ~16 bits: hi = bf16(p), lo = bf16(p - hi), for a pair.
__device__ __forceinline__ void split_pair(float p0, float p1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
  __nv_bfloat162 h;
  h.x = h0;
  h.y = h1;
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = pack_bf16(p0 - __bfloat162float(h0), p1 - __bfloat162float(h1));
}

// One block per (b, kv head, split, row block), 32 * max(4, tiles) threads.
// Warp w owns the 16-row tile w of the block's rows (tiles = ceil(R / 16))
// and sweeps every key of the split; warps past the last tile only copy.
// Fragment layouts of m16n8k16 (g = lane / 4, c = lane % 4): A rows g, g+8,
// k pairs 2c, 2c+8; B k pairs 2c, 2c+8, column g; C rows g, g+8, columns
// 2c, 2c+1.
// Two blocks per SM cap a thread at 128 registers; at DH 160 the 20
// accumulator tiles do not fit in them (ptxas spilled 44-56 bytes), so that
// head size asks for one.
template <typename KVT, int DH, typename Rows>
__global__ void __launch_bounds__(kMaxThreads, DH > 128 ? 1 : 2)
flash_split_mma_kernel(const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ k,
                       const KVT* __restrict__ v, const float* __restrict__ ks,
                       const float* __restrict__ vs, const Rows rows,
                       const int* __restrict__ qpos, const int* __restrict__ tree_bits,
                       const int* __restrict__ win_start, int tree_words,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int T, int Hq, int Hkv, int S,
                       int rows_per_block, float scale) {
  constexpr bool kInt8 = sizeof(KVT) == 1;
  constexpr int EPV = 16 / sizeof(KVT);               // K/V elements per 16-byte copy
  constexpr int VPR = DH / EPV;                       // copies per key row
  constexpr int KROW = DH * sizeof(KVT) + 16;         // padded: ldmatrix conflict-free
  constexpr int BROW = DH * 2 + 16;                   // a bf16 row, padded (Q, widened K/V)
  constexpr int NKT = CK / 8;                         // key tiles of 8 per chunk
  constexpr int NDT = DH / 8;                         // dim tiles of 8
  constexpr int KST = DH / 16;                        // k steps of q.k
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int G = Hq / Hkv, Rtot = G * T;
  const int row0 = blockIdx.z * rows_per_block;
  const int R = min(rows_per_block, Rtot - row0);
  const int tiles = (R + 15) / 16;
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int end = live_end(qpos, tree_bits != nullptr ? win_start : nullptr, nullptr, b, T, S);
  const int s_begin = split * SPLIT;
  if (s_begin >= end) return;
  const int s_end = min(s_begin + SPLIT, end);
  const int nch = (s_end - s_begin + CK - 1) / CK;
  const int ws = tree_bits != nullptr ? win_start[b] : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = smem_raw;                      // [tiles * 16][BROW]
  unsigned char* k_s = q_s + tiles * 16 * BROW;       // [RING][CK][KROW]
  unsigned char* v_s = k_s + RING * CK * KROW;        // [RING][CK][KROW]
  float* ksc_s = reinterpret_cast<float*>(v_s + RING * CK * KROW);  // [RING][CK] int8 only
  float* vsc_s = ksc_s + RING * CK;                   // [RING][CK]
  unsigned char* kw_s = reinterpret_cast<unsigned char*>(vsc_s + RING * CK);  // [CK][BROW] int8
  unsigned char* vw_s = kw_s + CK * BROW;             // [CK][BROW] int8 only

  // the block's query rows (local row r = query row row0 + r = g*T + t),
  // pad rows zero, go with chunk 0's copy group
  for (int i = tid; i < tiles * 16 * (DH / 8); i += nthr) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8, qr = row0 + r;
    const bool ok = r < R;
    const __nv_bfloat16* src =
        ok ? q + ((static_cast<int64_t>(b) * T + qr % T) * Hq + h * G + qr / T) * DH + c : q;
    cp_async16(q_s + r * BROW + c * 2, src, ok);
  }
  // chunk c of the split into ring slot c % RING, as one copy group (empty
  // past the live chunks, so every thread's group count stays the same)
  auto load_chunk = [&](int c) {
    if (c < nch) {
      const int c0 = s_begin + c * CK, slot = (c % RING) * CK;
      for (int i = tid; i < CK * VPR; i += nthr) {
        const int j = i / VPR, e = (i % VPR) * EPV, s = c0 + j;
        const bool ok = s < s_end;
        const int64_t off = ok ? (rows(b, s) * Hkv + h) * DH + e : 0;
        const int dst = (slot + j) * KROW + e * static_cast<int>(sizeof(KVT));
        cp_async16(k_s + dst, k + off, ok);
        cp_async16(v_s + dst, v + off, ok);
      }
      if (kInt8) {
        for (int j = tid; j < CK; j += nthr) {
          const int s = c0 + j;
          const bool ok = s < s_end;
          const int64_t off = ok ? rows(b, s) * Hkv + h : 0;
          cp_async4(ksc_s + slot + j, ks + off, ok);
          cp_async4(vsc_s + slot + j, vs + off, ok);
        }
      }
    }
    cp_async_commit();
  };
  for (int c = 0; c < RING - 1; ++c) load_chunk(c);

  const bool active = warp < tiles;  // warp-uniform
  const int g = lane >> 2, c4 = lane & 3, tr0 = warp * 16;
  bool live[2];
  int qp[2], tt[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tr0 + g + 8 * i;
    live[i] = r < R;
    tt[i] = (row0 + r) % T;
    qp[i] = live[i] ? qpos[b * T + tt[i]] : -1;
    m[i] = MASK_VAL;
    l[i] = 0.f;
  }
  float acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const unsigned char* q_lane = q_s + (tr0 + (lane & 15)) * BROW + (lane >> 4) * 16;

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<RING - 2>();  // chunk c has landed (later ones may be in flight) ...
    __syncthreads();    // ... for every thread, and chunk c - 1's slot is free
    load_chunk(c + RING - 1);
    const int cb = (c % RING) * CK;  // chunk's first row in the ring
    const int kb = s_begin + c * CK;  // and its first key
    const unsigned char* kc = k_s + cb * KROW;  // the chunk's K and V rows as bf16,
    const unsigned char* vc = v_s + cb * KROW;  // BROW bytes apart
    if constexpr (kInt8) {
      // every thread widens the chunk's int8 codes to bf16 (exact: |x| <= 127)
      for (int i = tid; i < CK * (DH / 8); i += nthr) {
        const int j = i / (DH / 8), d = (i % (DH / 8)) * 8;
        widen8(kw_s + j * BROW + d * 2, k_s + (cb + j) * KROW + d);
        widen8(vw_s + j * BROW + d * 2, v_s + (cb + j) * KROW + d);
      }
      __syncthreads();
      kc = kw_s;
      vc = vw_s;
    }
    if (!active) continue;

    // scores: q.k over dh in ascending k steps, per 8-key tile
    float sc[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KST; ++kk) {
      unsigned qf[4];
      ldsm_x4(qf, q_lane + kk * 32);
#pragma unroll
      for (int n = 0; n < NKT; n += 2) {
        unsigned bk[4];
        const int key = 8 * n + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(bk, kc + key * BROW + (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(sc[n], qf, bk[0], bk[1]);
        mma_bf16(sc[n + 1], qf, bk[2], bk[3]);
      }
    }

    // online softmax on the accumulator fragments: a row's values sit in
    // the 4 lanes of a quad; each lane folds its own in a fixed order, then
    // the quad combines them with xor 1, 2
    unsigned okbits = 0;
    float mx[2] = {MASK_VAL, MASK_VAL};
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, j = 8 * n + 2 * c4 + (e & 1), s = kb + j;
        float x = sc[n][e] * scale;
        if (kInt8) x = x * ksc_s[cb + j];
        const bool ok = live[i] && s < s_end &&
                        visible(s, qp[i], tt[i], tree_bits, ws, T, tree_words, nullptr, 0);
        okbits |= static_cast<unsigned>(ok) << (4 * n + e);
        sc[n][e] = ok ? x : MASK_VAL;
        mx[i] = fmaxf(mx[i], sc[n][e]);
      }
    float alpha[2], mnew[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mnew[i] = fmaxf(m[i], mx[i]);
      alpha[i] = fast_exp(m[i] - mnew[i]);
    }
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = (okbits >> (4 * n + e)) & 1u ? fast_exp(sc[n][e] - mnew[i]) : 0.f;
        sum[i] += p;
        if (kInt8) p = p * vsc_s[cb + 8 * n + 2 * c4 + (e & 1)];
        sc[n][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
      m[i] = mnew[i];
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // x * 1 == x
#pragma unroll
      for (int n = 0; n < NDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }

    // p.V: P as two bf16 terms (hi, lo) into the same f32 accumulators,
    // 16 keys per k step in ascending order
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      unsigned ph[4], pl[4];
      split_pair(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split_pair(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split_pair(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NDT; n += 2) {
        unsigned bv[4];
        const int key = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4_t(bv, vc + key * BROW + (8 * n + ((lane >> 4) << 3)) * 2);
        mma_bf16(acc[n], ph, bv[0], bv[1]);
        mma_bf16(acc[n], pl, bv[0], bv[1]);
        mma_bf16(acc[n + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[n + 1], pl, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (none is pending past nch)
  if (!active) return;

  const int64_t base = (static_cast<int64_t>(bh) * nsplit + split) * Rtot + row0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tr0 + g + 8 * i;
    if (!live[i]) continue;
    if (c4 == 0) {
      part_m[base + r] = m[i];
      part_l[base + r] = l[i];
    }
    float* o = part_acc + (base + r) * DH + 2 * c4;
#pragma unroll
    for (int n = 0; n < NDT; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) = make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// Sliced body (bf16 queries: a contiguous ring with bf16 or int8 K/V, no
// tree; or the cross-attention read over bf16 K/V)
// ---------------------------------------------------------------------------

// Wait at named barrier id (1..15; 0 is __syncthreads) for n threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// What held the first ring read (the tensor-core body above with kpos) back,
// and what this body does about it:
// 1. Few warps did math: one warp per 16-row tile swept its split's keys,
//    so the 7B's T 6 (24 rows) kept 2 warps busy and T 1 one.  Here each
//    split's RCK-key chunks are dealt in order to RING_SLICES key slices,
//    as evenly as they go, and one warp runs per (16-row tile, slice),
//    tiles * RING_SLICES warps, each with its own m, l and f32
//    accumulator; at the block's end the slices' (m, l, acc) are folded in
//    slice order through shared memory (the K/V stages, then free).
// 2. kpos came from global memory, one load per score.  Here a chunk's
//    positions are copied into shared memory in the copy group of its K/V,
//    and visibility is taken from there.  The skip test below reads each
//    position once more, with one coalesced load per 32 keys, issued for
//    all of a slice's keys when the block starts.
// 3. Every split was read.  A RCK-key chunk none of whose slots any query
//    row of the block can see — unwritten slots (NEG_POS) of a fresh or
//    reset ring, keys older than the window — is neither copied nor
//    computed.  The loop would add exact zeros for it (alpha = 1, p = 0), so
//    skipping it moves no bit; a wholly masked split writes what the loop
//    leaves (m = -1e30, l = 0, acc = 0).
// 4. 128-key splits wrote 13 MB of f32 partials at the 7B's B 4, T 6, and
//    a second kernel merged them.  Here the split length comes from S alone
//    (kernels/flash_decode.py ring_split_len: 272 keys over the 7B's
//    4224-slot ring, 16 splits, so B 1's 8 KV heads run 128 blocks on the
//    132 SMs and B 4's 512 blocks two rounds of two per SM), which halves
//    them, and the merge runs in the kernel: the last block of a (b, kv
//    head, row block) to finish — a counter per (b, kv head, row block),
//    which that block sets back to 0, so a CUDA graph replays the launch —
//    folds the splits' partials in split order from L2 and writes the
//    output.
// 5. Copies: a slice streams its live chunks through RING_STAGES stages of
//    its own with 16-byte cp.async, two chunks in flight while it computes
//    one, behind a named barrier of its own warps: no block-wide barrier
//    per chunk, no producer warp to hand a chunk over.  cp.async rather than
//    TMA: a slice copies only the chunks its positions show live, a list
//    known only once the block has read them; one TMA bulk copy per K or V
//    row (a 16-key chunk's rows lie Hkv * dh apart) ran slower than these
//    copies at the 7B's shapes on the H100, and 2-D tiles would need a
//    swizzle that no box width serves at dh 80 and 160.
//    ~114 KB per block (bf16, dh 128) keeps two blocks on an SM, so one
//    block's start (positions, Q) and fold overlap the other's copies.
// 6. int8 K/V: a slice's threads widen only its own chunk to bf16 in its
//    own buffer (exact, |x| <= 127), behind the slice's barrier.
// A query row's bits depend on neither T nor B: the slices, their keys and
// the chunks' order depend on S alone (tiles, warps and row blocks follow
// G*T, but mma computes each row from its own row, and every row's sums
// run in the same order), a chunk is skipped only where it adds exact
// zeros to every row of the block, and the fold and the merge run in slice
// and split order.
//
// The cross-attention read (RING false; bf16 queries and K/V, no kpos, no
// qpos) runs the same body: every key is visible, so it makes and reads no
// positions, skips no chunk and masks only the keys of the last chunk
// past S.  It replaces no TPU kernel: the reference computes it as a plain
// attend(causal=False) (repro/models/attention.py:459 cross_attention),
// which the port first ran through the tensor-core body with every query
// at Sa - 1 — 128-key splits (576 blocks of 32 KB at whisper's B 4), one
// computing warp per 16-row tile, a fill kernel for the positions and a
// merge kernel after it.  Bound: bytes (each K/V row once; 4*G*T
// operations per element pair).  Here the splits come from S alone
// (kernels/flash_decode.py cross_split: four of 384 keys at whisper's 1500
// frames, of 400 at vision's 1600 image tokens), so B 4 runs one round of
// 192 and 128 blocks; a block holds up to cross_rows(DH) = 64 query rows
// (vision's 48 rows per KV head in one block: K/V read once); and the
// splits merge in the launch as the ring's do.
template <int DH>
__host__ __device__ constexpr int sliced_threads(bool ring) {  // most threads of a block: tiles * RING_SLICES warps
  return 32 * RING_SLICES * (ring ? RING_ROWS : DH > 128 ? 32 : 64) / 16;
}
template <typename KVT, int DH, bool RING>
__global__ void __launch_bounds__(sliced_threads<DH>(RING), RING && DH <= 128 ? 2 : 1)
flash_sliced_kernel(const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ k,
                    const KVT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, int window,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int* __restrict__ counters,
                    __nv_bfloat16* __restrict__ out, int T, int Hq, int Hkv, int S,
                    int split_len, int rows_per_block, float scale) {
  static_assert(RING || sizeof(KVT) == 2, "the cross read's K/V are bf16");
  constexpr bool kInt8 = sizeof(KVT) == 1;
  constexpr int EPV = 16 / sizeof(KVT);               // K/V elements per 16-byte copy
  constexpr int VPR = DH / EPV;                       // copies per key row
  constexpr int BROW = DH * 2 + 16;                   // a bf16 row, padded: ldmatrix conflict-free
  constexpr int KROW = kInt8 ? DH : BROW;             // a staged K/V row (int8 rows unpadded)
  constexpr int NDT = DH / 8;                         // dim tiles of 8
  constexpr int KST = DH / 16;                        // k steps of q.k
  // a stage: K and V rows; a ring: positions; int8: scales
  constexpr int STAGE = 2 * RCK * KROW + (RING ? 4 * RCK : 0) + (kInt8 ? 2 * 4 * RCK : 0);
  // a slice: its stages; int8: one chunk widened to bf16
  constexpr int SLICE = RING_STAGES * STAGE + (kInt8 ? 2 * RCK * BROW : 0);
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int G = Hq / Hkv, Rtot = G * T;
  const int row0 = blockIdx.z * rows_per_block;
  const int R = min(rows_per_block, Rtot - row0);  // the last row block may hold fewer
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = nthr / (32 * RING_SLICES), Rp = tiles * 16;  // ceil(rows_per_block / 16)
  const int slice = warp / tiles, tile = warp % tiles;
  const int sl_threads = 32 * tiles, stid = tid - slice * sl_threads;
  // the split's RCK-key chunks dealt to the slices in order, as evenly as
  // they go (17 chunks: 4, 4, 4, 5)
  const int nchunks = split_len / RCK;
  const int c_lo = slice * nchunks / RING_SLICES, c_hi = (slice + 1) * nchunks / RING_SLICES;
  const int sl_keys = (c_hi - c_lo) * RCK;            // at most 32 * RING_MAX_PAIRS
  const int k0 = split * split_len + c_lo * RCK;      // the slice's first key
  const int* kpos_b = RING ? kpos + static_cast<int64_t>(b) * S : nullptr;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = smem_raw;                      // [Rp][BROW]
  unsigned char* slots = q_s + Rp * BROW;             // [RING_SLICES][SLICE]
  unsigned char* sl_base = slots + slice * SLICE;     // this slice's stages
  unsigned char* kw_s = sl_base + RING_STAGES * STAGE;  // [RCK][BROW] int8: widened K
  unsigned char* vw_s = kw_s + RCK * BROW;            // [RCK][BROW] int8: widened V
  // after the sweep, the stages hold the fold: each slice's accumulators
  // (rows FROW floats apart: a warp's fragment stores fall in distinct
  // banks), and its m, l and weight exp(m - max m) per row
  constexpr int FROW = DH + 8;
  // (the per-row arrays RS floats apart: the ring's most rows, the cross
  // read's block rows)
  const int RS = RING ? RING_ROWS : Rp;
  float* facc = reinterpret_cast<float*>(slots);      // [RING_SLICES][Rp][FROW]
  float* fm = facc + RING_SLICES * Rp * FROW;         // [RING_SLICES][RS]
  float* fl = fm + RING_SLICES * RS;
  float* fw = fl + RING_SLICES * RS;
  __shared__ int is_last;

  // the block's query rows (local row r = query row row0 + r = g*T + t),
  // pad rows zero
  for (int i = tid; i < Rp * (DH / 8); i += nthr) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8, qr = row0 + r;
    const bool ok = r < R;
    const __nv_bfloat16* src =
        ok ? q + ((static_cast<int64_t>(b) * T + qr % T) * Hq + h * G + qr / T) * DH + c : q;
    cp_async16(q_s + r * BROW + c * 2, src, ok);
  }
  cp_async_commit();
  unsigned todo = 0;  // bit c: chunk c of the slice is read (the same in every warp of the slice)
  if constexpr (RING) {
    // the skip test: the slice's positions, 32 keys per load (lane j: key j
    // of each 32; NEG_POS past S), and the span [qlo, qhi] of the block's
    // query positions (lane i: position i), all loads in flight at once
    int kp[RING_MAX_PAIRS];
#pragma unroll
    for (int c = 0; c < RING_MAX_PAIRS; ++c) {
      const int s = k0 + 32 * c + lane;
      kp[c] = 32 * c + lane < sl_keys && s < S ? __ldg(kpos_b + s) : NEG_POS;
    }
    int qlo = 0x7fffffff, qhi = -0x7fffffff - 1;
    for (int i = lane; i < min(R, T); i += 32) {
      const int p = __ldg(qpos + b * T + (row0 + i) % T);
      qlo = min(qlo, p);
      qhi = max(qhi, p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qlo = min(qlo, __shfl_xor_sync(0xffffffffu, qlo, o));
      qhi = max(qhi, __shfl_xor_sync(0xffffffffu, qhi, o));
    }
    // a key at kpl may be seen by some query row of the block iff kpl <= p <
    // kpl + window for a position p in [qlo, qhi] (|p|, |kpl| <= 2^30: no
    // overflow): chunk c holds such a key
#pragma unroll
    for (int c = 0; c < RING_MAX_PAIRS; ++c) {
      const unsigned seen = __ballot_sync(0xffffffffu, kp[c] <= qhi && qlo - kp[c] < window);
      todo |= (static_cast<unsigned>((seen & 0xffffu) != 0) |
               (static_cast<unsigned>((seen >> 16) != 0) << 1)) << (2 * c);
    }
  } else {
    // the cross read: every chunk that starts before S
    const int n = min(sl_keys / RCK, max(0, (S - k0 + RCK - 1) / RCK));
    todo = (1u << n) - 1u;
  }
  const int nlive = __popc(todo);

  // live chunk i of the slice into stage i % RING_STAGES, one copy group per
  // thread (empty past the live chunks, so every thread of the slice keeps
  // the same group count)
  unsigned rest = todo;  // live chunks not yet issued, lowest first
  auto issue = [&](int i) {
    if (i < nlive) {
      const int c = __ffs(static_cast<int>(rest)) - 1;
      rest &= rest - 1;
      const int cb = k0 + c * RCK;
      unsigned char* st = sl_base + (i % RING_STAGES) * STAGE;
      for (int x = stid; x < RCK * VPR; x += sl_threads) {
        const int j = x / VPR, e = (x % VPR) * EPV, s = cb + j;
        const bool ok = s < S;
        const int64_t off = ok ? ((static_cast<int64_t>(b) * S + s) * Hkv + h) * DH + e : 0;
        const int dst = j * KROW + e * static_cast<int>(sizeof(KVT));
        cp_async16(st + dst, k + off, ok);
        cp_async16(st + RCK * KROW + dst, v + off, ok);
      }
      int* kp_s = reinterpret_cast<int*>(st + 2 * RCK * KROW);
      for (int j = stid; j < RCK && RING; j += sl_threads) {
        const int s = cb + j;
        cp_async4(kp_s + j, kpos_b + (s < S ? s : 0), s < S);  // past S: masked below
        if constexpr (kInt8) {
          const int64_t off = s < S ? (static_cast<int64_t>(b) * S + s) * Hkv + h : 0;
          cp_async4(kp_s + RCK + j, ks + off, s < S);
          cp_async4(kp_s + 2 * RCK + j, vs + off, s < S);
        }
      }
    }
    cp_async_commit();
  };
  // the key base of each issued chunk, in issue order (the chunks' order)
  unsigned order = todo;
#pragma unroll
  for (int i = 0; i < RING_STAGES - 1; ++i) issue(i);

  const int g = lane >> 2, c4 = lane & 3, tr0 = tile * 16;
  bool live[2];
  int qp[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tr0 + g + 8 * i;
    live[i] = r < R;
    qp[i] = RING && live[i] ? __ldg(qpos + b * T + (row0 + r) % T) : 0;
    m[i] = MASK_VAL;
    l[i] = 0.f;
  }
  float acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const unsigned char* q_lane = q_s + (tr0 + (lane & 15)) * BROW + (lane >> 4) * 16;
  cp_async_wait<RING_STAGES - 1>();  // the query rows' group has landed ...
  __syncthreads();                   // ... for every warp

  for (int i = 0; i < nlive; ++i) {
    cp_async_wait<RING_STAGES - 2>();  // live chunk i has landed (later ones may be in flight) ...
    bar_sync(1 + slice, sl_threads);   // ... for the slice, and chunk i - 1's stage is free
    issue(i + RING_STAGES - 1);
    const int c = __ffs(static_cast<int>(order)) - 1;
    order &= order - 1;
    const int cb = k0 + c * RCK;       // the chunk's first key
    const unsigned char* st = sl_base + (i % RING_STAGES) * STAGE;
    const int* kp_s = reinterpret_cast<const int*>(st + 2 * RCK * KROW);
    const unsigned char* kc = st;      // the chunk's K and V rows as bf16, BROW bytes apart
    const unsigned char* vc = st + RCK * KROW;
    if constexpr (kInt8) {
      // the slice's threads widen its chunk's codes to bf16 (exact: |x| <= 127)
      for (int x = stid; x < RCK * (DH / 8); x += sl_threads) {
        const int j = x / (DH / 8), d = (x % (DH / 8)) * 8;
        widen8(kw_s + j * BROW + d * 2, kc + j * KROW + d);
        widen8(vw_s + j * BROW + d * 2, vc + j * KROW + d);
      }
      bar_sync(1 + slice, sl_threads);
      kc = kw_s;
      vc = vw_s;
    }

    // scores: q.k over dh in ascending k steps, for the chunk's two 8-key tiles
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KST; ++kk) {
      unsigned qf[4], bk[4];
      ldsm_x4(qf, q_lane + kk * 32);
      const int key = (lane & 7) + ((lane >> 4) << 3);
      ldsm_x4(bk, kc + key * BROW + (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
      mma_bf16(sc[0], qf, bk[0], bk[1]);
      mma_bf16(sc[1], qf, bk[2], bk[3]);
    }

    // online softmax on the accumulator fragments (as the body above),
    // visibility from the chunk's staged positions
    unsigned okbits = 0;
    float mx[2] = {MASK_VAL, MASK_VAL};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = e >> 1, j = 8 * n + 2 * c4 + (e & 1);
        float x = sc[n][e] * scale;
        if constexpr (kInt8) x = x * __int_as_float(kp_s[RCK + j]);
        bool ok;
        if constexpr (RING) {
          const int d = qp[i2] - kp_s[j];
          ok = live[i2] && cb + j < S && d >= 0 && d < window;
        } else {
          ok = cb + j < S;  // only the last chunk holds keys past S
        }
        okbits |= static_cast<unsigned>(ok) << (4 * n + e);
        sc[n][e] = ok ? x : MASK_VAL;
        mx[i2] = fmaxf(mx[i2], sc[n][e]);
      }
    float alpha[2], mnew[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
      mnew[i2] = fmaxf(m[i2], mx[i2]);
      alpha[i2] = fast_exp(m[i2] - mnew[i2]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = e >> 1;
        float p = (okbits >> (4 * n + e)) & 1u ? fast_exp(sc[n][e] - mnew[i2]) : 0.f;
        sum[i2] += p;
        if constexpr (kInt8) p = p * __int_as_float(kp_s[2 * RCK + 8 * n + 2 * c4 + (e & 1)]);
        sc[n][e] = p;
      }
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      sum[i2] += __shfl_xor_sync(0xffffffffu, sum[i2], 1);
      sum[i2] += __shfl_xor_sync(0xffffffffu, sum[i2], 2);
      l[i2] = l[i2] * alpha[i2] + sum[i2];
      m[i2] = mnew[i2];
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // x * 1 == x
#pragma unroll
      for (int n = 0; n < NDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }

    // p.V: P as two bf16 terms (hi, lo) into the same f32 accumulators,
    // the chunk's 16 keys as one k step
    unsigned ph[4], pl[4];
    split_pair(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_pair(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_pair(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_pair(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < NDT; n += 2) {
      unsigned bv[4];
      const int key = (lane & 7) + (((lane >> 3) & 1) << 3);
      ldsm_x4_t(bv, vc + key * BROW + (8 * n + ((lane >> 4) << 3)) * 2);
      mma_bf16(acc[n], ph, bv[0], bv[1]);
      mma_bf16(acc[n], pl, bv[0], bv[1]);
      mma_bf16(acc[n + 1], ph, bv[2], bv[3]);
      mma_bf16(acc[n + 1], pl, bv[2], bv[3]);
    }
  }
  cp_async_wait<0>();  // no copy outlives the sweep (none is pending past nlive)
  __syncthreads();     // every slice has left its stages: they become facc

  // this warp's (m, l, acc) of its tile, as slice `slice`'s rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tr0 + g + 8 * i;
    if (c4 == 0) {
      fm[slice * RS + r] = m[i];
      fl[slice * RS + r] = l[i];
    }
    float* o = facc + (slice * Rp + r) * FROW + 2 * c4;
#pragma unroll
    for (int n = 0; n < NDT; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) = make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
  __syncthreads();

  // fold the slices in slice order into the split's partials
  const int64_t base = (static_cast<int64_t>(bh) * nsplit + split) * Rtot + row0;
  for (int r = tid; r < R; r += nthr) {
    float mx = MASK_VAL;
#pragma unroll
    for (int s = 0; s < RING_SLICES; ++s) mx = fmaxf(mx, fm[s * RS + r]);
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < RING_SLICES; ++s) {
      const float w = expf(fm[s * RS + r] - mx);
      fw[s * RS + r] = w;
      sum += fl[s * RS + r] * w;
    }
    part_m[base + r] = mx;
    part_l[base + r] = sum;
  }
  __syncthreads();
  for (int x = tid; x < R * (DH / 4); x += nthr) {  // four dims per item
    const int r = x / (DH / 4), d = (x % (DH / 4)) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < RING_SLICES; ++s) {
      const float4 y = *reinterpret_cast<const float4*>(facc + (s * Rp + r) * FROW + d);
      const float w = fw[s * RS + r];
      o.x += y.x * w;
      o.y += y.y * w;
      o.z += y.z * w;
      o.w += y.w * w;
    }
    *reinterpret_cast<float4*>(part_acc + (base + r) * DH + d) = o;
  }

  // the last block of this (b, kv head, row block) merges the splits
  __threadfence();  // this block's partials are visible device-wide ...
  __syncthreads();
  int* counter = counters + static_cast<int64_t>(bh) * gridDim.z + blockIdx.z;
  if (tid == 0) is_last = atomicAdd(counter, 1) == nsplit - 1;  // ... before it is counted
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // each split's maximum and sum for the block's rows (read through L2,
  // where the other blocks wrote them), then each row's maximum M, the
  // splits' weights exp(m_j - M) and the denominator, in split order
  float* mw = reinterpret_cast<float*>(slots);        // [nsplit][RS]: m_j, then weights
  float* lw = mw + nsplit * RS;                       // [nsplit][RS]: l_j
  float* den = lw + nsplit * RS;                      // [RS]: max(l, 1e-30)
  const int64_t rows0 = static_cast<int64_t>(bh) * nsplit * Rtot + row0;  // split 0, row 0
  for (int x = tid; x < nsplit * R; x += nthr) {
    const int j = x / R, r = x % R;
    mw[j * RS + r] = __ldcg(part_m + rows0 + static_cast<int64_t>(j) * Rtot + r);
    lw[j * RS + r] = __ldcg(part_l + rows0 + static_cast<int64_t>(j) * Rtot + r);
  }
  __syncthreads();
  for (int r = tid; r < R; r += nthr) {
    float mx = MASK_VAL;
    for (int j = 0; j < nsplit; ++j) mx = fmaxf(mx, mw[j * RS + r]);
    float sum = 0.f;
    for (int j = 0; j < nsplit; ++j) {
      const float w = expf(mw[j * RS + r] - mx);
      mw[j * RS + r] = w;
      sum += lw[j * RS + r] * w;
    }
    den[r] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  // four output dims per item: the splits' partial accumulators in split order
  auto emit = [&](int x, const float4& o) {
    const int r = x / (DH / 4), d = (x % (DH / 4)) * 4, qr = row0 + r;
    const float denom = den[r];
    __nv_bfloat16* dst =
        out + ((static_cast<int64_t>(b) * T + qr % T) * Hq + h * G + qr / T) * DH + d;
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o.x / denom, o.y / denom);
    *reinterpret_cast<__nv_bfloat162*>(dst + 2) =
        __floats2bfloat162_rn(o.z / denom, o.w / denom);
  };
  if constexpr (RING) {
    // a ring's 16 splits: an item's loads in flight together
    for (int x = tid; x < R * (DH / 4); x += nthr) {
      const int r = x / (DH / 4);
      const float4* a =
          reinterpret_cast<const float4*>(part_acc + (rows0 + r) * DH + (x % (DH / 4)) * 4);
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
      for (int j = 0; j < nsplit; ++j) {
        const float4 y = __ldcg(a + static_cast<int64_t>(j) * Rtot * (DH / 4));
        const float w = mw[j * RS + r];
        o.x += y.x * w;
        o.y += y.y * w;
        o.z += y.z * w;
        o.w += y.w * w;
      }
      emit(x, o);
    }
  } else {
    // the cross read's four splits: a thread's ITEMS items (nthr * ITEMS >=
    // Rp * DH / 4), the loads of one split for all of them in flight together
    constexpr int ITEMS = (DH + 31) / 32;
    float4 o[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < nsplit; ++j) {
      float4 y[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int x = tid + i * nthr;
        if (x < R * (DH / 4))
          y[i] = __ldcg(reinterpret_cast<const float4*>(
                            part_acc + (rows0 + static_cast<int64_t>(j) * Rtot + x / (DH / 4)) * DH) +
                        x % (DH / 4));
      }
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int x = tid + i * nthr;
        if (x < R * (DH / 4)) {
          const float w = mw[j * RS + x / (DH / 4)];
          o[i].x += y[i].x * w;
          o[i].y += y[i].y * w;
          o[i].z += y[i].z * w;
          o[i].w += y[i].w * w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (tid + i * nthr < R * (DH / 4)) emit(tid + i * nthr, o[i]);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch (or graph replay)
}

// One warp per (b, kv head, query row), 8 rows per block: lane j reads
// split j's maximum and sum (all splits at once), the row's maximum M is
// their warp max, and the splits are then folded in split order — each
// split's weight exp(m_j - M) broadcast from its lane — into l and the
// lane's output dims lane, lane + 32, ... below DH (coalesced rows of the
// partial accumulators; at DH 80 lanes 0-15 take a third dim).  Only the
// live splits are read.
constexpr int kMergeRows = 8;

template <typename QT, int DH>
__global__ void __launch_bounds__(32 * kMergeRows)
flash_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, const int* __restrict__ qpos,
                   const int* __restrict__ win_start, const int* __restrict__ kpos,
                   QT* __restrict__ out, int T, int Hq, int Hkv, int S, int nsplit,
                   int split_len) {
  constexpr int DPL = (DH + 31) / 32;  // output dims per lane (the last may be partial)
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv, R = G * T, lane = threadIdx.x & 31;
  // dim lane + 32e exists: always when DH is a multiple of 32
  auto has = [&](int e) { return DH % 32 == 0 || 32 * e + lane < DH; };
  const int r = blockIdx.y * kMergeRows + (threadIdx.x >> 5);
  if (r >= R) return;
  const int g = r / T, t = r % T;
  const int64_t base = static_cast<int64_t>(bh) * nsplit * R + r;
  const int live = live_splits(live_end(qpos, win_start, kpos, b, T, S), nsplit, split_len);
  float m = MASK_VAL;
  for (int j = lane; j < live; j += 32) m = fmaxf(m, part_m[base + j * R]);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, x));
  float l = 0.f, o[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) o[e] = 0.f;
  for (int j0 = 0; j0 < live; j0 += 32) {
    const int j = j0 + lane, n = min(32, live - j0);
    const float w_j = j < live ? expf(part_m[base + j * R] - m) : 0.f;
    const float l_j = j < live ? part_l[base + j * R] : 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float w = __shfl_sync(0xffffffffu, w_j, i);
      l += __shfl_sync(0xffffffffu, l_j, i) * w;
      const float* a = part_acc + (base + static_cast<int64_t>(j0 + i) * R) * DH + lane;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        if (has(e)) o[e] += a[32 * e] * w;
    }
  }
  const float denom = fmaxf(l, 1e-30f);
  QT* dst = out + ((static_cast<int64_t>(b) * T + t) * Hq + h * G + g) * DH + lane;
#pragma unroll
  for (int e = 0; e < DPL; ++e)
    if (has(e)) store(dst + 32 * e, o[e] / denom);
}

// Everything a launch needs beyond the template arguments.
struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *qpos, *tree_bits, *win_start, *kpos;
  int window;
  void* out;
  float *part_m, *part_l, *part_acc;
  int* counters;
  int B, T, Hq, Hkv, S, tree_words, nsplit, split_len, rows_per_block, threads;
  size_t smem;
  float scale;
  cudaStream_t st;
};

// Raises the dynamic shared-memory limit of a kernel when the launch needs
// more than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The sliced body (flash_sliced_kernel): a ring (RING) or the cross read,
// which merges its splits itself.
template <typename KVT, int DH, bool RING>
int launch_sliced(const Args& a) {
  const int R = (a.Hq / a.Hkv) * a.T;
  if (a.split_len % RCK != 0 || a.split_len > RING_SLICES * 32 * RING_MAX_PAIRS ||
      a.threads != 32 * RING_SLICES * ((a.rows_per_block + 15) / 16) ||
      a.threads > sliced_threads<DH>(RING) || a.counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto split = flash_sliced_kernel<KVT, DH, RING>;
  cudaError_t e;
  // its static bytes count against the default 48 KB too: always raise it
  if ((e = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(a.smem))) != cudaSuccess)
    return static_cast<int>(e);
  // two blocks per SM need the whole 228 KB as shared memory
  if ((e = cudaFuncSetAttribute(split, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return static_cast<int>(e);
  const dim3 grid(a.B * a.Hkv, a.nsplit, (R + a.rows_per_block - 1) / a.rows_per_block);
  split<<<grid, a.threads, a.smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KVT*>(a.k),
      static_cast<const KVT*>(a.v), a.ks, a.vs, a.qpos, a.kpos, a.window, a.part_m, a.part_l,
      a.part_acc, a.counters, static_cast<__nv_bfloat16*>(a.out), a.T, a.Hq, a.Hkv, a.S,
      a.split_len, a.rows_per_block, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The split pass — the sliced body for a ring with bf16 queries, the
// tensor-core body for other bf16 queries, the f32 body for f32 queries —
// then the merge.
template <typename QT, typename KVT, int DH, typename Rows>
int launch(const Args& a, const Rows rows) {
  const int R = (a.Hq / a.Hkv) * a.T;
  const dim3 grid(a.B * a.Hkv, a.nsplit, (R + a.rows_per_block - 1) / a.rows_per_block);
  cudaError_t e;
  if constexpr (sizeof(QT) == 2) {
    if (a.kpos != nullptr)  // a ring (contiguous: the paged entry passes none)
      return launch_sliced<KVT, DH, true>(a);
    auto split = flash_split_mma_kernel<KVT, DH, Rows>;
    if ((e = allow_smem(split, a.smem)) != cudaSuccess) return static_cast<int>(e);
    split<<<grid, a.threads, a.smem, a.st>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const KVT*>(a.k),
        static_cast<const KVT*>(a.v), a.ks, a.vs, rows, a.qpos, a.tree_bits, a.win_start,
        a.tree_words, a.part_m, a.part_l, a.part_acc, a.T, a.Hq, a.Hkv, a.S,
        a.rows_per_block, a.scale);
  } else {
    auto split = flash_split_f32_kernel<KVT, DH, Rows>;  // strides by kMaxThreads
    if ((e = allow_smem(split, a.smem)) != cudaSuccess) return static_cast<int>(e);
    split<<<grid, kMaxThreads, a.smem, a.st>>>(
        static_cast<const float*>(a.q), static_cast<const KVT*>(a.k),
        static_cast<const KVT*>(a.v), a.ks, a.vs, rows, a.qpos, a.tree_bits, a.win_start,
        a.tree_words, a.kpos, a.window, a.part_m, a.part_l, a.part_acc, a.T, a.Hq, a.Hkv,
        a.S, a.rows_per_block, a.scale);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  flash_merge_kernel<QT, DH>
      <<<dim3(a.B * a.Hkv, (R + kMergeRows - 1) / kMergeRows), 32 * kMergeRows, 0, a.st>>>(
          a.part_m, a.part_l, a.part_acc, a.qpos,
          a.tree_bits != nullptr ? a.win_start : nullptr, a.kpos, static_cast<QT*>(a.out),
          a.T, a.Hq, a.Hkv, a.S, a.nsplit, a.split_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KVT, typename Rows>
int launch_dh(int dh, const Args& a, const Rows rows) {
  switch (dh) {
    case 32:
      return launch<QT, KVT, 32>(a, rows);
    case 64:
      return launch<QT, KVT, 64>(a, rows);
    case 80:  // zamba2's shared attention (2560 / 32 heads)
      return launch<QT, KVT, 80>(a, rows);
    case 128:
      return launch<QT, KVT, 128>(a, rows);
    case 160:  // stablelm-12b (5120 / 32 heads)
      return launch<QT, KVT, 160>(a, rows);
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
// win_start: (B,) int32; a chain passes null for both.  A ring passes kpos:
// (B, S) int32 slot positions and window > 0 (no tree); else null and 0.
// counters: a ring with bf16 queries, (B*Hkv*row blocks) int32 zeros, left
// zero (the ring body merges its splits itself); else null.  part_m, part_l:
// (B*Hkv*nsplit*R) f32 and part_acc: (B*Hkv*nsplit*R*dh) f32 scratch,
// R = (Hq/Hkv)*T, nsplit = ceil(S / split_len).  split_len, rows_per_block,
// threads, smem: the launch plan of kernels/flash_decode.py:launch_plan
// (keys per split — 128, or the ring body's from S alone —, query rows per
// block — R or a multiple of 16 —, threads per block and dynamic shared
// bytes of the split pass).  All contiguous.  Returns a cudaError_t.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const float* ks, const float* vs,
                                   const int* qpos, const int* tree_bits,
                                   const int* win_start, int tree_words, const int* kpos,
                                   int window, void* out,
                                   float* part_m, float* part_l, float* part_acc,
                                   int* counters, int B, int T, int Hq, int Hkv, int S, int dh,
                                   int q_is_bf16, int kv_int8, int nsplit, int split_len,
                                   int rows_per_block, int threads, long long smem,
                                   float scale, void* stream) {
  if (B == 0 || T == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k, v, ks, vs, qpos, tree_bits, win_start, kpos, window, out, part_m,
               part_l, part_acc, counters, B, T, Hq, Hkv, S, tree_words, nsplit, split_len,
               rows_per_block,
               threads, static_cast<size_t>(smem), scale, static_cast<cudaStream_t>(stream)};
  return launch_types(q_is_bf16, kv_int8, dh, a, ContigRows{S});
}

// The cross-attention read: q (B, T, Hq, dh) over every one of the S keys of
// k, v (B, S, Hkv, dh) of q's type (bf16 if q_is_bf16 != 0, else f32),
// 16-byte aligned; out (B, T, Hq, dh) of q's type.  bf16 takes the sliced
// body (no positions), which merges its splits itself through counters:
// (B*Hkv*row blocks) int32 zeros, left zero.  f32 takes the f32 body and
// the merge with no positions (counters unused).  part_m, part_l, part_acc,
// nsplit, split_len, rows_per_block, threads and smem as for
// flash_decode_launch, from kernels/flash_decode.py:cross_plan (bf16) or
// launch_plan (f32).  Returns a cudaError_t.
extern "C" int flash_decode_cross_launch(const void* q, const void* k, const void* v,
                                         void* out, float* part_m, float* part_l,
                                         float* part_acc, int* counters, int B, int T, int Hq,
                                         int Hkv, int S, int dh, int q_is_bf16, int nsplit,
                                         int split_len, int rows_per_block, int threads,
                                         long long smem, float scale, void* stream) {
  if (B == 0 || T == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, out, part_m,
               part_l, part_acc, counters, B, T, Hq, Hkv, S, 0, nsplit, split_len,
               rows_per_block, threads, static_cast<size_t>(smem), scale,
               static_cast<cudaStream_t>(stream)};
  if (!q_is_bf16) return launch_dh<float, float>(dh, a, ContigRows{S});
  switch (dh) {
    case 32:
      return launch_sliced<__nv_bfloat16, 32, false>(a);
    case 64:
      return launch_sliced<__nv_bfloat16, 64, false>(a);
    case 80:
      return launch_sliced<__nv_bfloat16, 80, false>(a);
    case 128:
      return launch_sliced<__nv_bfloat16, 128, false>(a);
    case 160:
      return launch_sliced<__nv_bfloat16, 160, false>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As flash_decode_launch, over paged pools: k, v: (N, bs, Hkv, dh) and ks,
// vs: (N, bs, Hkv) f32 (int8 KV) addressed through bt: (B, nb) int32
// physical block ids in [0, N); the logical cache length is S = nb * bs,
// and nsplit = ceil(S / 128).  Returns a cudaError_t.
extern "C" int flash_decode_paged_launch(const void* q, const void* k, const void* v,
                                         const float* ks, const float* vs, const int* bt,
                                         int nb, int bs, const int* qpos,
                                         const int* tree_bits, const int* win_start,
                                         int tree_words, void* out, float* part_m,
                                         float* part_l, float* part_acc, int B, int T,
                                         int Hq, int Hkv, int dh, int q_is_bf16,
                                         int kv_int8, int nsplit, int rows_per_block,
                                         int threads, long long smem, float scale,
                                         void* stream) {
  const int S = nb * bs;
  if (B == 0 || T == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k, v, ks, vs, qpos, tree_bits, win_start, nullptr, 0, out, part_m,
               part_l, part_acc, nullptr, B, T, Hq, Hkv, S, tree_words, nsplit, SPLIT,
               rows_per_block,
               threads, static_cast<size_t>(smem), scale, static_cast<cudaStream_t>(stream)};
  return launch_types(q_is_bf16, kv_int8, dh, a, PagedRows{bt, nb, bs});
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
