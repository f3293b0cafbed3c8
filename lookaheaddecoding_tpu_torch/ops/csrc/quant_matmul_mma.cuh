// The quantized products on the tensor cores, for bfloat16 x: the template
// of quant_matmul.cu's int8, int4 and pipelined int4 kernels in bfloat16
// and of int4_micro.cu's shift variant in bfloat16. See quant_matmul.cu for
// what they compute, what bounds them and why the design is as it is.
//
// mma.sync.m16n8k16 (bf16 x bf16 -> f32) fragments, PTX ISA "Matrix
// Fragments for mma.m16n8k16 with floating point type"; lane = 4 g + q:
//   A [16 x 16] row-major: a0 (row g, k 2q..2q+1), a1 (row g + 8, same k),
//                          a2 (row g, k 2q+8..2q+9), a3 (row g + 8, same k)
//   B [16 x 8]  col-major: b0 (k 2q..2q+1, col g), b1 (k 2q+8..2q+9, col g)
//   C [16 x 8]           : c0, c1 (row g, cols 2q, 2q+1), c2, c3 (row g + 8)
// The lower k of a pair is in the lower 16 bits of its register.
//
// A weight "row" below is one stored row of the weight: a packed int4 row
// (two planes: input rows r and r + K/2) or an int8 row (one plane). NP is
// the number of planes, and of the halves of x they meet.

#pragma once

#include <cooperative_groups.h>

#include "mma_sync.cuh"
#include "quant_matmul.cuh"

namespace {

// How a packed byte becomes two bf16 values. MAGIC: (nibble ^ 8) | 0x4300
// read as bf16 is 128 + (nibble ^ 8) = 136 + nibble, and 136 (bf16 0x4308)
// is subtracted exactly; SHIFT: int4_micro.cu's decode, each nibble moved
// to the top of the 32-bit word and shifted back arithmetically, then
// converted. Both give the same exact values, so the same bits downstream.
// INT8: one signed byte a value (int8_pair), one plane.
constexpr int DEC_MAGIC = 0, DEC_SHIFT = 1, DEC_INT8 = 2;

template <int DEC>
constexpr int planes_of() { return DEC == DEC_INT8 ? 1 : 2; }

// K is cut into chunks of CHUNK weight rows (MmaGeo::CHUNK: 32 packed
// int4 rows, or 64 int8 rows, the same number of products); the KS blocks
// of a cluster split the chunks (block rank r takes chunks r, r + KS, ...),
// KS fixed by the weight's shape alone (ks_for).

// Tile geometry. BM x BN outputs a block, WARPS_M x WARPS_N warps, each
// owning (BM / WARPS_M) x (BN / WARPS_N) outputs as MT m16 tiles by NT8 n8
// tiles. A ring stage holds BK2 weight rows ([BK2][WS] bytes) and the x
// tiles of the NP halves ([NP BM][BK2] bf16, see x_at). BK2 and STAGES set
// only how the copies are cut: the order of the sum is fixed by the
// weight's shape alone.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int BK2_, int STAGES_, int NP_ = 2>
struct MmaGeo {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int BK2 = BK2_, STAGES = STAGES_, NP = NP_;
  static constexpr int CHUNK = NP == 1 ? 64 : 32;
  static constexpr int NTH = 32 * WARPS_M * WARPS_N;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  static constexpr int MT = WTM / 16, NT8 = WTN / 8;
  // byte row stride of a packed stage: the four rows a B-fragment load
  // reads (2q, q = 0..3) fall on four different groups of 8 banks
  static constexpr int WS = ((BN + 16) / 4) % 16 == 4 || ((BN + 16) / 4) % 16 == 12
                                ? BN + 16 : BN + 32;
  static constexpr int PS = BN + 8;    // decoded bf16 plane row stride (elements)
  static constexpr int W_BYTES = BK2 * WS;
  static constexpr int STAGE_BYTES = W_BYTES + NP * BM * BK2 * 2;
  static constexpr int PLANE_ELEMS = BK2 * PS;
  static constexpr int RED_BYTES = BM * BN * 4;  // a block's partial sums, for the cluster
  // Output groups: accumulator (mi, j, e) of lane (g, q) is row
  // mi * 16 + g + 8 (e >> 1) and column NT8 (2q + (e & 1)) + j of the warp's
  // tile (both kernels), so for one (mi, e >> 1) a lane holds the RUN
  // consecutive columns from 2q NT8: group gi = 2 mi + (e >> 1), element
  // v = (e & 1) NT8 + j, written as one vector.
  static constexpr int RUN = 2 * NT8, GROUPS = 2 * MT;
  static_assert(BM % (16 * WARPS_M) == 0 && BN % (8 * WARPS_N) == 0, "warp tiles");
  static_assert(NT8 == 2 || NT8 == 4 || NT8 == 8, "a B-fragment load reads 2, 4 or 8 bytes");
  static_assert(BN % 16 == 0 && BK2 % 16 == 0 && BK2 <= 64, "16-byte pieces, k16 steps");
  static_assert(W_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "16-byte aligned tiles");
  static_assert(STAGES >= 3, "a ring of at least three stages");
  static_assert(CHUNK % BK2 == 0, "a ring stage holds part of one chunk");
  static_assert(NP == 1 || NP == 2, "one plane (int8) or two (int4)");
};

// Element kk of row R of a stage's x tiles (R = half * BM + row). The rows
// are not padded: 16-byte chunk c of row R is stored as chunk c ^ (R / RPL
// % CPR), so the eight rows of an ldmatrix matrix (one 128-byte line holds
// RPL rows) fall on eight different groups of four banks.
template <typename G>
__device__ __forceinline__ int x_at(int R, int kk) {
  constexpr int CPR = G::BK2 / 8, RPL = 8 / CPR;
  return R * G::BK2 + (((kk >> 3) ^ (R / RPL % CPR)) << 3) + (kk & 7);
}

// d holds two packed bytes, in its bytes 0 and 2: their low nibbles as a
// bf16 pair (lower half from byte 0) in lo, their high nibbles in hi.
__device__ __forceinline__ void magic_pair(uint32_t d, uint32_t& lo, uint32_t& hi) {
  constexpr uint32_t MAGIC = 0x43084308u;      // bf16 136 twice; ^8 on the nibble
  constexpr uint32_t ONE = 0x3F803F80u;        // bf16 1.0 twice
  constexpr uint32_t MINUS_136 = 0xC308C308u;  // bf16 -136 twice
  const uint32_t l = (d & 0x000F000Fu) ^ MAGIC;
  const uint32_t h = ((d >> 4) & 0x000F000Fu) ^ MAGIC;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(lo) : "r"(l), "r"(ONE), "r"(MINUS_136));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(hi) : "r"(h), "r"(ONE), "r"(MINUS_136));
}

// Byte j of wa and byte j of wb (the packed rows k and k + 1 of one
// column) -> the lo-plane and hi-plane B registers for that k pair.
template <int DEC>
__device__ __forceinline__ void decode_pair(uint32_t wa, uint32_t wb, int j, uint32_t& lo,
                                            uint32_t& hi) {
  if constexpr (DEC == DEC_MAGIC) {
    magic_pair(__byte_perm(wa, wb, j | ((j + 4) << 8)), lo, hi);
  } else {
    const int s_lo = 28 - 8 * j, s_hi = 24 - 8 * j;
    lo = pack_bf16x2((float)((int)(wa << s_lo) >> 28), (float)((int)(wb << s_lo) >> 28));
    hi = pack_bf16x2((float)((int)(wa << s_hi) >> 28), (float)((int)(wb << s_hi) >> 28));
  }
}

// Copies of K tiles into ring stages: the weight rows [tile * BK2, +BK2)
// of the block's columns, and the same columns of the NP halves of x, by
// cp.async in 16-byte pieces. Piece i of a thread is c = tid + i * NTH of
// the tile, in the same place of every tile, so its source offset is
// worked out once (an offset of -1: no piece). Rows past k_lim (K/2 or K)
// and columns past N read as zero; a piece that straddles k_lim takes its
// valid elements only. x rows past T are never written: row m of an mma's result depends
// on row m of A alone, so they reach only output rows past T, which are
// not stored. x_vec is false when x's rows or halves are not 16-byte
// aligned (k_lim not a multiple of 8): x is then copied element by element,
// zero-filled too.
template <typename G>
struct Filler {
  static constexpr int WPR = G::BN / 16, WP = G::BK2 * WPR, WI = (WP + G::NTH - 1) / G::NTH;
  static constexpr int XPR = G::BK2 / 8, XP = G::NP * G::BM * XPR, XI = (XP + G::NTH - 1) / G::NTH;
  static_assert(G::NTH % WPR == 0 && G::NTH % XPR == 0, "a thread's pieces share a column");
  int woff[WI];  // weight offset of the piece's first byte in tile 0
  int xoff[XI];  // x offset of the piece's first element in tile 0
  int wcol, xkk;  // the thread's column in a weight row, in an x row

  __device__ Filler(int t0, int n0, const Problem& p) {
    const int tid = threadIdx.x, live = min(G::BM, p.t - t0);
    wcol = (tid % WPR) * 16;
    xkk = (tid % XPR) * 8;
#pragma unroll
    for (int i = 0; i < WI; ++i) {
      const int c = tid + i * G::NTH, r = c / WPR;
      woff[i] = c < WP && n0 + wcol < p.n ? r * p.n + n0 + wcol : -1;
    }
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      const int c = tid + i * G::NTH;
      const int half = c / (G::BM * XPR), r = (c / XPR) % G::BM;
      xoff[i] = c < XP && r < live ? (t0 + r) * p.k + half * p.k_lim + xkk : -1;
    }
  }

  __device__ __forceinline__ void operator()(unsigned char* st, const __nv_bfloat16* x,
                                             const signed char* w, int tile, const Problem& p,
                                             bool x_vec) const {
    const int tid = threadIdx.x, row0 = tile * G::BK2;
    const signed char* wt = w + (size_t)row0 * p.n;
#pragma unroll
    for (int i = 0; i < WI; ++i) {
      const int c = tid + i * G::NTH, r = c / WPR;
      if (WP % G::NTH != 0 && c >= WP) break;
      const bool ok = woff[i] >= 0 && row0 + r < p.k_lim;
      cp_async16_zfill(st + r * G::WS + wcol, ok ? wt + woff[i] : w, ok ? 16 : 0);
    }
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(st + G::W_BYTES);
    const int valid = min(8, p.k_lim - (row0 + xkk));  // elements of the piece inside its half
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      if (xoff[i] < 0) continue;
      const int c = tid + i * G::NTH;
      const int half = c / (G::BM * XPR), r = (c / XPR) % G::BM;
      __nv_bfloat16* dst = sx + x_at<G>(half * G::BM + r, xkk);
      const __nv_bfloat16* src = x + xoff[i] + row0;
      if (x_vec) {
        cp_async16_zfill(dst, valid > 0 ? src : x, valid > 0 ? 2 * valid : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = e < valid ? src[e] : __float2bfloat16(0.f);
      }
    }
  }
};

// The A fragments of m16 tile mi of this warp, k16 step s, from x half h.
template <typename G>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* sx, int h, int wm,
                                       int mi, int s, int lane) {
  ldmatrix_x4(a, sx + x_at<G>(h * G::BM + wm * G::WTM + mi * 16 + (lane & 15),
                              s * 16 + (lane >> 4) * 8));
}

// One K tile of the chain, B decoded in registers from the weight bytes
// (B4, and B3 with DEC_INT8). n8 tile j, fragment column g of a warp is
// column NT8 * g + j of the warp's slice, so one load of NT8 bytes (2, 4
// or 8) gives a row's bytes for all NT8 tiles. Every accumulator takes, per
// k16 step in ascending k, the lo-plane product and then the hi-plane
// product (int4), or the one product of its int8 rows.
template <typename G, int DEC>
__device__ __forceinline__ void mma_tile_regs(float (&acc)[G::MT][G::NT8][4],
                                              const unsigned char* st, int steps, int wm, int wn,
                                              int lane) {
  const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(st + G::W_BYTES);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int s = 0; s < G::BK2 / 16; ++s) {
    if (s >= steps) break;
    const unsigned char* wb = st + (s * 16 + 2 * q) * G::WS + wn * G::WTN + G::NT8 * g;
    constexpr int WPR = G::NT8 == 8 ? 2 : 1;  // 32-bit words a row's bytes
    uint32_t w[4][WPR];  // weight rows 2q, 2q+1, 2q+8, 2q+9
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned char* pw = wb + ((i & 1) + 8 * (i >> 1)) * G::WS;
      if constexpr (G::NT8 == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(pw);
        w[i][0] = v.x;
        w[i][WPR - 1] = v.y;
      } else if constexpr (G::NT8 == 4) {
        w[i][0] = *reinterpret_cast<const uint32_t*>(pw);
      } else {
        w[i][0] = *reinterpret_cast<const uint16_t*>(pw);
      }
    }
    if constexpr (DEC == DEC_INT8) {
      uint32_t b[G::NT8][2];  // rows 2q, 2q+1 (b0) and 2q+8, 2q+9 (b1) of column NT8 g + j
#pragma unroll
      for (int j = 0; j < G::NT8; ++j) {
        const int sel = (j % 4) | ((j % 4 + 4) << 8);
        b[j][0] = int8_pair(__byte_perm(w[0][j / 4], w[1][j / 4], sel));
        b[j][1] = int8_pair(__byte_perm(w[2][j / 4], w[3][j / 4], sel));
      }
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi) {
        uint32_t a[4];
        load_a<G>(a, sx, 0, wm, mi, s, lane);
#pragma unroll
        for (int j = 0; j < G::NT8; ++j) mma_bf16(acc[mi][j], a, b[j][0], b[j][1]);
      }
    } else {
      uint32_t blo[G::NT8][2], bhi[G::NT8][2];
#pragma unroll
      for (int j = 0; j < G::NT8; ++j) {
        decode_pair<DEC>(w[0][j / 4], w[1][j / 4], j % 4, blo[j][0], bhi[j][0]);
        decode_pair<DEC>(w[2][j / 4], w[3][j / 4], j % 4, blo[j][1], bhi[j][1]);
      }
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi) {
        uint32_t alo[4], ahi[4];
        load_a<G>(alo, sx, 0, wm, mi, s, lane);
        load_a<G>(ahi, sx, 1, wm, mi, s, lane);
#pragma unroll
        for (int j = 0; j < G::NT8; ++j) {
          mma_bf16(acc[mi][j], alo, blo[j][0], blo[j][1]);
          mma_bf16(acc[mi][j], ahi, bhi[j][0], bhi[j][1]);
        }
      }
    }
  }
}

// The packed bytes of a ring stage -> the lo and hi bf16 planes
// ([BK2][PS] each) of one decode buffer (B5), in mma_tile_regs' column
// order: within a warp's slice, weight column NT8 g + j goes to plane
// column 8j + g, so n8 tile j of the plane (columns 8j..8j+7) is B4's n8
// tile j. A unit is one packed row of one warp's slice (WTN bytes); unit u
// is row u % BK2 of slice u / BK2, so the lanes of a warp take 32
// consecutive rows of one slice and their 16-byte loads and stores fall
// on distinct bank groups (the row strides are an odd number of 16-byte
// chunks).
template <typename G>
__device__ __forceinline__ void decode_tile(__nv_bfloat16* planes, const unsigned char* st) {
  constexpr int UNITS = G::BK2 * G::WARPS_N, WORDS = G::WTN / 4;
  static_assert((G::WS / 16) % 2 == 1 && (G::PS / 8) % 2 == 1, "odd chunk strides");
#pragma unroll
  for (int i = 0; i < (UNITS + G::NTH - 1) / G::NTH; ++i) {
    const int u = threadIdx.x + i * G::NTH;
    if (UNITS % G::NTH != 0 && u >= UNITS) break;
    const int r = u % G::BK2, col = u / G::BK2 * G::WTN;
    uint32_t words[WORDS];
#pragma unroll
    for (int c = 0; c < WORDS / 4; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(st + r * G::WS + col + 16 * c);
      words[4 * c] = v.x, words[4 * c + 1] = v.y, words[4 * c + 2] = v.z, words[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < G::NT8; ++j) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {  // the slice's bytes b0 (g = 2m) and b1 (g = 2m + 1)
        const int b0 = j + 2 * m * G::NT8, b1 = b0 + G::NT8;
        magic_pair(__byte_perm(words[b0 / 4], words[b1 / 4], (b0 % 4) | ((4 + b1 % 4) << 8)),
                   lo[m], hi[m]);
      }
      const int at = r * G::PS + col + 8 * j;
      *reinterpret_cast<uint4*>(planes + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(planes + G::PLANE_ELEMS + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
}

// One K tile of the chain with B from a decoded buffer by ldmatrix.trans
// (B5): n8 tile j is plane columns 8j..8j+7 of the warp's slice, which
// decode_tile filled with B4's n8 tile j. So every mma gets the operands
// it gets in mma_tile_regs, in the same order.
template <typename G>
__device__ __forceinline__ void mma_tile_smem(float (&acc)[G::MT][G::NT8][4],
                                              const unsigned char* st,
                                              const __nv_bfloat16* planes, int steps, int wm,
                                              int wn, int lane) {
  const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(st + G::W_BYTES);
#pragma unroll
  for (int s = 0; s < G::BK2 / 16; ++s) {
    if (s >= steps) break;
    uint32_t blo[G::NT8][2], bhi[G::NT8][2];
#pragma unroll
    for (int jp = 0; jp < G::NT8 / 2; ++jp) {
      const int off = (s * 16 + (lane & 15)) * G::PS + wn * G::WTN + 16 * jp + (lane >> 4) * 8;
      uint32_t r[4];
      ldmatrix_x4_trans(r, planes + off);
      blo[2 * jp][0] = r[0], blo[2 * jp][1] = r[1], blo[2 * jp + 1][0] = r[2],
      blo[2 * jp + 1][1] = r[3];
      ldmatrix_x4_trans(r, planes + G::PLANE_ELEMS + off);
      bhi[2 * jp][0] = r[0], bhi[2 * jp][1] = r[1], bhi[2 * jp + 1][0] = r[2],
      bhi[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < G::MT; ++mi) {
      uint32_t alo[4], ahi[4];
      load_a<G>(alo, sx, 0, wm, mi, s, lane);
      load_a<G>(ahi, sx, 1, wm, mi, s, lane);
#pragma unroll
      for (int j = 0; j < G::NT8; ++j) {
        mma_bf16(acc[mi][j], alo, blo[j][0], blo[j][1]);
        mma_bf16(acc[mi][j], ahi, bhi[j][0], bhi[j][1]);
      }
    }
  }
}

// Group gi of a thread's accumulators, element v (see MmaGeo).
template <typename G>
__device__ __forceinline__ float& group_at(float (&acc)[G::MT][G::NT8][4], int gi, int v) {
  return acc[gi >> 1][v % G::NT8][(gi & 1) * 2 + v / G::NT8];
}

// y = bf16(v * scale[n]), rounded once, for group gi's RUN columns: one
// vector store of 2 RUN bytes (aligned: N, the tile's and the warp's first
// columns and 2q NT8 are multiples of RUN).
template <typename G>
__device__ __forceinline__ void store_group(__nv_bfloat16* out, const float* scale,
                                            const float (&v)[G::RUN], int gi, int t0, int n0,
                                            int wm, int wn, int lane, const Problem& p) {
  const int g = lane >> 2, q = lane & 3;
  const int gt = t0 + wm * G::WTM + (gi >> 1) * 16 + g + 8 * (gi & 1);
  const int gn = n0 + wn * G::WTN + 2 * q * G::NT8;
  if (gt >= p.t || gn >= p.n) return;  // N is a multiple of 16: a run is all in or all out
  uint32_t packed[G::RUN / 2];
#pragma unroll
  for (int i = 0; i < G::RUN / 2; ++i)
    packed[i] = pack_bf16x2(v[2 * i] * scale[gn + 2 * i], v[2 * i + 1] * scale[gn + 2 * i + 1]);
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)gt * p.n + gn);
  if constexpr (G::RUN == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
  } else {
#pragma unroll
    for (int i = 0; i < G::RUN / 8; ++i)
      dst[i] = make_uint4(packed[4 * i], packed[4 * i + 1], packed[4 * i + 2], packed[4 * i + 3]);
  }
}

// The end of a block: with KS = 1 it writes its tile. Otherwise each block
// of the cluster leaves its partial sums in its shared memory (the ring,
// free once every copy has landed), and block `rank` adds, for the groups
// gi with gi % KS == rank, the partials of ranks 0, 1, ... in that order,
// reading the others' shared memory across the cluster, and writes them.
// Partials lie in float4 chunks, chunk c of group gi of every thread
// together, so the copies in and out are 16 bytes a thread.
template <typename G, int KS>
__device__ __forceinline__ void finish(float (&acc)[G::MT][G::NT8][4], unsigned char* smem,
                                       __nv_bfloat16* out, const float* scale, int t0, int n0,
                                       int wm, int wn, int lane, const Problem& p) {
  constexpr int CH = G::RUN / 4;  // float4 chunks a group
  if constexpr (KS == 1) {
#pragma unroll
    for (int gi = 0; gi < G::GROUPS; ++gi) {
      float v[G::RUN];
#pragma unroll
      for (int e = 0; e < G::RUN; ++e) v[e] = group_at<G>(acc, gi, e);
      store_group<G>(out, scale, v, gi, t0, n0, wm, wn, lane, p);
    }
  } else {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float4* red = reinterpret_cast<float4*>(smem);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < G::GROUPS; ++gi)
#pragma unroll
      for (int c = 0; c < CH; ++c)
        red[(gi * CH + c) * G::NTH + threadIdx.x] =
            make_float4(group_at<G>(acc, gi, 4 * c), group_at<G>(acc, gi, 4 * c + 1),
                        group_at<G>(acc, gi, 4 * c + 2), group_at<G>(acc, gi, 4 * c + 3));
    cluster.sync();
    const int rank = (int)cluster.block_rank();
#pragma unroll
    for (int gi = 0; gi < G::GROUPS; ++gi) {
      if (gi % KS != rank) continue;
      float v[G::RUN];
#pragma unroll
      for (int r = 0; r < KS; ++r) {
        const float4* part = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float4 f = part[(gi * CH + c) * G::NTH + threadIdx.x];
          if (r == 0) {
            v[4 * c] = f.x, v[4 * c + 1] = f.y, v[4 * c + 2] = f.z, v[4 * c + 3] = f.w;
          } else {
            v[4 * c] += f.x, v[4 * c + 1] += f.y, v[4 * c + 2] += f.z, v[4 * c + 3] += f.w;
          }
        }
      }
      store_group<G>(out, scale, v, gi, t0, n0, wm, wn, lane, p);
    }
    cluster.sync();  // no block leaves while another still reads its partials
  }
}

// What a block walks: its chunks of K (rank r of KS: chunks r, r + KS, ...)
// as ring tiles of BK2 rows. tile_of gives the K tile (in units of BK2
// rows) of the block's local tile lt.
template <typename G, int KS>
struct Walk {
  static constexpr int TPC = G::CHUNK / G::BK2;  // tiles a chunk
  int rank, n_local;
  __device__ Walk(const Problem& p) {
    rank = KS > 1 ? (int)blockIdx.z : 0;
    const int n_chunks = (p.k_lim + G::CHUNK - 1) / G::CHUNK;
    n_local = (n_chunks > rank ? (n_chunks - rank + KS - 1) / KS : 0) * TPC;
  }
  __device__ int tile_of(int lt) const { return (rank + (lt / TPC) * KS) * TPC + lt % TPC; }
};

// B4 (and B3 with DEC_INT8) on the tensor cores. Grid (column tiles, row
// tiles, KS). Interval lt: wait for its stage, one barrier, start the copy
// of local tile lt + STAGES - 1 into the stage freed by lt - 1, then decode
// and multiply from registers.
template <typename G, int DEC, int KS>
__global__ void __launch_bounds__(G::NTH)
quant_mma_kernel(const __nv_bfloat16* __restrict__ x, const signed char* __restrict__ w,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, Problem p,
                int x_vec) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / G::WARPS_N, wn = warp % G::WARPS_N;
  const int n0 = blockIdx.x * G::BN, t0 = blockIdx.y * G::BM;
  const int n_steps = (p.k_lim + 15) / 16;  // the chain's k16 steps: K alone sets them
  const Walk<G, KS> walk(p);
  const Filler<G> fill(t0, n0, p);
  constexpr int SPT = G::BK2 / 16;

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < walk.n_local) fill(smem_bytes + s * G::STAGE_BYTES, x, w, walk.tile_of(s), p, x_vec);
    cp_async_commit();
  }
  float acc[G::MT][G::NT8][4] = {};
  for (int lt = 0; lt < walk.n_local; ++lt) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // lt's stage has landed; lt - 1's stage is free
    const int nt = lt + G::STAGES - 1;
    if (nt < walk.n_local)
      fill(smem_bytes + (nt % G::STAGES) * G::STAGE_BYTES, x, w, walk.tile_of(nt), p, x_vec);
    cp_async_commit();
    mma_tile_regs<G, DEC>(acc, smem_bytes + (lt % G::STAGES) * G::STAGE_BYTES,
                          n_steps - walk.tile_of(lt) * SPT, wm, wn, lane);
  }
  finish<G, KS>(acc, smem_bytes, out, scale, t0, n0, wm, wn, lane, p);
}

// B5 on the tensor cores: the ring as in B4, plus two decode buffers of bf16
// lo and hi planes. Interval lt: one barrier, start the copy of
// lt + STAGES - 1, the mma of lt from one buffer, then decode lt + 1 into
// the other (last, so that its copy has the longest time to land).
template <typename G, int KS>
__global__ void __launch_bounds__(G::NTH)
int4_mma_pipe_kernel(const __nv_bfloat16* __restrict__ x, const signed char* __restrict__ w,
                     const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                     Problem p, int x_vec) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __nv_bfloat16* bufs =
      reinterpret_cast<__nv_bfloat16*>(smem_bytes + G::STAGES * G::STAGE_BYTES);  // [2][2][PLANE]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / G::WARPS_N, wn = warp % G::WARPS_N;
  const int n0 = blockIdx.x * G::BN, t0 = blockIdx.y * G::BM;
  const int n_steps = (p.k_lim + 15) / 16;
  const Walk<G, KS> walk(p);
  const Filler<G> fill(t0, n0, p);
  constexpr int SPT = G::BK2 / 16;

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < walk.n_local) fill(smem_bytes + s * G::STAGE_BYTES, x, w, walk.tile_of(s), p, x_vec);
    cp_async_commit();
  }
  cp_async_wait<G::STAGES - 2>();
  __syncthreads();
  if (walk.n_local > 0) decode_tile<G>(bufs, smem_bytes);
  float acc[G::MT][G::NT8][4] = {};
  for (int lt = 0; lt < walk.n_local; ++lt) {
    // after this barrier: lt + 1 has landed, buffer lt & 1 is decoded, the
    // mma of lt - 1 (on the other buffer and its stage) is done
    cp_async_wait<G::STAGES - 3>();
    __syncthreads();
    const int nt = lt + G::STAGES - 1;
    if (nt < walk.n_local)
      fill(smem_bytes + (nt % G::STAGES) * G::STAGE_BYTES, x, w, walk.tile_of(nt), p, x_vec);
    cp_async_commit();
    mma_tile_smem<G>(acc, smem_bytes + (lt % G::STAGES) * G::STAGE_BYTES,
                     bufs + (lt & 1) * 2 * G::PLANE_ELEMS, n_steps - walk.tile_of(lt) * SPT, wm,
                     wn, lane);
    if (lt + 1 < walk.n_local)
      decode_tile<G>(bufs + ((lt + 1) & 1) * 2 * G::PLANE_ELEMS,
                     smem_bytes + ((lt + 1) % G::STAGES) * G::STAGE_BYTES);
  }
  finish<G, KS>(acc, smem_bytes, out, scale, t0, n0, wm, wn, lane, p);
}

// Launch `kernel` on G's tiles of p's output with KS blocks along z, one
// cluster when KS > 1, after setting its dynamic shared memory (`smem`
// bytes) once; args follow the kernel's x, w, scale, out and p.
template <typename G, int KS, typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kernel, int smem, bool* configured, const void* x, const void* w,
                         const void* scale, void* out, const Problem& p, cudaStream_t stream,
                         Args... args) {
  cudaError_t e = configure(kernel, smem, configured);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.n + G::BN - 1) / G::BN, (p.t + G::BM - 1) / G::BM, KS);
  cfg.blockDim = dim3(G::NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = KS;
  cfg.attrs = cluster;
  cfg.numAttrs = KS > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                         static_cast<const signed char*>(w), static_cast<const float*>(scale),
                         static_cast<__nv_bfloat16*>(out), p, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename G, bool PIPE, int DEC, int KS>
cudaError_t launch_mma_tile(const void* x, const void* w, const void* scale, void* out,
                            const Problem& p, bool x_vec, cudaStream_t stream) {
  constexpr int ring = G::STAGES * G::STAGE_BYTES + (PIPE ? 4 * G::PLANE_ELEMS * 2 : 0);
  constexpr int smem = ring > G::RED_BYTES ? ring : G::RED_BYTES;
  static bool configured = false;
  auto kernel = [] {
    if constexpr (PIPE) return int4_mma_pipe_kernel<G, KS>;
    else return quant_mma_kernel<G, DEC, KS>;
  }();
  return launch_tiles<G, KS>(kernel, smem, &configured, x, w, scale, out, p, stream, (int)x_vec);
}

// Blocks a cluster for a weight of k_lim rows of np planes and N columns:
// the split of K, so fixed by the weight's shape alone, never by T. A long
// K (k_lim * np >= 4096 input rows) is split 4 ways: the one-row call of a
// 5632-wide down projection (N = 2048) has too few columns to fill the
// card alone, and the split reads no more of x than one block would (a
// split in 8 filled the card better at T = 1 but made the composite call
// slower). So is a narrow weight (N <= SPLIT_N) of 1024 input rows or more:
// the 256-wide int8 wk and wv of a 2048-wide model give a handful of
// blocks at any T, each walking all of K (3x faster split, tile sweep).
// Other weights are not split: a 2048-wide projection's one-row call has
// columns enough, and its composite call runs in one wave without the
// cluster's reduction (a split in 2 took longer there).
#ifndef QM_MMA_SPLIT_N
#define QM_MMA_SPLIT_N 512
#endif
inline int ks_for(int k_lim, int np, int n) {
  return k_lim * np >= 4096 || (n <= QM_MMA_SPLIT_N && k_lim * np >= 1024) ? 4 : 1;
}

// Tile shapes, chosen by T and N (they never change the order of a sum).
// The 16-row tiles: 16 rows by 128, 64, 32 or 16 columns (a warp per 32
// columns), the widest that leaves at most an eighth of the SMs without a
// block; they take T <= 16, and larger T where even the [64, 64] tiles
// leave half the SMs without one. Otherwise the BIG tiles ([BM, 128], 4
// warps of BM x 32 outputs) where they give at least BIG_MIN_BLOCKS blocks
// (counting the cluster's), else [64, 64] tiles of 4 warps. Where K is
// split BM is 48 (each block then runs few chunks, and more, smaller blocks
// kept the card busier on the split (5632, 2048) at T = 240). Where it is
// not, BM is 80 if that leaves fewer rows on the busiest SM than 64 and
// still gives every SM two blocks or more (the int8 LM head at T = 141,
// the int4 gate/up at T = 240), else 64 (with one block an SM the 80-row
// tile was slower: the int8 gate/up at T = 240). A ring stage holds one
// chunk of the larger tiles' K (64 int8 rows took 8-15% off the int8
// calls at T >= 64 and 32 packed int4 rows stay faster for int4), or 32
// rows for the 16-row tiles. These four knobs and SPLIT_N above are
// compile-time so that scripts/torch_matmul_tile_sweep.py can build and
// time other values; the defaults are what the package runs.
#ifndef QM_MMA_SMALL_STAGES
#define QM_MMA_SMALL_STAGES 8
#endif
#ifndef QM_MMA_BIG_BM
#define QM_MMA_BIG_BM 0         // 0: 64 or 80 as above; else that many rows
#endif
#ifndef QM_MMA_BIG_MIN_BLOCKS
#define QM_MMA_BIG_MIN_BLOCKS 96
#endif
#ifndef QM_MMA_STAGES
#define QM_MMA_STAGES 4         // ring stages, larger tiles (B5: one fewer, for its buffers)
#endif

template <bool PIPE, int DEC, int KS>
cudaError_t launch_mma_ks(const void* x, const void* w, const void* scale, void* out,
                          const Problem& p, bool x_vec, int sms, cudaStream_t stream) {
  constexpr int NP = planes_of<DEC>();
  constexpr int SS = QM_MMA_SMALL_STAGES, SB = 32, B = NP == 1 ? 64 : 32;
  constexpr int S = PIPE ? (QM_MMA_STAGES > 3 ? QM_MMA_STAGES - 1 : 3) : QM_MMA_STAGES;
  using Big = MmaGeo<KS == 1 ? (QM_MMA_BIG_BM == 0 ? 64 : QM_MMA_BIG_BM) : 48, 128, 1, 4, B, S, NP>;
  using Big80 = MmaGeo<80, 128, 1, 4, B, S, NP>;
  using Med = MmaGeo<64, 64, 2, 2, B, S, NP>;
  auto blocks = [&](int bm, int bn) { return (p.t + bm - 1) / bm * ((p.n + bn - 1) / bn) * KS; };
  if (p.t <= 16 || blocks(Med::BM, Med::BN) < sms / 2) {
    // the widest 16-row tile that still gives nearly every SM a block
    auto fills = [&](int bn) { return blocks(16, bn) >= sms - sms / 8; };
    if (fills(128))
      return launch_mma_tile<MmaGeo<16, 128, 1, 4, SB, SS, NP>, PIPE, DEC, KS>(x, w, scale, out, p,
                                                                               x_vec, stream);
    if (fills(64))
      return launch_mma_tile<MmaGeo<16, 64, 1, 2, SB, SS, NP>, PIPE, DEC, KS>(x, w, scale, out, p,
                                                                              x_vec, stream);
    if (fills(32))
      return launch_mma_tile<MmaGeo<16, 32, 1, 1, SB, SS, NP>, PIPE, DEC, KS>(x, w, scale, out, p,
                                                                              x_vec, stream);
    return launch_mma_tile<MmaGeo<16, 16, 1, 1, SB, SS, NP>, PIPE, DEC, KS>(x, w, scale, out, p,
                                                                            x_vec, stream);
  }
  if (blocks(Big::BM, Big::BN) >= QM_MMA_BIG_MIN_BLOCKS) {
    // rows on the busiest SM
    auto load = [&](int bm) { return (blocks(bm, 128) + sms - 1) / sms * bm; };
    if (QM_MMA_BIG_BM == 0 && KS == 1 && load(80) < load(64) && blocks(80, 128) >= 2 * sms)
      return launch_mma_tile<Big80, PIPE, DEC, KS>(x, w, scale, out, p, x_vec, stream);
    return launch_mma_tile<Big, PIPE, DEC, KS>(x, w, scale, out, p, x_vec, stream);
  }
  return launch_mma_tile<Med, PIPE, DEC, KS>(x, w, scale, out, p, x_vec, stream);
}

// The product on the tensor cores: int4 (DEC_MAGIC or DEC_SHIFT, pipelined
// or not) or int8 (DEC_INT8).
template <bool PIPE, int DEC>
cudaError_t launch_mma(const void* x, const void* w, const void* scale, void* out,
                       const Problem& p, cudaStream_t stream) {
  static_assert(!PIPE || DEC != DEC_INT8, "the pipelined kernel is int4's");
  // the fill keeps 32-bit element offsets into x
  if ((long long)p.t * p.k >= (1LL << 31)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorMisalignedAddress;
  const bool x_vec = p.k_lim % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  int sms = 0;  // the 16-row tiles fill this card's SMs
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  switch (ks_for(p.k_lim, planes_of<DEC>(), p.n)) {
    case 4: return launch_mma_ks<PIPE, DEC, 4>(x, w, scale, out, p, x_vec, sms, stream);
    default: return launch_mma_ks<PIPE, DEC, 1>(x, w, scale, out, p, x_vec, sms, stream);
  }
}

}  // namespace
